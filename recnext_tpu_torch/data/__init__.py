"""Host-side data handling: the data sets, samplers, train and eval transforms, the
native decoder's binding, the loaders (PIL or native, in worker processes) and
mixup/cutmix."""
