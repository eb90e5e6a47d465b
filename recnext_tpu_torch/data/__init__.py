"""Host-side data handling: the FAKE data set, the train and eval transforms, the
loaders and mixup/cutmix."""
