"""Training: losses, optimizer and schedule, train state with EMA, the train and
eval steps, and the training CLI (``python -m recnext_tpu_torch.train.main``)."""
