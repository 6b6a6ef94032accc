"""Training of the PyTorch port: optimizer, steps, trainer, callbacks,
history and checkpoint I/O."""
