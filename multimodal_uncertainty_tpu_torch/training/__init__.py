"""Training-side utilities of the PyTorch port (checkpoint I/O so far)."""
