"""Small utilities of the PyTorch port."""
