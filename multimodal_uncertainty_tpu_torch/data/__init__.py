"""Data loading of the PyTorch port (numpy only)."""
