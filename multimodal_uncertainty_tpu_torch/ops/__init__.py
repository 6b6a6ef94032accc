"""Ops of the PyTorch port: attention (CUDA kernel + plain version), norms."""
