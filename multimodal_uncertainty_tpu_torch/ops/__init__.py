"""Ops of the PyTorch port: attention (CUDA kernels + plain versions), norms,
losses, metrics and MIMO data forming."""
