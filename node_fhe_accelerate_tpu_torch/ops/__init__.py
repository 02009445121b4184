"""Kernels and integer helpers of the PyTorch port."""
