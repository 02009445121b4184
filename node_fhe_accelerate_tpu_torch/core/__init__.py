"""Core TFHE modules of the PyTorch port."""
