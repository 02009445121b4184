"""Utilities of the PyTorch port: the adaptive dispatcher."""
