"""Model modules of the PyTorch port."""
