"""Data-parallel building blocks of the PyTorch port (single device so far)."""
