"""Parallel axes of the PyTorch port: data (ZeRO-2) and model (tensor parallel) over process groups."""
