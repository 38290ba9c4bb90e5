"""Host-side data helpers of the PyTorch port."""
