"""Process-level helpers of the PyTorch port."""
