"""Fold x grid search kernels of the PyTorch port (local path)."""
