"""geometry (PyTorch port)."""
