"""features (PyTorch port)."""
