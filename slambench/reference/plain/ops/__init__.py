"""ops (PyTorch port)."""
