"""io (PyTorch port)."""
