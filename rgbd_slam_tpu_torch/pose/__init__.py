"""pose (PyTorch port)."""
