"""mapping (PyTorch port)."""
