"""tracking (PyTorch port)."""
