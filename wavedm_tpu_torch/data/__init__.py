"""Data sources of the PyTorch port (numpy only)."""
