"""inference of the PyTorch port."""
