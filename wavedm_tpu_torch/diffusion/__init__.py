"""diffusion of the PyTorch port."""
