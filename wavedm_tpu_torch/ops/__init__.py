"""Ops of the PyTorch port: the Haar wavelet transforms and GroupNorm(+swish),
each a hand-written CUDA kernel beside its plain PyTorch version."""
