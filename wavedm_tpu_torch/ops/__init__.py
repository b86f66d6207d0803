"""Ops of the PyTorch port: the Haar wavelet transforms, GroupNorm(+swish)
and GroupNorm -> swish -> conv3x3, each a hand-written CUDA kernel beside
its plain PyTorch version."""
