"""WaveDM restoration in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package ``wavedm_tpu`` that stays beside it as the
reference.  Tensors are NCHW, modules use the reference PyTorch
``state_dict`` key names, and the two hot ops of the restoration path (the
scale-2 Haar DWT/IWT and GroupNorm(+swish)) run as hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use.

Importing the package imports nothing heavy; entry points live in
``wavedm_tpu_torch.inference``.
"""
