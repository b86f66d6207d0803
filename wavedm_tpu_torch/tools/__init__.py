"""The quality-loop tools of the PyTorch port: the counterparts of the
JAX package's ``tools/`` diagnostics and its ``scripts/`` sweep and
rehearsal drivers, each a module with ``main(argv=None) -> int``
(``python -m wavedm_tpu_torch.tools.<name>``)."""
