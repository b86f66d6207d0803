"""The arithmetic every reference matmul-like op goes through.

``Prec("float32")`` is the reference itself: float32 operands, float32
accumulation, TF32 switched off by :func:`float32_matmuls`.  The two
controls put the reference in the program's place one precision below the
configuration's:

- ``Prec("tf32")`` (below float32): float32 code with TF32 allowed in
  cuBLAS and cuDNN (:func:`float32_matmuls` with ``tf32=True``);
- ``Prec("fp8")`` (below bfloat16): each operand of a convolution, linear
  layer or attention matmul rounded to float8 e4m3 with a per-tensor scale
  (its absolute maximum mapped to 448, e4m3's largest value), then
  multiplied in float32, as an fp8 GEMM with a float32 accumulator does.
  The rounding passes the gradient straight through, so a training step
  runs its backward on the rounded operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["Prec", "float32_matmuls"]

E4M3_MAX = 448.0


def float32_matmuls(tf32: bool = False) -> None:
    """TF32 off (the reference) or on (the float32 control) in cuBLAS and
    cuDNN, for this process."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach()) if x.requires_grad else q


class Prec:
    """The arithmetic of one reference run: ``float32``, ``tf32`` or
    ``fp8`` (see the module doc)."""

    KINDS = ("float32", "tf32", "fp8")

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"precision must be one of {self.KINDS}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.kind == "fp8" else x

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding, 1, groups)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))
