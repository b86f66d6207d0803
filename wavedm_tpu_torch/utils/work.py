"""The work a call does: the port's counterpart of XLA's compiled cost
analysis (``jax.jit(f).lower(...).compile().cost_analysis()``, which the
JAX package's bench and tools read).

:func:`count_work` runs a function once under a ``TorchDispatchMode`` and
returns a :class:`Work`:

- ``flops``: dense, by torch's own formulas (``torch.utils.flop_counter``:
  convolutions and their backward, mm/addmm/bmm, attention); every other op
  counts 0.  On a route without the port's kernels this is
  ``FlopCounterMode``'s total.  MFU divides this.
- ``xla_flops``: XLA's convention.  A convolution counts only the taps
  that land on real pixels, not on its padding, forward and backward (a
  closed form per spatial axis); a matmul counts as in ``flops``; and the
  elementwise work counts as XLA counts it: 1 an output element for
  arithmetic and comparisons, a reduction its input elements, 0 for
  transcendental functions (exp, rsqrt, sigmoid, ...; XLA counts those
  apart), and 0 for casts, copies, layout and random draws (XLA counts a
  cast as 1 an element; here which casts run is a route's choice, since a
  kernel casts in registers).  GroupNorm and swish count what the port's
  plain GroupNorm (``ops/groupnorm_cuda.group_norm_plain``) dispatches,
  their gradients what XLA counts for JAX's (see ``_RULES``).  The
  tools print it so that the port's numbers compare with the JAX rounds'.
- ``bytes``: each dispatched op's input and output tensor bytes.  Views,
  metadata ops and bare allocations (``empty``) count nothing.  An unfused
  count: larger than XLA's "bytes accessed", which counts a fusion's
  operands once.

The port's kernels are ctypes launches that no dispatch mode sees.  Each
wrapper (``ops/wavelet_cuda.py``, ``ops/groupnorm_cuda.py``,
``ops/fused_resblock.py``), where it counts a launch, calls :func:`record`
with the launch's declared work, a pure function of its shapes and dtypes
that equals the count of its plain version; bytes are what the kernel reads
and writes.  A unit of work whose implementation runs other ops than the
plain route's (the fused kernel's backward recomputes its forward through
a composition) runs them under :func:`declared`: their bytes count, their
flops go to ``hidden_flops`` instead, and the unit's declared work is
counted once.  So ``flops`` and ``xla_flops`` are the same under every
kernel route, on the CPU or the card; ``bytes`` follows the route.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import conv_flop_count, flop_registry

__all__ = ["Work", "WorkCounter", "count_work", "record", "declared",
           "active", "conv_valid_taps", "conv_work", "conv_flop_count",
           "group_norm_xla_flops",
           "group_norm_backward_xla_flops", "SILU_BACKWARD_XLA"]

aten = torch.ops.aten


@dataclasses.dataclass
class Work:
    """What one call did.  ``by_op``: op (or declared unit) name ->
    {"calls", "flops", "xla_flops", "bytes"}; ``hidden_flops``: the dense
    flops run inside declared units (a recompute) and counted as their
    unit's declared work instead; ``unruled``: ops that counted 0 in
    ``xla_flops`` for want of a rule (none on the port's paths)."""
    flops: float = 0.0
    xla_flops: float = 0.0
    bytes: float = 0.0
    hidden_flops: float = 0.0
    by_op: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    unruled: List[str] = dataclasses.field(default_factory=list)

    def add(self, name: str, flops: float, xla_flops: float,
            nbytes: float) -> None:
        self.flops += flops
        self.xla_flops += xla_flops
        self.bytes += nbytes
        row = self.by_op.setdefault(name, dict(calls=0, flops=0.0,
                                               xla_flops=0.0, bytes=0.0))
        row["calls"] += 1
        row["flops"] += flops
        row["xla_flops"] += xla_flops
        row["bytes"] += nbytes


# ---------------------------------------------------------------- formulas


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _pairs(n: int, k: int, stride: int, pad: int, dilation: int) -> int:
    """(output position, tap) pairs of one spatial axis whose input index
    lies in [0, n): a conv's taps that land on real pixels."""
    out = (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    total = 0
    for tap in range(k):
        shift = pad - tap * dilation           # input = o * stride - shift
        lo = max(0, -(-shift // stride))
        hi = min(out - 1, (n - 1 + shift) // stride)
        total += max(0, hi - lo + 1)
    return total


def _at(seq: Sequence[int], i: int) -> int:
    return seq[i] if len(seq) > 1 else seq[0]


def conv_valid_taps(x_shape: Sequence[int], w_shape: Sequence[int],
                    stride: Sequence[int], padding: Sequence[int],
                    dilation: Sequence[int], transposed: bool = False,
                    out_shape: Optional[Sequence[int]] = None) -> int:
    """Multiply-adds of a convolution whose both operands are real: each
    output channel's taps over the input channels of its group, at every
    (output position, tap) pair that lands inside the input, per spatial
    axis in closed form (``groups`` is in ``w_shape[1]``).  A transposed
    conv is the adjoint of the forward conv from its output back to its
    input, and counts that conv's pairs."""
    geo = (out_shape if transposed else x_shape)[2:]
    pairs = 1
    for i, n in enumerate(geo):
        pairs *= _pairs(int(n), int(w_shape[2 + i]), _at(stride, i),
                        _at(padding, i), _at(dilation, i))
    cout = w_shape[1] if transposed else w_shape[0]
    cin_group = w_shape[0] if transposed else w_shape[1]
    return int(x_shape[0]) * int(cout) * int(cin_group) * pairs


def conv_work(x_shape: Sequence[int], w_shape: Sequence[int],
              out_shape: Sequence[int], stride=(1,), padding=(0,),
              dilation=(1,), bias: bool = False) -> tuple:
    """(flops, xla_flops) of a forward convolution: torch's dense formula,
    and 2 a valid tap plus the bias add (1 an output element)."""
    dense = conv_flop_count(list(x_shape), list(w_shape), list(out_shape))
    valid = 2 * conv_valid_taps(x_shape, w_shape, stride, padding, dilation)
    return dense, valid + (_prod(out_shape) if bias else 0)


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def group_norm_xla_flops(numel: int, n: int, c: int, groups: int,
                         swish: bool) -> int:
    """What ``group_norm_plain`` dispatches, in XLA's convention: the two
    means (an element each), x*x, the folded affine x*a + b (2 an element);
    per (n, group) mean*mean, var - that, its clamp at 0 (flax's maximum),
    + eps; per (n, channel) the scale and shift (3); swish's multiply (1
    an element; its sigmoid is transcendental)."""
    return (5 + int(swish)) * numel + 4 * n * groups + 3 * n * c


def group_norm_backward_xla_flops(numel: int, grad_input: bool,
                                  grad_affine: bool) -> int:
    """GroupNorm's gradient as XLA counts JAX's (``flax.linen.GroupNorm``
    under ``jax.grad`` on the CPU, measured at the UNet's shapes: 10 an
    element for the input's gradient, 1 more for the scale's and shift's)."""
    return (10 * int(grad_input) + int(grad_affine)) * numel


SILU_BACKWARD_XLA = 5   # sigma * (1 + x * (1 - sigma)) * g, a element


def _softmax(args, out) -> int:
    # max (in - out), x - max, exp (transcendental), sum (in - out), / sum
    rows = _numel(out) // max(1, out.shape[args[1]]) if out.dim() else 1
    return 4 * _numel(out) - 2 * rows


def _group_norm(args, out) -> int:
    x, _, _, n, c, _, groups = args[:7]
    return group_norm_xla_flops(_numel(x), int(n), int(c), int(groups), False)


def _group_norm_backward(args, out) -> int:
    mask = args[-1]
    return group_norm_backward_xla_flops(_numel(args[1]), bool(mask[0]),
                                         bool(mask[1] or mask[2]))


def _sum_out(out) -> int:
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    return sum(t.numel() for t in outs)


def _list_numel(arg) -> int:
    return sum(t.numel() for t in arg) if isinstance(arg, (list, tuple)) \
        else _numel(arg)


def _pow(args, out) -> int:
    # a square (or an integer power) is a multiply in XLA; a tensor or
    # fractional power is transcendental
    exp = args[1] if len(args) > 1 else None
    if isinstance(exp, (int, float)) and float(exp).is_integer():
        return _sum_out(out)
    return 0


# XLA-convention flops of each elementwise or reduction op with a rule,
# keyed by the op's name without a trailing "_" (in place) or "_foreach_"
# prefix.  Ops on no list count 0 and are reported in ``Work.unruled``,
# unless they are on ``_ZERO``.
_ONE = ("add sub rsub mul div neg abs maximum minimum clamp clamp_min "
        "clamp_max where gt lt ge le eq ne reciprocal sign floor ceil round "
        "trunc remainder fmod relu masked_fill logical_and logical_or "
        "logical_not logical_xor bitwise_and bitwise_or bitwise_not "
        "hardtanh copysign sgn silu threshold_backward").split()
_TWO = ("addcmul addcdiv leaky_relu").split()
_ZERO = set((
    "exp exp2 expm1 log log1p log2 log10 sqrt rsqrt sin cos tan tanh sigmoid "
    "erf erfinv atan atan2 asin acos sinh cosh "
    # casts, copies, layout, indexing, allocation, random draws
    "_to_copy copy clone contiguous cat stack constant_pad_nd index "
    "index_select gather repeat repeat_interleave flip roll pixel_shuffle "
    "pixel_unshuffle fill zero zeros zeros_like ones ones_like full "
    "full_like new_zeros new_ones new_full arange scalar_tensor randn "
    "randn_like rand rand_like randint normal uniform bernoulli randperm "
    "_local_scalar_dense embedding upsample_nearest2d slice_scatter "
    "select_scatter narrow_copy _unsafe_index index_put_impl index_put "
    "masked_select nonzero "
    "bitwise_left_shift bitwise_right_shift sort topk argsort").split())
_RULES: Dict[str, Callable] = {
    **{name: (lambda a, o: _sum_out(o)) for name in _ONE},
    **{name: (lambda a, o: 2 * _sum_out(o)) for name in _TWO},
    "lerp": lambda a, o: 3 * _sum_out(o),
    "pow": _pow,
    "square": lambda a, o: _sum_out(o),
    "sum": lambda a, o: _numel(a[0]) - _sum_out(o),
    "amax": lambda a, o: _numel(a[0]) - _sum_out(o),
    "amin": lambda a, o: _numel(a[0]) - _sum_out(o),
    "prod": lambda a, o: _numel(a[0]) - _sum_out(o),
    "any": lambda a, o: _numel(a[0]) - _sum_out(o),
    "all": lambda a, o: _numel(a[0]) - _sum_out(o),
    "max": lambda a, o: _numel(a[0]) - _numel(tree_flatten(o)[0][0]),
    "min": lambda a, o: _numel(a[0]) - _numel(tree_flatten(o)[0][0]),
    "argmax": lambda a, o: _numel(a[0]) - _sum_out(o),
    "argmin": lambda a, o: _numel(a[0]) - _sum_out(o),
    "mean": lambda a, o: _numel(a[0]),
    "var": lambda a, o: 4 * _numel(a[0]),
    "std": lambda a, o: 4 * _numel(a[0]),
    "var_mean": lambda a, o: 4 * _numel(a[0]),
    "linalg_vector_norm": lambda a, o: 2 * _numel(a[0]) - _sum_out(o),
    "norm": lambda a, o: 2 * _numel(a[0]) - _sum_out(o),
    "avg_pool2d": lambda a, o: _numel(a[0]),
    "adaptive_avg_pool2d": lambda a, o: _numel(a[0]),
    "_adaptive_avg_pool2d": lambda a, o: _numel(a[0]),
    "upsample_nearest2d_backward": lambda a, o: _numel(a[0]) - _sum_out(o),
    "avg_pool2d_backward": lambda a, o: _numel(a[0]),
    "_adaptive_avg_pool2d_backward": lambda a, o: _numel(a[0]),
    "_softmax": _softmax,
    "_log_softmax": _softmax,
    "_softmax_backward_data": lambda a, o: 4 * _numel(o),
    "_log_softmax_backward_data": lambda a, o: 3 * _numel(o),
    "sigmoid_backward": lambda a, o: 3 * _numel(o),
    "tanh_backward": lambda a, o: 3 * _numel(o),
    "silu_backward": lambda a, o: SILU_BACKWARD_XLA * _numel(o),
    "native_group_norm": _group_norm,
    "native_group_norm_backward": _group_norm_backward,
    "index_add": lambda a, o: _numel(a[3]),
    "scatter_add": lambda a, o: _numel(a[3]),
    "mse_loss": lambda a, o: 3 * _numel(a[0]),
    "cumprod": lambda a, o: _numel(o),
    "cumsum": lambda a, o: _numel(o),
}
# the foreach forms count over every tensor of their first list
_FOREACH_ONE = {"add", "sub", "mul", "div", "neg", "abs", "maximum",
                "minimum", "clamp_min", "clamp_max", "reciprocal", "sign"}
_FOREACH_TWO = {"addcmul", "addcdiv"}
_FOREACH_ZERO = {"sqrt", "exp", "log", "copy", "zero", "sigmoid", "tanh",
                 "rsqrt"}

# metadata queries FlopCounterMode passes on untouched
_METADATA = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default}
# ops that move no data: allocations without a fill, aliases
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
             "detach", "_local_scalar_dense", "set", "resize",
             "_resize_output", "record_stream", "_record_function_enter_new",
             "_record_function_exit"}


def _dense_bytes(t: torch.Tensor) -> int:
    """A tensor's distinct elements (an expanded, stride-0 dimension read
    once) times its element size."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensor_bytes(tree) -> int:
    return sum(_dense_bytes(t) for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _conv_xla(packet, args, out) -> float:
    if packet is aten.convolution_backward:
        go, x, w = args[0], args[1], args[2]
        stride, padding, dilation, transposed = args[4:8]
        mask = args[10]
        valid = conv_valid_taps(x.shape, w.shape, stride, padding, dilation,
                                transposed, go.shape)
        bias = _numel(go) - go.shape[1] if mask[2] else 0
        return 2 * valid * (int(mask[0]) + int(mask[1])) + bias
    x, w, b = args[0], args[1], args[2]
    stride, padding, dilation, transposed = args[3:7]
    valid = conv_valid_taps(x.shape, w.shape, stride, padding, dilation,
                            transposed, out.shape)
    return 2 * valid + (_numel(out) if b is not None else 0)


_CONVS = {aten.convolution, aten._convolution, aten.convolution_backward,
          aten.cudnn_convolution, aten.convolution_overrideable}


def _xla_of(packet, args, out, dense: float, work: Work) -> float:
    if packet in _CONVS:
        return _conv_xla(packet, args, out)
    if packet in flop_registry:
        return dense
    raw = packet.__name__
    if raw.startswith("_foreach_"):
        name = raw[len("_foreach_"):].rstrip("_")
        elems = _list_numel(args[0])
        if name in _FOREACH_ONE:
            return elems
        if name in _FOREACH_TWO:
            return 2 * elems
        if name == "lerp":
            return 3 * elems
        if name == "norm":
            return 2 * elems - len(args[0])
        if name in _FOREACH_ZERO:
            return 0
    else:
        name = raw[:-1] if raw.endswith("_") and not raw.endswith("__") \
            else raw
        rule = _RULES.get(name)
        if rule is not None:
            return rule(args, out)
        if name in _ZERO:
            return 0
    if raw not in work.unruled:
        work.unruled.append(raw)
    return 0


# ---------------------------------------------------------------- counting

_active: List["WorkCounter"] = []   # process-wide: backward runs elsewhere
_hidden = [0]                       # depth of declared units entered


def active() -> bool:
    """Whether a counter is counting (the wrappers' cheap test)."""
    return bool(_active)


def record(name: str, flops: float, xla_flops: float, nbytes: float) -> None:
    """Add one kernel launch's declared work to the active counters."""
    for counter in _active:
        counter.work.add(name, flops, xla_flops, nbytes)


@contextlib.contextmanager
def declared(name: str, flops: float, xla_flops: float) -> Iterator[None]:
    """A unit of work counted as declared: the ops run inside add their
    bytes, but their flops go to ``hidden_flops``."""
    record("unit:" + name, flops, xla_flops, 0.0)
    _hidden[0] += 1
    try:
        yield
    finally:
        _hidden[0] -= 1


class WorkCounter(TorchDispatchMode):
    """Counts every dispatched op into ``work`` (see the module doc).  Ops
    without a flop formula are decomposed first where they can be, as
    ``FlopCounterMode`` does, so that ``flops`` agrees with it."""

    def __init__(self) -> None:
        super().__init__()
        self.work = Work()

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if (func not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        dense = xla = nbytes = 0.0
        if packet in flop_registry:
            dense = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        if not (func.is_view or name in _NO_BYTES):
            nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
            xla = float(_xla_of(packet, list(args) + list(kwargs.values()),
                                out, dense, self.work))
        if _hidden[0]:
            self.work.hidden_flops += dense
            dense = xla = 0.0
        self.work.add(name, dense, xla, nbytes)
        return out


def count_work(fn: Callable, *args, **kwargs) -> Work:
    """Run ``fn(*args, **kwargs)`` once and return the :class:`Work` it
    did (its result is dropped)."""
    with WorkCounter() as counter:
        fn(*args, **kwargs)
    return counter.work
