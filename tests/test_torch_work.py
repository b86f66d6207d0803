"""PyTorch port: the work counter (``wavedm_tpu_torch/utils/work.py``), the
port's counterpart of XLA's compiled cost analysis.

- ``flops`` is torch's ``FlopCounterMode`` total on a route without the
  port's kernels (exactly).
- ``xla_flops`` against XLA's own count of the JAX package's program
  (``jax.jit(f).lower(...).compile().cost_analysis()``, as
  ``tools/roofline.py`` takes it): the full-width UNet forward within
  0.5%, the full-width HFRM forward and the train step at the
  ``rehearsal_wavelet.yaml`` widths within 1%.  The port's side of the two
  forwards is counted on the meta device (shapes only; the same count as
  on the CPU, checked at a small width).
- Each kernel's declared work equals the counter's count of its plain
  version at three shapes or more, and is what the wrapper records on the
  card's route (emulated here: the launch is a no-op, the tensors a
  subclass the wrappers route as a card's).
- ``flops`` and ``xla_flops`` are the same under every kernel route, for
  a UNet forward and a train step; a conv's bytes are counted by hand.

Torch runs on one thread here (``one_torch_thread``).
"""

import collections
import functools
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from wavedm_tpu.config import load_config as jax_load_config
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet

from wavedm_tpu_torch.config import PROFILES, reference_profile
from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
from wavedm_tpu_torch.models.hfrm import HFRM
from wavedm_tpu_torch.models.layers import Normalize
from wavedm_tpu_torch.models.unet import DiffusionUNet
from wavedm_tpu_torch.ops import (_build, fused_resblock, groupnorm_cuda,
                                  wavelet_cuda)
from wavedm_tpu_torch.training.state import create_train_state
from wavedm_tpu_torch.training.train_step import make_train_step
from wavedm_tpu_torch.utils import work
from wavedm_tpu_torch.utils.work import conv_valid_taps, count_work


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread here: the suite runs several pytest-xdist
    workers on a few cores, where these small ops on a thread per core in
    every worker run ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_config(name):
    return jax_load_config(os.path.join(REPO, "wavedm_tpu", "configs",
                                        name + ".yaml"))


def _xla_flops(fn, *args):
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


def _small(cfg):
    cfg.model.ch, cfg.model.ch_mult = 32, (1, 2)
    cfg.model.num_res_blocks, cfg.model.attn_resolutions = 1, (8,)
    cfg.data.image_size, cfg.data.patch_size = 16, 64
    cfg.hfrm.dim, cfg.hfrm.middle_blk_num = 8, 1
    cfg.hfrm.enc_blk_nums = cfg.hfrm.dec_blk_nums = (1, 1)
    cfg.training.batch_size, cfg.training.patch_n = 1, 2
    return cfg


def _train_step(cfg, crops=2):
    model = build_unet(cfg, None, "cpu", train=True)
    hfrm = None if cfg.model.use_gt_in_train else build_hfrm(cfg, None,
                                                             "cpu")
    state = create_train_state(model, cfg.optim, 0)
    step = make_train_step(cfg, model, hfrm)
    p = cfg.data.patch_size
    batch = np.random.default_rng(61).random((crops, p, p, 6),
                                             dtype=np.float32)
    return step, state, batch


# ------------------------------------------------------------ conventions


@pytest.mark.parametrize("case", ["unet_forward", "train_step"])
def test_flops_equal_flop_counter_mode(case):
    cfg = _small(PROFILES["production"]())
    cfg.parallel.compute_dtype = "float32"
    if case == "unet_forward":
        model = build_unet(cfg, None, "cpu")
        args = (torch.randn(2, 96, 16, 16), torch.zeros(2))
        with torch.no_grad():
            w = count_work(model, *args)
            with FlopCounterMode(display=False) as fc:
                model(*args)
    else:
        step, state, batch = _train_step(cfg)
        w = count_work(step, state, batch)
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
    assert w.flops == fc.get_total_flops() > 0
    assert w.unruled == []


@pytest.mark.parametrize("n,k,stride,pad,dil", [
    (7, 3, 1, 1, 1), (8, 3, 2, 0, 1), (9, 3, 2, 1, 1), (5, 1, 1, 0, 1),
    (10, 3, 1, 2, 2), (4, 5, 1, 2, 1), (6, 2, 2, 0, 1)])
def test_conv_valid_taps_counts_taps_on_real_pixels(n, k, stride, pad, dil):
    """The closed form against enumerating every (output, tap) pair, and a
    transposed conv as the adjoint of the forward one."""
    out = (n + 2 * pad - dil * (k - 1) - 1) // stride + 1
    pairs = sum(0 <= o * stride - pad + t * dil < n
                for o, t in itertools.product(range(out), range(k)))
    x, w = (2, 4, n, n + 1), (6, 4, k, k)
    n2 = n + 1
    out2 = (n2 + 2 * pad - dil * (k - 1) - 1) // stride + 1
    pairs2 = sum(0 <= o * stride - pad + t * dil < n2
                 for o, t in itertools.product(range(out2), range(k)))
    want = 2 * 6 * 4 * pairs * pairs2
    assert conv_valid_taps(x, w, (stride,), (pad,), (dil,)) == want
    # the transposed conv from (2, 6, out, out2) back to x's geometry
    assert conv_valid_taps((2, 6, out, out2), (6, 4, k, k), (stride,),
                           (pad,), (dil,), transposed=True,
                           out_shape=x) == want


def test_conv_bytes_and_flops_by_hand():
    x = torch.randn(2, 8, 10, 12)
    w = torch.randn(16, 8, 3, 3)
    b = torch.randn(16)
    r = count_work(torch.nn.functional.conv2d, x, w, b, padding=1)
    out = 2 * 16 * 10 * 12
    assert r.bytes == 4 * (x.numel() + w.numel() + b.numel() + out)
    assert r.flops == 2 * 2 * 16 * 10 * 12 * 8 * 9
    # taps on real pixels: 3 * n - 2 of the 3 * n pairs an axis
    assert r.xla_flops == 2 * 2 * 16 * 8 * (3 * 10 - 2) * (3 * 12 - 2) \
        + 2 * 16 * 10 * 12


def test_meta_device_counts_as_the_cpu():
    cfg = _small(reference_profile())
    model = build_unet(cfg, None, "cpu")
    x, t = torch.randn(3, 96, 16, 16), torch.zeros(3)
    with torch.no_grad():
        cpu = count_work(model, x, t)
    with torch.device("meta"):
        meta_model = DiffusionUNet.from_config(cfg)
    meta = count_work(meta_model, x.to("meta"), t.to("meta"))
    assert (meta.flops, meta.xla_flops, meta.bytes) == (
        cpu.flops, cpu.xla_flops, cpu.bytes)


# ------------------------------------------------------ against XLA's count


def test_xla_flops_of_the_full_width_unet_forward_within_half_a_percent():
    cfg = _jax_config("raindrop_wavelet")
    model = JaxUNet.from_config(cfg)
    x, t = jnp.zeros((1, 64, 64, 96)), jnp.zeros((1,))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t)
    want = _xla_flops(lambda p, x, t: model.apply(p, x, t), params, x, t)
    with torch.device("meta"):
        unet = DiffusionUNet.from_config(reference_profile())
        w = count_work(unet, torch.empty(1, 96, 64, 64), torch.empty(1))
    assert abs(w.xla_flops / want - 1) <= 5e-3, (w.xla_flops, want)
    # the dense count is torch's: XLA leaves out the taps on SAME padding
    assert w.flops > 1.05 * want
    assert w.unruled == []


def test_xla_flops_of_the_full_width_hfrm_forward_within_one_percent():
    cfg = _jax_config("raindrop_wavelet")
    model = JaxHFRM.from_config(cfg)
    x = jnp.zeros((1, 64, 96, 3))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    want = _xla_flops(lambda p, x: model.apply(p, x), params, x)
    with torch.device("meta"):
        hfrm = HFRM.from_config(reference_profile())
        w = count_work(hfrm, torch.empty(1, 3, 64, 96))
    assert abs(w.xla_flops / want - 1) <= 1e-2, (w.xla_flops, want)
    assert w.unruled == []


def test_xla_flops_of_the_rehearsal_train_step_within_one_percent():
    from wavedm_tpu.training.state import create_train_state as jax_state
    from wavedm_tpu.training.train_step import make_train_step as jax_step

    crops = 2
    cfg = _jax_config("rehearsal_wavelet")
    cfg.training.batch_size, cfg.training.patch_n = 1, crops
    key = jax.random.PRNGKey(0)
    unet, hfrm = JaxUNet.from_config(cfg), JaxHFRM.from_config(cfg)
    p = cfg.data.patch_size
    zeros = lambda tree: jax.tree.map(                      # noqa: E731
        lambda s: jnp.zeros(s.shape, s.dtype), tree)
    uparams = zeros(jax.eval_shape(unet.init, key,
                                   jnp.zeros((1, p // 4, p // 4, 96)),
                                   jnp.zeros((1,)))["params"])
    hparams = zeros(jax.eval_shape(hfrm.init, key,
                                   jnp.zeros((1, p, p, 3)))["params"])
    step = jax_step(cfg, unet.apply, donate=False,
                    hfrm_fn=lambda x: hfrm.apply({"params": hparams}, x))
    ca = step.lower(jax_state(uparams, cfg.optim, key),
                    jnp.zeros((crops, p, p, 6))).compile().cost_analysis()
    want = float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])

    tcfg = PROFILES["rehearsal"]()
    tcfg.training.batch_size, tcfg.training.patch_n = 1, crops
    w = count_work(*_train_step(tcfg, crops))
    assert abs(w.xla_flops / want - 1) <= 1e-2, (w.xla_flops, want)
    assert w.unruled == []


# ------------------------------------------------------- declared work


GN_SHAPES = [(2, 64, 8, 8), (3, 128, 4, 6), (1, 96, 5, 7)]


@pytest.mark.parametrize("shape", GN_SHAPES)
@pytest.mark.parametrize("swish", [False, True])
def test_group_norm_declares_its_plain_versions_count(shape, swish):
    n, c, h, w = shape
    x = torch.randn(shape)
    r = count_work(groupnorm_cuda.group_norm_plain, x, torch.randn(c),
                   torch.randn(c), 32, 1e-6, swish)
    flops, xla, nbytes = groupnorm_cuda.declared_work(n, c, h * w, 32, swish,
                                                      x.dtype)
    assert (r.flops, r.xla_flops) == (flops, xla) and xla > 0
    assert nbytes == 2 * x.numel() * 4 + 2 * 4 * c


FUSED_SHAPES = [((2, 64, 8, 8), 96), ((3, 128, 4, 6), 128),
                ((1, 32, 5, 7), 64)]


@pytest.mark.parametrize("shape,cout", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv_declares_its_plain_versions_count(shape, cout, dtype):
    cin = shape[1]
    x = torch.randn(shape).to(dtype)
    r = count_work(fused_resblock.fused_gn_swish_conv_plain, x,
                   torch.randn(cin), torch.randn(cin),
                   torch.randn(cout, cin, 3, 3), torch.randn(cout), dtype)
    flops, xla, _ = fused_resblock.declared_work(shape, cout, dtype, dtype)
    assert (r.flops, r.xla_flops) == (flops, xla)
    assert flops == 2 * shape[0] * shape[2] * shape[3] * 9 * cin * cout


@pytest.mark.parametrize("shape", [(1, 3, 8, 12), (2, 3, 16, 16),
                                   (3, 6, 4, 8)])
def test_wavelets_declare_their_plain_versions_count(shape):
    x = torch.randn(shape)
    z = wavelet_cuda.wavelet_dec_plain(x)
    want = wavelet_cuda.declared_work(x.numel())
    assert want[:2] == (32 * x.numel(),) * 2
    for fn, arg in ((wavelet_cuda.wavelet_dec_plain, x),
                    (wavelet_cuda.wavelet_rec_plain, z)):
        r = count_work(fn, arg)
        assert (r.flops, r.xla_flops) == want[:2]


class OnCard(torch.Tensor):
    """A host tensor the wrappers route as a card's."""

    @property
    def is_cpu(self):
        return False

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def no_launch(monkeypatch):
    """The kernels' library replaced by no-op launches; allocations that
    name the card made on the host."""
    empty = torch.empty

    def host_empty(*args, device=None, **kw):
        return empty(*args, **kw)

    monkeypatch.setattr(_build, "library", lambda: object())
    monkeypatch.setattr(_build, "launch", lambda *a: None)
    monkeypatch.setattr(fused_resblock, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch, "empty", host_empty)
    for counts in (groupnorm_cuda.launches, wavelet_cuda.launches,
                   fused_resblock.launches):
        for key in counts:
            monkeypatch.setitem(counts, key, 0)


@pytest.mark.parametrize("kernel", ["group_norm", "group_norm_round_affine",
                                    "fused", "wavelet_dec", "wavelet_rec"])
def test_a_launch_records_its_declared_work(kernel, no_launch):
    """On the card's route each launch records the work its plain version
    counts; the same call on the CPU counts that plain version's ops."""
    card = lambda t: t.as_subclass(OnCard)                  # noqa: E731
    if kernel == "group_norm":
        x, g, b = torch.randn(2, 64, 8, 8), torch.randn(64), torch.randn(64)
        fn, args = groupnorm_cuda.group_norm, (x, g, b, 32, 1e-6, True)
        name = "kernel:group_norm_f32_swish"
    elif kernel == "group_norm_round_affine":
        x = torch.randn(2, 64, 8, 8).to(torch.bfloat16)
        fn = functools.partial(groupnorm_cuda.group_norm, round_affine=True)
        args = (x, torch.randn(64), torch.randn(64), 32, 1e-6, True)
        name = "kernel:group_norm_bf16_plain_swish"
    elif kernel == "fused":
        x = torch.randn(2, 64, 8, 8).to(torch.bfloat16)
        args = (x, torch.randn(64), torch.randn(64),
                torch.randn(96, 64, 3, 3), torch.randn(96), torch.bfloat16)
        fn, name = (fused_resblock.fused_gn_swish_conv,
                    "kernel:fused_gn_swish_conv_bf16")
    elif kernel == "wavelet_dec":
        fn, args = wavelet_cuda.wavelet_dec_cuda, (torch.randn(2, 3, 16, 16),)
        name = "kernel:wavelet_dec"
    else:
        fn, args = wavelet_cuda.wavelet_rec_cuda, (torch.randn(2, 48, 4, 4),)
        name = "kernel:wavelet_rec"
    with torch.no_grad():
        cpu = count_work(fn, *args)
        on_card = count_work(fn, *[card(a) if isinstance(a, torch.Tensor)
                                   else a for a in args])
    assert on_card.by_op[name]["calls"] == 1
    assert (on_card.flops, on_card.xla_flops) == (cpu.flops, cpu.xla_flops)


def test_default_route_takes_the_kernel_on_the_card_outside_autograd(
        no_launch):
    """On the card's route the default route's norms (``Normalize`` with
    fused=False) launch the kernel with the default route's rounding once
    a site outside autograd, and count the forward's work as on the CPU;
    under autograd they run the eager chain and launch nothing; a
    channels-last input is made contiguous and launches the kernel."""
    cfg = _small(reference_profile())
    cfg.parallel.compute_dtype = "bfloat16"
    model = build_unet(cfg, None, "cpu")
    x, t = torch.randn(3, 96, 16, 16), torch.zeros(3)
    with torch.no_grad():
        cpu = count_work(model, x, t)
    norms = [m for m in model.modules() if isinstance(m, Normalize)]
    for m in norms:                 # the norms' parameters on the card too
        m.weight = torch.nn.Parameter(m.weight.detach().as_subclass(OnCard))
        m.bias = torch.nn.Parameter(m.bias.detach().as_subclass(OnCard))
    sites = collections.Counter(m.swish for m in norms)
    with torch.no_grad():
        card = count_work(model, x.as_subclass(OnCard), t)
    assert {k: v for k, v in groupnorm_cuda.launches.items() if v} == {
        "bf16_plain_swish": sites[True], "bf16_plain": sites[False]}
    assert card.by_op["kernel:group_norm_bf16_plain_swish"]["calls"] == \
        sites[True]
    assert (card.flops, card.xla_flops) == (cpu.flops, cpu.xla_flops)

    for key in groupnorm_cuda.launches:
        groupnorm_cuda.launches[key] = 0
    model(x.as_subclass(OnCard), t)            # autograd: the weights
    assert not any(groupnorm_cuda.launches.values())
    with torch.no_grad():
        h = torch.randn(2, 16, 16, norms[0].weight.shape[0])
        norms[0](h.to(torch.bfloat16).permute(0, 3, 1, 2).as_subclass(OnCard))
    assert {k: v for k, v in groupnorm_cuda.launches.items() if v} == {
        "bf16_plain" + ("_swish" if norms[0].swish else ""): 1}


# ------------------------------------------------------------ routes


def test_routes_count_the_same_unet_forward():
    out = {}
    for dtype, route in itertools.product(
            ("float32", "bfloat16"),
            ("plain", "fused_groupnorm", "fused_resblock")):
        cfg = _small(reference_profile())
        cfg.parallel.compute_dtype = dtype
        if route != "plain":
            setattr(cfg.parallel, route, True)
        model = build_unet(cfg, None, "cpu")
        with torch.no_grad():
            w = count_work(model, torch.randn(3, 96, 16, 16), torch.zeros(3))
        out[dtype, route] = (w.flops, w.xla_flops)
    assert len(set(out.values())) == 1, out


def test_routes_count_the_same_train_step():
    """The fused kernel's backward recomputes its forward; that recompute
    is not the model's work (``hidden_flops``), so the step counts as the
    plain route's."""
    out = {}
    for route in ("plain", "fused_resblock"):
        cfg = _small(PROFILES["production"]())
        cfg.parallel.compute_dtype = "float32"
        cfg.parallel.fused_resblock = route == "fused_resblock"
        w = count_work(*_train_step(cfg))
        out[route] = w
        assert w.unruled == []
    plain, fused = out["plain"], out["fused_resblock"]
    assert (plain.flops, plain.xla_flops) == (fused.flops, fused.xla_flops)
    assert plain.hidden_flops == 0 < fused.hidden_flops
    # 16 ResnetBlock pairs: 2 levels down and mid's 2 blocks, 2 x 2 up
    assert fused.by_op["unit:fused_gn_swish_conv_backward"]["calls"] == 16
    assert not work.active()
