"""A dry run of the port's multi-process paths on a world of ranks.

The port's counterpart of ``__graft_entry__.dryrun_multichip``.
:func:`dryrun_multigpu` starts ``world`` ranks (``parallel/launch.py``) and
each runs JAX's phases at the port's shapes, asserting as it goes:

- ``tiny_train_step``: one train step of a tiny UNet on a global batch of
  2 crops a rank, FSDP2-sharded (every parameter and EMA tensor a dim-0
  DTensor shard afterwards);
- ``sharded_sampler``: the tiny tiled sampler with its 24 patches split
  over the ranks against the same chain run whole on each rank (1e-5);
- ``flagship_fsdp_placement``: the flagship UNet (156,492,675 parameters)
  built on the meta device and FSDP2-sharded: every parameter a dim-0
  shard, the shards summing to the whole;
- with ``full`` (the card): ``flagship_steps``, one production train step
  at flagship width (16 crops of 256x256, ``fused_resblock``) in float32
  and in bfloat16, under DDP and FSDP2, each held to the step of one
  process on the whole global batch, which rank 0 runs unwrapped (twice
  at one rank: the gap between those two runs is printed beside the
  checks); over ranks the bfloat16 step runs under DDP alone and the
  caller holds its loss to world 1's; and ``flagship_restore``, two
  720x480 images restored patch-parallel (90 patches, 1 step) in float32
  and bfloat16 against rank 0's unsharded restore, then ``restore()``
  scoring each rank's stripe of the two pairs.

Each rank returns a report: which collectives the backend took on the
device's tensors (a record: the phases need all of them and raise where
one is refused), per phase its checks, times and the kernel launches of
the runs that went through the parallel paths (the unwrapped and unsharded
references are not counted).

With a ``gate`` (a file path) each rank waits for ``<gate>.build`` before
the tiny phases (their first kernel call would otherwise build the kernel
library beside its caller's build), runs them, writes
``<gate>.ready<rank>`` and waits for the gate file itself before the
flagship phases.  So a caller can start the ranks early (their start-up
beside its build, their tiny phases beside work that measures nothing on
the card) and let the flagship phases run alone later.
"""

from __future__ import annotations

import copy
import os
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from wavedm_tpu_torch.ops import launch_counts, reset_launch_counts
from wavedm_tpu_torch.parallel.distributed import collective_device
from wavedm_tpu_torch.parallel.launch import World

__all__ = ["TINY", "start_dryrun", "dryrun_multigpu", "run_rank"]

# tests/test_multichip.py's tiny_config
TINY = {
    "data": {"image_size": 8, "patch_size": 32, "wavelet": True},
    "model": {"in_channels": 48, "out_ch": 3, "pred_channels": 3,
              "use_other_channels": True, "other_channels_begin": 3,
              "use_gt_in_train": True, "ch": 32, "ch_mult": [1, 2],
              "num_res_blocks": 1, "attn_resolutions": [4]},
    "diffusion": {"num_diffusion_timesteps": 50},
}
FLAGSHIP_PARAMS = 156_492_675
SEED = 61
CROPS = 16                  # the production profile's 2 x 8 crops a step
RESTORE_STEPS = 1


def _leaf_ratio(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                rel: float, floor: float = 0.0,
                part: Callable[[torch.Tensor], torch.Tensor] = lambda w: w
                ) -> float:
    """The worst, over the leaves, of |got - part(want)|max over its
    tolerance: ``rel`` of the leaf's own scale (|want|max) plus ``floor``
    of the largest gradient of all leaves.  ``part`` maps a whole leaf to
    the piece ``got`` holds (an FSDP2 rank's dim-0 chunk).  At most 1
    passes."""
    if got.keys() != want.keys():
        raise AssertionError(f"leaves differ: {sorted(got.keys() ^ want.keys())}")
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        g, piece = got[k], part(w)
        assert g.shape == piece.shape, (k, g.shape, piece.shape)
        if not piece.numel():
            continue
        tol = rel * float(w.abs().max()) + floor * top
        err = float((g.float() - piece.float()).abs().max())
        worst = max(worst, err / tol if tol > 0 else (0.0 if err == 0
                                                      else float("inf")))
    return worst


def _chunk(w: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's dim-0 chunk of ``w`` as FSDP2 splits it
    (``torch.chunk``; empty past the last chunk)."""
    parts = w.chunk(mesh.size, 0)
    return parts[mesh.rank] if mesh.rank < len(parts) else w[:0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tiny_train_step(mesh) -> Dict:
    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.parallel.mesh import fsdp_shard, shard_batch
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step
    from torch.distributed.tensor import DTensor, Shard

    cfg = config_from_dict(copy.deepcopy(TINY))
    model = build_unet(cfg, None, mesh.device, train=True)
    wrapped = fsdp_shard(model, mesh)
    state = create_train_state(wrapped, cfg.optim, 0)
    batch = np.random.default_rng(1).random((2 * mesh.size, 32, 32, 6),
                                            dtype=np.float32)
    m = make_train_step(cfg, wrapped, mesh=mesh)(state,
                                                 shard_batch(batch, mesh))
    loss = float(m.loss)
    assert state.step == 1 and np.isfinite(loss), loss
    sharded = 0
    for k, p in model.named_parameters():
        for t in (p, state.ema[k]):
            assert isinstance(t, DTensor) and t.placements == (Shard(0),), k
        sharded += 1
    return {"loss": loss, "sharded_leaves": sharded}


def _tiny_sampler(mesh) -> Dict:
    from wavedm_tpu_torch.config import config_from_dict
    from wavedm_tpu_torch.diffusion.sampling import make_overlapping_sampler
    from wavedm_tpu_torch.diffusion.schedules import (ddim_timesteps,
                                                      get_beta_schedule)
    from wavedm_tpu_torch.inference.loader import build_unet

    cfg = config_from_dict(copy.deepcopy(TINY))
    model = build_unet(cfg, None, mesh.device)
    betas = torch.as_tensor(get_beta_schedule(
        "linear", beta_start=1e-4, beta_end=0.02,
        num_diffusion_timesteps=50), dtype=torch.float32)
    kw = dict(image_shape=(16, 24), patch_size=8, grid_r=4,
              seq=ddim_timesteps(50, 5), betas=betas, pred_channels=3,
              use_other=True)
    gen = torch.Generator().manual_seed(3)
    args = [torch.randn((1, c, 16, 24), generator=gen).to(mesh.device)
            for c in (3, 48, 45)]
    whole = make_overlapping_sampler(model, **kw)(*args)
    parts = make_overlapping_sampler(model, mesh=mesh, **kw)(*args)
    err = max(float((a - b).abs().max()) for a, b in zip(whole, parts))
    assert err <= 1e-5, err
    lo, hi = mesh.span(24)
    return {"patches": 24, "rank_patches": hi - lo, "max_abs_err": err,
            "tol_abs": 1e-5}


def _flagship_placement(mesh) -> Dict:
    from wavedm_tpu_torch.config import reference_profile
    from wavedm_tpu_torch.models.unet import DiffusionUNet
    from wavedm_tpu_torch.parallel.distributed import collective_device
    from wavedm_tpu_torch.parallel.mesh import fsdp_shard
    from torch.distributed.tensor import DTensor, Shard

    with torch.device("meta"):
        unet = DiffusionUNet.from_config(reference_profile(),
                                         keep_f32_params=True)
    n = sum(p.numel() for p in unet.parameters())
    assert n == FLAGSHIP_PARAMS, n
    fsdp_shard(unet, mesh)
    local = 0
    for k, p in unet.named_parameters():
        assert isinstance(p, DTensor) and p.placements == (Shard(0),), k
        local += p.to_local().numel()
    total = torch.tensor([local], dtype=torch.int64,
                         device=collective_device())
    dist.all_reduce(total)
    assert int(total) == n, (int(total), n)
    return {"params": n, "rank_params": local,
            "leaves": len(list(unet.parameters()))}


def _flagship_cfg(dtype: str, **parallel):
    from wavedm_tpu_torch.config import production_profile

    cfg = production_profile()
    cfg.parallel.compute_dtype = dtype
    for k, v in parallel.items():
        setattr(cfg.parallel, k, v)
    return cfg.validate()


def _train_once(cfg, hfrm, mesh, batch, wrap=None):
    """One production step on a fresh flagship UNet drawn from the seed;
    ``wrap`` (a mesh wrapper) or none (one process on ``batch``, the
    whole global batch).  Returns (loss, {name: gradient}, ms): each
    gradient as this rank holds it, under FSDP2 its dim-0 shard (gathering
    a flagship gradient whole over gloo on CUDA tensors crashed on the
    H100's torch 2.11: ``DTensor.full_tensor``'s all-gather)."""
    from wavedm_tpu_torch.inference.loader import build_unet
    from wavedm_tpu_torch.parallel.mesh import unwrap
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    model = build_unet(cfg, None, mesh.device, train=True)
    wrapped = model if wrap is None else wrap(model, mesh)
    state = create_train_state(wrapped, cfg.optim, cfg.training.seed)
    step = make_train_step(cfg, wrapped, hfrm,
                           None if wrap is None else mesh)
    _sync(mesh.device)
    t0 = time.perf_counter()
    m = step(state, batch)
    loss = float(m.loss)
    _sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3
    grads = {k: getattr(p.grad, "_local_tensor", p.grad).detach()
             for k, p in unwrap(wrapped).named_parameters()
             if p.grad is not None}
    return loss, grads, ms


def _flagship_steps(mesh) -> Dict:
    from wavedm_tpu_torch.inference.loader import build_hfrm
    from wavedm_tpu_torch.parallel.mesh import (fsdp_shard, replicate,
                                                shard_batch)

    batch = np.random.default_rng(SEED).random((CROPS, 256, 256, 6),
                                               dtype=np.float32)
    local = shard_batch(batch, mesh)
    # world 1: wrapping must not change a bit (a collective over one rank
    # divides by 1), so 1e-6 of each leaf's scale, FSDP2 against DDP too;
    # more ranks sum their parts in another order: 1e-4 of the leaf's
    # scale plus 1e-6 of the largest gradient (the rule the card's other
    # gradient checks use)
    rel, floor = (1e-6, 0.0) if mesh.size == 1 else (1e-4, 1e-6)
    out, counts = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = _flagship_cfg(dtype, fused_resblock=True)
            hfrm = build_hfrm(cfg, None, mesh.device)
            # over ranks only the float32 step is held to one process's
            # and to FSDP2's; the caller holds the bfloat16 loss to world
            # 1's (the report's bf16_ddp_loss)
            held = tag == "f32" or mesh.size == 1
            if held and mesh.rank == 0:
                ref_loss, ref, ref_ms = _train_once(cfg, hfrm, mesh, batch)
                if mesh.size == 1:
                    # a second run: what any gap to DDP could owe to the
                    # card itself
                    _, ref2, _ = _train_once(cfg, hfrm, mesh, batch)
                    out[f"{tag}_unwrapped_gap"] = _leaf_ratio(ref2, ref, 1.0)
                    del ref2
                out[f"{tag}_unwrapped_ms"] = ref_ms
                out[f"{tag}_ref_loss"] = ref_loss
            reset_launch_counts()
            loss, ddp, ms = _train_once(cfg, hfrm, mesh, local, replicate)
            counts[f"{tag}_ddp"] = launch_counts()
            out[f"{tag}_ddp_ms"], out[f"{tag}_ddp_loss"] = ms, loss
            if held and mesh.rank == 0:
                r = _leaf_ratio(ddp, ref, rel, floor)
                out[f"{tag}_ddp_vs_one_process"] = r
                assert r <= 1.0, (tag, r)
                del ref
            if held:
                reset_launch_counts()
                loss, shards, ms = _train_once(cfg, hfrm, mesh, local,
                                               fsdp_shard)
                counts[f"{tag}_fsdp"] = launch_counts()
                out[f"{tag}_fsdp_ms"], out[f"{tag}_fsdp_loss"] = ms, loss
                # each rank's shards against its chunks of DDP's gradients
                r = torch.tensor([_leaf_ratio(
                    shards, ddp, rel, floor,
                    lambda w: _chunk(w, mesh))], dtype=torch.float64,
                    device=collective_device())
                dist.all_reduce(r, op=dist.ReduceOp.MAX)
                out[f"{tag}_fsdp_vs_ddp"] = r = float(r)
                assert r <= 1.0, (tag, r)
                del shards
            del ddp, hfrm
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    out["tol"] = {"rel": rel, "floor": floor}
    return {"checks": out, "launches": counts}


def _flagship_restore(mesh) -> Dict:
    from wavedm_tpu_torch.data.synthetic import SyntheticPairs
    from wavedm_tpu_torch.inference.loader import build_restorer

    src = SyntheticPairs(n_images=2, seed=SEED)
    pairs = [np.concatenate(src[i], axis=-1) for i in range(2)]
    images = np.stack([p[..., :3] for p in pairs])
    out, counts, refs = {}, {}, {}
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        cfg = _flagship_cfg(dtype, fused_groupnorm=True)
        cfg.sampling.sampling_timesteps = RESTORE_STEPS
        plain = build_restorer(cfg, None, None, mesh.device)
        if mesh.rank == 0:
            refs[tag] = plain.restore_image_device(images)[0]
        sharded = build_restorer(cfg, None, None, mesh.device, mesh=mesh)
        if tag == "bf16":      # float32's seconds a run: its first is its time
            sharded.restore_image_device(images)
        reset_launch_counts()
        _sync(mesh.device)
        t0 = time.perf_counter()
        got = sharded.restore_image_device(images)[0]
        _sync(mesh.device)
        out[f"{tag}_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / 2
        counts[f"{tag}_sharded"] = launch_counts()
        assert bool(torch.isfinite(got).all()) and tuple(got.shape) == (
            2, 480, 720, 3)
        if mesh.rank == 0:
            out[f"{tag}_max_abs_err"] = float((got - refs[tag]).abs().max())
        if tag == "bf16":
            # restore(): each rank scores its stripe of the two pairs
            reset_launch_counts()
            res = plain.restore(
                (pairs[i], f"pair{i}")
                for i in range(mesh.rank, 2, mesh.size))
            counts["bf16_restore"] = launch_counts()
            out["restore"] = res
            out["scores"] = plain.scores
        del plain, sharded
    if mesh.rank == 0:
        gap = float((refs["bf16"] - refs["f32"]).abs().max())
        out["bf16_vs_f32_gap"] = gap
        assert out["f32_max_abs_err"] <= 1e-3, out["f32_max_abs_err"]
        assert out["bf16_max_abs_err"] <= gap, (out["bf16_max_abs_err"], gap)
    lo, hi = mesh.span(90)
    out["patches"], out["rank_patches"] = 90, hi - lo
    return {"checks": out, "launches": counts}


def _probe_collectives(mesh) -> Dict[str, str]:
    """Which collectives the backend takes on this device's tensors: "ok"
    or the error (a refusal is raised on every rank alike, before any
    traffic)."""
    x = torch.full((4 * mesh.size,), float(mesh.rank + 1),
                   device=mesh.device)
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(mesh.size)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(x.numel() * mesh.size), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(4), x),
    }
    out = {}
    for name, fn in probes.items():
        try:
            with warnings.catch_warnings():     # renamed in newer torch
                warnings.simplefilter("ignore", FutureWarning)
                fn()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 -- recorded, not relied on
            out[name] = f"{type(e).__name__}: {e}"[:200]
    return out


def _wait_for(gate: str, timeout_s: float) -> None:
    t0 = time.monotonic()
    while not os.path.exists(gate):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"the gate {gate} never opened")
        time.sleep(0.05)


def run_rank(full: bool = False, lock: bool = False,
             gate: Optional[str] = None, gate_timeout_s: float = 900.0
             ) -> Dict:
    """One rank's dry run (called by the ranks :func:`start_dryrun`
    starts); returns its report."""
    from wavedm_tpu_torch.parallel.distributed import local_device
    from wavedm_tpu_torch.parallel.mesh import make_mesh
    from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock

    mesh = make_mesh(-1, local_device())
    if mesh.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if lock:
        acquire_gpu_lock("dryrun", mesh.device)
    report = {"rank": mesh.rank, "world": mesh.size,
              "backend": dist.get_backend(), "device": str(mesh.device),
              "collectives": _probe_collectives(mesh), "phases": {}}
    tiny = [("tiny_train_step", _tiny_train_step),
            ("sharded_sampler", _tiny_sampler),
            ("flagship_fsdp_placement", _flagship_placement)]
    flagship = [("flagship_steps", _flagship_steps),
                ("flagship_restore", _flagship_restore)] if full else []

    if gate is not None:
        _wait_for(f"{gate}.build", gate_timeout_s)

    def run(phases):
        t_start = time.perf_counter()
        for name, fn in phases:
            t0 = time.perf_counter()
            result = fn(mesh)
            result["s"] = time.perf_counter() - t0
            report["phases"][name] = result
        return time.perf_counter() - t_start

    report["tiny_s"] = run(tiny)
    if gate is not None:
        with open(f"{gate}.ready{mesh.rank}", "w") as f:
            f.write("ready\n")
        _wait_for(gate, gate_timeout_s)
    report["s"] = run(flagship)
    if mesh.device.type == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    return report


def start_dryrun(world: int, device="cpu", backend=None, full: bool = False,
                 lock: bool = False, gate: Optional[str] = None,
                 **kwargs) -> World:
    """Start the dry run's ``world`` ranks on ``device`` (every rank on
    that one device when it names an index, else rank r on card r) over
    ``backend``; ``lock`` takes each rank's card lock first; with a
    ``gate`` the phases wait for that file (see the module).  Keywords go to
    :class:`~wavedm_tpu_torch.parallel.launch.World` (its deadline also
    bounds the wait).  Its ``join()`` returns the ranks' reports."""
    deadline = kwargs.setdefault("deadline", 300.0)
    return World("wavedm_tpu_torch.parallel.dryrun:run_rank", world,
                 (full, lock, gate, deadline), device=device,
                 backend=backend, **kwargs)


def dryrun_multigpu(world: int, device="cpu", backend=None,
                    full: bool = False, **kwargs) -> List[Dict]:
    """Run the dry run on ``world`` ranks and return their reports (see
    :func:`start_dryrun`)."""
    return start_dryrun(world, device, backend, full, **kwargs).join()
