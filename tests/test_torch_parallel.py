"""PyTorch port: the multi-process paths (``parallel/``) over gloo on the CPU,
against the JAX package's single-device functions and against one process.

Each world of ranks is started once for the module (``parallel/launch.py``:
fresh processes, a file rendezvous, a deadline) and computes everything;
the tests below assert on what the ranks returned.  The ranks import this
module, so it imports no JAX at its top: the JAX side is imported inside
the fixtures and tests that need it.

Tolerances, everything in float32:
- the DDP step at world 2 on the global batch of 8 crops against JAX's
  single-device step on it, t and noise JAX's own draws: those of
  ``tests/test_torch_training.py::test_train_steps_match_jax`` (metrics
  1e-4 relative; parameters, moments and EMA 1e-4 of each tensor's scale,
  under Adam up to one element in a thousand off by at most its step),
  and each gradient, read from SGD's momentum trace, within 1e-4 of its
  tensor's scale plus 1e-6 of the largest gradient, as
  ``test_torch_switches.py::test_train_step_matches_jax`` holds it; the
  same rule against one torch process;
- FSDP2 against DDP over three steps: ``tests/test_multichip.py``'s (SGD:
  losses 1e-5 relative, parameters and EMA atol 1e-6 + rtol 1e-5; Adam:
  losses 2e-4 relative, parameters within twice three steps of lr);
- checkpoints: bit for bit;
- the sharded sampler at worlds 2 and 3 against JAX's unsharded one: 1e-4
  (``tests/test_torch_sampling.py``'s);
- ``restore()``: every rank's means equal the means over both ranks'
  per-image metrics to 1e-12.
"""

import copy
import os

import numpy as np
import pytest
import torch

from wavedm_tpu_torch.config import ConfigError, config_from_dict
from wavedm_tpu_torch.parallel import (initialize_multihost, is_coordinator,
                                       make_mesh, process_count,
                                       process_index)
from wavedm_tpu_torch.parallel.dryrun import TINY, dryrun_multigpu
from wavedm_tpu_torch.parallel.launch import World

DEADLINE = 240.0
N_CROPS = 8
# tests/test_torch_training.py's RAW: 64 channels, so no bias before a
# one-channel GroupNorm group has an identically zero gradient
RAW = {
    "data": {"image_size": 8, "patch_size": 32, "wavelet": True},
    "model": {"in_channels": 48, "out_ch": 3, "pred_channels": 3,
              "use_other_channels": True, "other_channels_begin": 3,
              "use_gt_in_train": True, "ch": 64, "ch_mult": [1, 2],
              "num_res_blocks": 1, "attn_resolutions": [4], "dropout": 0.0},
    "diffusion": {"num_diffusion_timesteps": 50},
    "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
             "dec_blk_nums": [1, 1]},
    "sampling": {"sampling_timesteps": 3},
}
OPTIMIZERS = {"sgd": {"optimizer": "SGD", "lr": 1e-5},
              "adam": {"optimizer": "Adam"}}
# the sampler: two 20x24 wavelet images, 20 patches of 8 each (K = 20):
# 40 patches split 20/20 at world 2 and 14/13/13 at world 3 (a span
# across the image boundary)
SAMPLER = dict(h=20, w=24, p=8, r=4, b=2)
SOLVERS = ("ddim", "dpmpp2m")


def _cfg(**sections):
    raw = copy.deepcopy(RAW)
    for name, values in sections.items():
        raw.setdefault(name, {}).update(values)
    return config_from_dict(raw)


def _one_thread():
    torch.set_num_threads(1)


# ------------------------------------------------------------ rank side


def _unet(sd, cfg):
    from wavedm_tpu_torch.models.unet import DiffusionUNet

    model = DiffusionUNet.from_config(cfg, keep_f32_params=True)
    model.load_state_dict(sd)
    return model


def _full(module):
    from wavedm_tpu_torch.parallel.mesh import full_state_dict

    return {k: v.detach().clone() for k, v in full_state_dict(module).items()}


def _ddp_step(mesh, sd, batch, opt, t, e, **training):
    """One DDP step on this rank's slice, JAX's t and e for the global
    batch; the parameters, gradients, moments and EMA after it."""
    from wavedm_tpu_torch.parallel.mesh import replicate, shard_batch
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    cfg = _cfg(optim=OPTIMIZERS[opt], training=training)
    model = _unet(sd, cfg)
    ddp = replicate(model, mesh)
    state = create_train_state(ddp, cfg.optim, cfg.training.seed)
    m = make_train_step(cfg, ddp, mesh=mesh)(
        state, shard_batch(batch, mesh), t=torch.from_numpy(t),
        e=torch.from_numpy(e))
    named = dict(model.named_parameters())
    return state, {
        "metrics": {k: float(getattr(m, k)) for k in
                    ("loss", "mse_loss", "loss_per_pixel", "grad_norm")},
        "params": _full(model),
        "grads": {k: p.grad.clone() for k, p in named.items()},
        "moments": {k: {n: v.clone() for n, v in
                        state.optimizer.state[p].items() if n != "step"}
                    for k, p in named.items()},
        "ema": {k: v.clone() for k, v in state.ema.items()}}


def _trajectory(mesh, sd, batch, opt, layout, steps=3):
    """``steps`` steps under DDP or FSDP2 from the same start and the same
    draws; the losses, the whole parameters and EMA, and the state."""
    from torch.distributed.tensor import DTensor

    from wavedm_tpu_torch.parallel.mesh import (fsdp_shard, full_tensor,
                                                replicate, shard_batch)
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    cfg = _cfg(optim=OPTIMIZERS[opt])
    model = _unet(sd, cfg)
    wrapped = (fsdp_shard if layout == "fsdp" else replicate)(model, mesh)
    state = create_train_state(wrapped, cfg.optim, cfg.training.seed)
    step = make_train_step(cfg, wrapped, mesh=mesh)
    local = shard_batch(batch, mesh)
    losses = [float(step(state, local).loss) for _ in range(steps)]
    placement = {k: (isinstance(p, DTensor) and p.placements,
                     isinstance(state.ema[k], DTensor)
                     and state.ema[k].placements)
                 for k, p in model.named_parameters()}
    return state, cfg, {
        "losses": losses, "params": _full(model),
        "ema": {k: full_tensor(v).clone() for k, v in state.ema.items()},
        "placement": placement}


def _checkpoints(mesh, sd, batch, adam_state, fsdp_state, fsdp_cfg,
                 ckpt_dir, world1_ckpt):
    """World 2 writes its DDP and FSDP states; a world-1 checkpoint loads
    into a fresh DDP state and is written again; an FSDP file loads into a
    fresh FSDP state with its values and placement."""
    from torch.distributed.tensor import DTensor

    from wavedm_tpu_torch.parallel.mesh import (fsdp_shard, full_tensor,
                                                replicate)
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    cfg = _cfg(optim=OPTIMIZERS["adam"])
    save_checkpoint(os.path.join(ckpt_dir, "world2"), adam_state, cfg,
                    epoch=3)
    fresh = create_train_state(replicate(_unet(sd, cfg), mesh), cfg.optim, 9)
    load_checkpoint(world1_ckpt, fresh, cfg)
    save_checkpoint(os.path.join(ckpt_dir, "world2_from_world1"), fresh, cfg,
                    epoch=3)
    path = save_checkpoint(os.path.join(ckpt_dir, "fsdp"), fsdp_state,
                           fsdp_cfg, epoch=3)
    model = fsdp_shard(_unet(sd, fsdp_cfg), mesh)
    tmpl = create_train_state(model, fsdp_cfg.optim, 9)
    torch.distributed.barrier()          # rank 0 has written the file
    meta = load_checkpoint(path, tmpl, fsdp_cfg)
    same = meta["epoch"] == 3 and tmpl.step == fsdp_state.step
    for k, p in model.named_parameters():
        q = dict(fsdp_state.model.named_parameters())[k]
        same &= isinstance(p, DTensor) and p.placements == q.placements
        same &= torch.equal(full_tensor(p), full_tensor(q))
        same &= torch.equal(full_tensor(tmpl.ema[k]),
                            full_tensor(fsdp_state.ema[k]))
    return bool(same)


def _rank0_writes(mesh, state, ckpt_dir):
    """Each rank saves a checkpoint and logs metrics to a path of its own:
    only rank 0's appear."""
    from wavedm_tpu_torch.utils.checkpoint import save_checkpoint
    from wavedm_tpu_torch.utils.profiling import MetricsLogger

    cfg = _cfg(optim=OPTIMIZERS["sgd"])
    save_checkpoint(os.path.join(ckpt_dir, f"own{mesh.rank}"), state, cfg)
    MetricsLogger(os.path.join(ckpt_dir, f"metrics{mesh.rank}.jsonl")).log(
        1, loss=1.0)
    torch.distributed.barrier()
    return sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith(("own", "metrics")))


def _hfrm_step(mesh, hfrm_sd, batch):
    from wavedm_tpu_torch.parallel.mesh import shard_batch
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    trainer = HFRMTrainer(_cfg(hfrm={"use_gan": True}), device="cpu",
                          log_fn=lambda s: None)
    trainer.model.load_state_dict(hfrm_sd)
    loss, psnr = trainer.train_step(shard_batch(batch, mesh))
    grads = {("g", k): p.grad.clone()
             for k, p in trainer.model.named_parameters()
             if p.grad is not None}
    grads.update({("d", k): p.grad.clone() for k, p in
                  trainer.disc_state.model.named_parameters()})
    return {"loss": float(loss), "psnr": float(psnr),
            "d_loss": float(trainer.d_loss), "grads": grads}


def _restore(mesh, pairs, dump_dir):
    from wavedm_tpu_torch.inference.loader import build_restorer

    rest = build_restorer(_cfg(), None, None, "cpu")
    save_dir = os.path.join(dump_dir, f"rank{mesh.rank}")
    res = rest.restore(((pairs[i], f"pair{i}") for i in
                        range(mesh.rank, len(pairs), mesh.size)),
                       save_dir=save_dir)
    out = {"result": res, "scores": rest.scores,
           "dumps": sorted(os.listdir(save_dir))
           if os.path.isdir(save_dir) else None}
    if mesh.rank == 0:
        # in-train validation: rank 0 alone, no collective
        out["alone"] = rest.restore([(pairs[0], "alone")], reduce=False)
    torch.distributed.barrier()
    return out


def sampler_rank(sd, x_t, cond, other):
    """The tiny tiled sampler split over this world's ranks, each solver."""
    from wavedm_tpu_torch.diffusion.sampling import make_overlapping_sampler
    from wavedm_tpu_torch.models.unet import DiffusionUNet
    from wavedm_tpu_torch.parallel.dryrun import _probe_collectives
    from wavedm_tpu_torch.parallel.mesh import make_mesh

    _one_thread()
    mesh = make_mesh(-1, "cpu")
    model = DiffusionUNet.from_config(config_from_dict(copy.deepcopy(TINY)))
    model.load_state_dict(sd)
    model.eval()
    s = SAMPLER
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa
    out = {"span": mesh.span(s["b"] * 20),
           "collectives": _probe_collectives(mesh)}
    for solver in SOLVERS:
        sample = make_overlapping_sampler(
            model, image_shape=(s["h"], s["w"]), patch_size=s["p"],
            grid_r=s["r"], seq=np.arange(0, 50, 5),
            betas=torch.linspace(1e-4, 2e-2, 50), pred_channels=3,
            use_other=True, solver=solver, mesh=mesh)
        out[solver] = sample(nchw(x_t), nchw(cond), nchw(other))
    return out


def train_rank(sd, batch, draws, hfrm_sd, hfrm_batch, pairs, sampler_in,
               ckpt_dir, world1_ckpt, dump_dir):
    """Everything the world-2 tests read, computed once."""
    from wavedm_tpu_torch.parallel.mesh import make_mesh

    _one_thread()
    mesh = make_mesh(-1, "cpu")
    out = {"rank": mesh.rank}
    states = {}
    for opt in OPTIMIZERS:
        t, e = draws[opt]
        states[opt], out[f"ddp_{opt}"] = _ddp_step(mesh, sd, batch, opt, t, e)
    t, e = draws["sgd"]
    _, accum = _ddp_step(mesh, sd, batch, "sgd", t, e, grad_accum=2)
    out["accum2_grads"] = accum["grads"]
    for opt in OPTIMIZERS:
        for layout in ("ddp", "fsdp"):
            state, cfg, out[f"traj_{opt}_{layout}"] = _trajectory(
                mesh, sd, batch, opt, layout)
            if (opt, layout) == ("adam", "fsdp"):
                fsdp_state, fsdp_cfg = state, cfg
    out["fsdp_roundtrip"] = _checkpoints(mesh, sd, batch, states["adam"],
                                         fsdp_state, fsdp_cfg, ckpt_dir,
                                         world1_ckpt)
    out["writes"] = _rank0_writes(mesh, states["sgd"], ckpt_dir)
    out["hfrm"] = _hfrm_step(mesh, hfrm_sd, hfrm_batch)
    out["restore"] = _restore(mesh, pairs, dump_dir)
    try:
        make_mesh(3, "cpu")
    except ConfigError as err:
        out["make_mesh_3"] = str(err)
    out["coordinator"] = (is_coordinator(), process_index(),
                          process_count())
    out["sampler"] = sampler_rank(*sampler_in)
    return out


# ------------------------------------------------------------ test side


@pytest.fixture(scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    _one_thread()
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    """Inputs from numpy seeds and JAX's draws; the worlds of 2 and 3
    started, JAX's side computed while they run; everything returned."""
    import jax
    import jax.numpy as jnp

    from wavedm_tpu.diffusion.loss import \
        antithetic_timesteps as jax_antithetic
    from wavedm_tpu_torch.inference.loader import build_hfrm, build_unet
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step
    from wavedm_tpu_torch.utils.checkpoint import save_checkpoint

    tmp = tmp_path_factory.mktemp("parallel")
    cfg = _cfg()
    sd = {k: v.clone() for k, v in
          build_unet(cfg, None, "cpu", train=True).state_dict().items()}
    batch = np.random.default_rng(2).random((N_CROPS, 32, 32, 6),
                                            dtype=np.float32)
    draws = {}
    for opt in OPTIMIZERS:
        # the draws of the JAX step's first call from PRNGKey(1)
        _, key_t, key_e = jax.random.split(jax.random.PRNGKey(1), 3)
        t = np.asarray(jax_antithetic(key_t, N_CROPS, 50))
        e = np.asarray(jax.random.normal(key_e, (N_CROPS, 8, 8, 3),
                                         jnp.float32))
        draws[opt] = (t.copy(), e.transpose(0, 3, 1, 2).copy())
    rng = np.random.default_rng(5)
    hfrm_sd = {k: v + torch.from_numpy(
        0.05 * rng.standard_normal(v.shape).astype(np.float32))
        for k, v in build_hfrm(cfg, None, "cpu").state_dict().items()}
    hfrm_batch = np.random.default_rng(6).random((4, 32, 32, 6),
                                                 dtype=np.float32)
    pairs = [np.random.default_rng(10 + i).random((32, 32, 6),
                                                  dtype=np.float32)
             for i in range(4)]
    tiny_sd = {k: v.clone() for k, v in build_unet(
        config_from_dict(copy.deepcopy(TINY)), None, "cpu").state_dict()
        .items()}
    s, srng = SAMPLER, np.random.default_rng(0)
    sampler_in = (tiny_sd,
                  srng.standard_normal((s["b"], s["h"], s["w"], 3))
                  .astype(np.float32),
                  srng.uniform(-1, 1, (s["b"], s["h"], s["w"], 48))
                  .astype(np.float32),
                  srng.uniform(-1, 1, (s["b"], s["h"], s["w"], 45))
                  .astype(np.float32))
    # a world-1 checkpoint for world 2 to load: one Adam step here
    w1_cfg = _cfg(optim=OPTIMIZERS["adam"])
    w1_state = create_train_state(_unet(sd, w1_cfg), w1_cfg.optim, 4)
    make_train_step(w1_cfg, w1_state.model)(w1_state, batch)
    w1_ckpt = save_checkpoint(str(tmp / "world1"), w1_state, w1_cfg, epoch=3)

    kw = dict(device="cpu", threads=1, deadline=DEADLINE)
    world2 = World(f"{__name__}:train_rank", 2,
                   (sd, batch, draws, hfrm_sd, hfrm_batch, pairs, sampler_in,
                    str(tmp), w1_ckpt, str(tmp / "dumps")), **kw)
    world3 = World(f"{__name__}:sampler_rank", 3, sampler_in, **kw)
    jax_side = _jax_side(sd, tiny_sd, batch, sampler_in)
    return {"world2": world2.join(),
            "world3": [{"sampler": r} for r in world3.join()],
            "jax": jax_side, "sd": sd, "batch": batch, "draws": draws,
            "hfrm_sd": hfrm_sd, "hfrm_batch": hfrm_batch, "tmp": tmp,
            "world1_ckpt": w1_ckpt, "pairs": pairs}


def _jax_side(sd, tiny_sd, batch, sampler_in):
    """JAX's single-device step on the global batch for each optimizer,
    and its unsharded sampler for each solver."""
    import jax
    import jax.numpy as jnp

    from wavedm_tpu.config import config_from_dict as jax_config_from_dict
    from wavedm_tpu.diffusion import sampling as jax_sampling
    from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet
    from wavedm_tpu.training import train_step as jax_train_step
    from wavedm_tpu.training.state import \
        create_train_state as jax_create_train_state
    from wavedm_tpu.utils.torch_compat import convert_unet_state_dict

    out = {}
    np_sd = {k: v.numpy() for k, v in sd.items()}
    params = jax.tree_util.tree_map(jnp.asarray, convert_unet_state_dict(
        np_sd, num_levels=2, num_res_blocks=1))
    for opt in OPTIMIZERS:
        raw = copy.deepcopy(RAW)
        raw["optim"] = dict(OPTIMIZERS[opt])
        jcfg = jax_config_from_dict(raw)
        jstep = jax_train_step.make_train_step(
            jcfg, JaxUNet.from_config(jcfg).apply, donate=False)
        jstate = jax_create_train_state(params, jcfg.optim,
                                        jax.random.PRNGKey(1))
        out[opt] = jstep(jstate, jnp.asarray(batch))
    tiny = jax_config_from_dict(copy.deepcopy(TINY))
    jmodel = JaxUNet.from_config(tiny)
    tparams = jax.tree_util.tree_map(jnp.asarray, convert_unet_state_dict(
        {k: v.numpy() for k, v in sampler_in[0].items()}, num_levels=2,
        num_res_blocks=1))
    s = SAMPLER
    for solver in SOLVERS:
        sample = jax_sampling.make_overlapping_sampler(
            lambda prm, x, t: jmodel.apply({"params": prm}, x, t),
            image_shape=(s["h"], s["w"]), patch_size=s["p"], grid_r=s["r"],
            seq=np.arange(0, 50, 5),
            betas=jnp.asarray(np.linspace(1e-4, 2e-2, 50), jnp.float32),
            pred_channels=3, use_other=True, solver=solver)
        xf, x0 = sample(*(jnp.asarray(a) for a in sampler_in[1:]),
                        params=tparams)
        out[solver] = (np.asarray(xf).transpose(0, 3, 1, 2),
                       np.asarray(x0).transpose(0, 1, 4, 2, 3))
    return out


def _rank0(runs):
    return runs["world2"][0]


def _torch_of(tree):
    from wavedm_tpu_torch.utils.convert import unet_state_dict_from_flax

    return unet_state_dict_from_flax(tree, 2, 1)


def _grad_rule(got, want):
    """Each leaf within 1e-4 of its scale plus 1e-6 of the largest."""
    g_all = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-6 * g_all, (k, err)


def _world1_step(runs, opt, **training):
    """The same step in this process: one torch process, the whole batch."""
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.training.train_step import make_train_step

    cfg = _cfg(optim=OPTIMIZERS[opt], training=training)
    model = _unet(runs["sd"], cfg)
    state = create_train_state(model, cfg.optim, cfg.training.seed)
    t, e = runs["draws"][opt]
    m = make_train_step(cfg, model)(state, runs["batch"],
                                    t=torch.from_numpy(t),
                                    e=torch.from_numpy(e))
    return m, model


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_ddp_step_matches_jax_on_the_global_batch(runs, opt):
    import jax

    got = _rank0(runs)[f"ddp_{opt}"]
    jstate, jm = runs["jax"][opt]
    for name, v in got["metrics"].items():
        want = float(getattr(jm, name))
        assert abs(v - want) <= 1e-4 * abs(want), name
    adaptive = opt == "adam"
    trees = {"params": (_torch_of(jstate.params), got["params"]),
             "ema": (_torch_of(jstate.ema), got["ema"])}
    for s in jax.tree_util.tree_leaves(
            jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu")
            or hasattr(s, "trace")):
        if hasattr(s, "mu"):
            trees["exp_avg"] = (_torch_of(s.mu),
                                {k: m["exp_avg"] for k, m in
                                 got["moments"].items()})
            trees["exp_avg_sq"] = (_torch_of(s.nu),
                                   {k: m["exp_avg_sq"] for k, m in
                                    got["moments"].items()})
        elif hasattr(s, "trace"):
            # after one step SGD's momentum trace is the gradient
            _grad_rule(got["grads"], _torch_of(s.trace))
    for what, (want, have) in trees.items():
        for k, w in want.items():
            if k.endswith(".k.bias"):         # its gradient is exactly 0
                continue
            diff = (have[k] - w).abs()
            bad = diff > 1e-4 * float(w.abs().max())
            if adaptive and what in ("params", "ema"):
                assert int(bad.sum()) <= max(1, w.numel() // 1000), (what, k)
                assert float(diff.max()) <= 10 * _cfg().optim.lr, (what, k)
            else:
                assert not bool(bad.any()), (what, k, float(diff.max()))


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_ddp_step_matches_one_process(runs, opt):
    got = _rank0(runs)[f"ddp_{opt}"]
    m, model = _world1_step(runs, opt)
    for name, v in got["metrics"].items():
        want = float(getattr(m, name))
        assert abs(v - want) <= 1e-5 * abs(want), name
    _grad_rule(got["grads"], {k: p.grad for k, p in
                              model.named_parameters()})


def test_both_ranks_report_the_same_step(runs):
    r0, r1 = runs["world2"]
    for opt in OPTIMIZERS:
        assert r0[f"ddp_{opt}"]["metrics"] == r1[f"ddp_{opt}"]["metrics"]
        for k, v in r0[f"ddp_{opt}"]["params"].items():
            assert torch.equal(v, r1[f"ddp_{opt}"]["params"][k]), k


def test_grad_accum_under_ddp_equals_one_pass(runs):
    """Two micro-batches a rank, DDP's all-reduce on the second only: the
    global gradient of one pass (a sync skipped on the last pass would
    leave each rank its own)."""
    for rank in runs["world2"]:
        _grad_rule(rank["accum2_grads"], _rank0(runs)["ddp_sgd"]["grads"])


def test_fsdp_matches_replicated_trajectory_sgd(runs):
    rep = _rank0(runs)["traj_sgd_ddp"]
    fsdp = _rank0(runs)["traj_sgd_fsdp"]
    np.testing.assert_allclose(rep["losses"], fsdp["losses"], rtol=1e-5)
    for what in ("params", "ema"):
        for k, v in rep[what].items():
            np.testing.assert_allclose(fsdp[what][k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=1e-5)


def test_fsdp_matches_replicated_trajectory_adam(runs):
    rep = _rank0(runs)["traj_adam_ddp"]
    fsdp = _rank0(runs)["traj_adam_fsdp"]
    np.testing.assert_allclose(rep["losses"], fsdp["losses"], rtol=2e-4)
    bound = 2 * 3 * _cfg().optim.lr   # twice three Adam steps' travel
    for k, v in rep["params"].items():
        assert float((fsdp["params"][k] - v).abs().max()) < bound, k


def test_ema_keeps_fsdp_placement(runs):
    from torch.distributed.tensor import Shard

    for rank in runs["world2"]:
        placement = rank["traj_adam_fsdp"]["placement"]
        assert placement and all(p == e == (Shard(0),)
                                 for p, e in placement.values()), placement
        # DDP leaves plain tensors
        assert not any(p for p, _ in
                       rank["traj_adam_ddp"]["placement"].values())


def _load_at_world1(path, sd):
    from wavedm_tpu_torch.training.state import create_train_state
    from wavedm_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = _cfg(optim=OPTIMIZERS["adam"])
    state = create_train_state(_unet(sd, cfg), cfg.optim, 9)
    load_checkpoint(path, state, cfg)
    return state, cfg


def _assert_same_file(a, b):
    x = torch.load(a, weights_only=True)
    y = torch.load(b, weights_only=True)
    assert x.keys() == y.keys()
    for key in ("state_dict", "ema_helper"):
        assert x[key].keys() == y[key].keys()
        for k, v in x[key].items():
            assert torch.equal(v, y[key][k]), (key, k)
    for i, s in x["optimizer"]["state"].items():
        for n, v in s.items():
            assert torch.equal(v, y["optimizer"]["state"][i][n]), (i, n)
    assert x["optimizer"]["param_groups"] == y["optimizer"]["param_groups"]
    assert torch.equal(x["generator"], y["generator"])
    assert (x["step"], x["epoch"]) == (y["step"], y["epoch"])


def test_world2_checkpoint_loads_at_world1_bit_for_bit(runs, tmp_path):
    from wavedm_tpu_torch.utils.checkpoint import save_checkpoint

    path = str(runs["tmp"] / "world2.pth.tar")
    obj = torch.load(path, weights_only=True)
    assert not any(k.startswith("module.") for k in obj["state_dict"])
    for k, v in _rank0(runs)["ddp_adam"]["params"].items():
        assert torch.equal(obj["state_dict"][k], v), k
    state, cfg = _load_at_world1(path, runs["sd"])
    again = save_checkpoint(str(tmp_path / "again"), state, cfg, epoch=3)
    _assert_same_file(path, again)


def test_world1_checkpoint_loads_at_world2_bit_for_bit(runs):
    _assert_same_file(runs["world1_ckpt"],
                      str(runs["tmp"] / "world2_from_world1.pth.tar"))


def test_fsdp_checkpoint_round_trip(runs, tmp_path):
    """Written under FSDP (shards gathered whole), read back into an FSDP
    state with its values and placement, and read at world 1 equal to the
    trajectory's whole parameters."""
    assert all(r["fsdp_roundtrip"] for r in runs["world2"])
    state, _ = _load_at_world1(str(runs["tmp"] / "fsdp.pth.tar"),
                               runs["sd"])
    for k, v in _rank0(runs)["traj_adam_fsdp"]["params"].items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_hfrm_ddp_step_with_gan_matches_one_process(runs):
    from wavedm_tpu_torch.training.hfrm_trainer import HFRMTrainer

    trainer = HFRMTrainer(_cfg(hfrm={"use_gan": True}), device="cpu",
                          log_fn=lambda s: None)
    trainer.model.load_state_dict(runs["hfrm_sd"])
    loss, psnr = trainer.train_step(runs["hfrm_batch"])
    want = {("g", k): p.grad for k, p in trainer.model.named_parameters()
            if p.grad is not None}
    want.update({("d", k): p.grad for k, p in
                 trainer.disc_state.model.named_parameters()})
    for rank in runs["world2"]:
        got = rank["hfrm"]
        for name, v in (("loss", loss), ("psnr", psnr),
                        ("d_loss", trainer.d_loss)):
            assert abs(got[name] - float(v)) <= 1e-5 * abs(float(v)), name
        _grad_rule(got["grads"], want)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("solver", SOLVERS)
def test_sharded_sampler_matches_jax(runs, world, solver):
    out = runs[f"world{world}"][0]["sampler"]
    jf, jx0 = runs["jax"][solver]
    xf, x0 = out[solver]
    np.testing.assert_allclose(xf.numpy(), jf, atol=1e-4)
    np.testing.assert_allclose(x0.numpy(), jx0, atol=1e-4)
    for rank in runs[f"world{world}"][1:]:
        assert torch.equal(rank["sampler"][solver][0], xf)


def test_sampler_spans_split_the_patches(runs):
    assert [r["sampler"]["span"] for r in runs["world2"]] == [(0, 20),
                                                             (20, 40)]
    assert [r["sampler"]["span"] for r in runs["world3"]] == [
        (0, 14), (14, 27), (27, 40)]


def test_collective_probe_takes_a_world_that_does_not_divide_its_size(
        runs):
    """The dry run's record of the collectives a backend takes: at a world
    of 3 every probe is sized to fit (a reduce-scatter's input is a
    multiple of the world)."""
    for rank in runs["world3"]:
        assert set(rank["sampler"]["collectives"].values()) == {"ok"}, rank


def test_restore_reports_the_means_over_both_ranks(runs):
    """Each rank scores its stripe of the four pairs; every rank reports
    the means over all four, equal to the union of the per-image metrics
    both ranks computed.  Each rank draws its x_T from its own generator
    seeded with training.seed, as each JAX process does from its key, so
    the images' metrics are not those of one process (not compared)."""
    results = [r["restore"] for r in runs["world2"]]
    scores = [s for r in results for s in r["scores"]]
    assert sorted(s[0] for s in scores) == [f"pair{i}" for i in range(4)]
    union = np.mean([s[1:] for s in scores], axis=0)
    for r in results:
        res = r["result"]
        assert res["n_images"] == 4
        got = [res["psnr_torch"], res["psnr_y"], res["psnr_np_y"],
               res["ssim"]]
        np.testing.assert_allclose(got, union, rtol=0, atol=1e-12)
    assert results[0]["result"] == results[1]["result"]


def test_only_rank0_writes_dumps(runs):
    r0, r1 = (r["restore"] for r in runs["world2"])
    assert r1["dumps"] is None
    assert r0["dumps"] == sorted(f"pair{i}_{kind}.png" for i in (0, 2)
                                 for kind in ("cond", "gt", "output"))


def test_validation_on_rank0_alone_needs_no_collective(runs):
    """The trainer validates on rank 0 alone (JAX ``trainer.py:191``); its
    ``restore(reduce=False)`` returns there while rank 1 waits.  JAX's
    ``restore()`` all-gathers whenever there is more than one process, so
    JAX's own validation would wait on the other processes for ever (read
    from its source; ROADMAP section 3)."""
    import inspect

    from wavedm_tpu.inference.restoration import \
        DiffusiveRestoration as JaxRestoration
    from wavedm_tpu.training import trainer as jax_trainer

    assert _rank0(runs)["restore"]["alone"]["n_images"] == 1
    assert "alone" not in runs["world2"][1]["restore"]
    src = inspect.getsource(JaxRestoration.restore)
    assert "process_count() > 1" in src and "process_allgather" in src
    assert "process_index() == 0" in inspect.getsource(jax_trainer)


def test_trainers_do_not_read_parallel_fsdp():
    """``parallel.fsdp`` is declared (``config.py``) and read by neither
    JAX trainer; the port's trainer does not read it either: with it on,
    the parameters stay whole (FSDP is ``parallel/mesh.py:fsdp_shard``)."""
    import inspect

    from torch.distributed.tensor import DTensor
    from wavedm_tpu.training import hfrm_trainer as jax_hfrm_trainer
    from wavedm_tpu.training import trainer as jax_trainer

    from wavedm_tpu_torch.training.trainer import DiffusionTrainer

    for module in (jax_trainer, jax_hfrm_trainer):
        assert "fsdp" not in inspect.getsource(module)
    trainer = DiffusionTrainer(_cfg(parallel={"fsdp": True}), device="cpu",
                               log_fn=lambda s: None)
    assert trainer.ddp is trainer.model
    assert not any(isinstance(p, DTensor)
                   for p in trainer.model.parameters())


def test_only_rank0_writes_checkpoints_and_metrics(runs):
    for rank in runs["world2"]:
        assert rank["writes"] == ["metrics0.jsonl", "own0.pth.tar"]


def test_ranks_know_their_place(runs):
    assert [r["coordinator"] for r in runs["world2"]] == [(True, 0, 2),
                                                         (False, 1, 2)]


def test_make_mesh_with_another_size_raises(runs):
    for rank in runs["world2"]:
        assert "world of 2 process(es)" in rank["make_mesh_3"]


def test_initialize_multihost_is_a_no_op_without_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost(device="cpu") is False
    assert initialize_multihost() is False         # idempotent, no card
    assert not torch.distributed.is_initialized()
    assert is_coordinator() and process_index() == 0
    assert process_count() == 1
    mesh = make_mesh(-1, "cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    with pytest.raises(ConfigError, match="world of 1"):
        make_mesh(2, "cpu")


def test_dryrun_at_world2():
    """The dry run ``chip_smoke.py`` runs on the card, here at its tiny
    shapes: an FSDP2 step, the sharded sampler, the flagship's FSDP
    placement on the meta device."""
    reports = dryrun_multigpu(2, "cpu", threads=1, deadline=DEADLINE)
    for r in reports:
        ph = r["phases"]
        assert ph["tiny_train_step"]["sharded_leaves"] > 0
        assert ph["sharded_sampler"]["max_abs_err"] <= 1e-5
        assert ph["flagship_fsdp_placement"]["params"] == 156_492_675
    assert sum(r["phases"]["flagship_fsdp_placement"]["rank_params"]
               for r in reports) == 156_492_675
    assert reports[0]["phases"]["tiny_train_step"]["loss"] == \
        reports[1]["phases"]["tiny_train_step"]["loss"]
