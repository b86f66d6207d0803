"""A cell cut to a size the CPU runs in seconds: the UNet at ch 32, two
levels, one block a level; the HFRM at dim 8; 3 chain steps; images cut
to 64x96.  Widths are cut here only: the benchmark's cells never are."""

import time

import torch

from portbench.harness import make_ctx, run_cell

TINY = ["model.ch=32", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
        "model.attn_resolutions=[4]", "data.image_size=8",
        "data.patch_size=32", "hfrm.dim=8", "hfrm.enc_blk_nums=[1,1]",
        "hfrm.dec_blk_nums=[1,1]", "hfrm.middle_blk_num=1",
        "sampling.sampling_timesteps=3", "sampling.grid_r=8"]
F32 = ["parallel.compute_dtype=float32"]
RESTORE = dict(size=[64, 96], batch=2, pool=2, check_within=2,
               check_calls=1, trace_calls=2)
TRAIN = dict(size=[64, 96], batch=2, pool=8, slots=4, trace_steps=10)
SEED = 2 ** 31 + 4099


def overrides(cell):
    return RESTORE if cell.startswith("restore") else TRAIN


def tiny_run(cell, extra=(), trace=False, seed=SEED, seconds=0.3):
    torch.manual_seed(0)
    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    config_overrides=TINY + list(extra),
                    workload_overrides=overrides(cell))


def tiny_ctx(cell, extra=(), seed=SEED, device="cpu"):
    return make_ctx(cell, seed, 0.0, False, device, 0.0,
                    config_overrides=TINY + list(extra),
                    workload_overrides=overrides(cell))
