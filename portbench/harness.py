"""One run of one cell: set-up, the measured window, the check, the line.

``main`` refuses to run without the cards the cell asks for (exit 2, no
result).  ``run_cell`` does the rest, on any device, so the tests can
drive a whole run on the CPU:

1. the configuration file is parsed by the program's own schema, TF32 is
   set as the file's ``precision`` says, and the cell's runner
   (``runners/<runner>.py``) builds the program from the seed, warms up
   the cell's shapes and measures for ``--seconds``; with ``--trace 1``
   it then profiles a few more calls;
2. the runner frees the program and checks what the window produced
   against the plain reference (``reference/``), each number against the
   cell's limit;
3. every metric of ``BENCHMARK.json`` that this cell reports is read from
   the run's record by its reader (``metrics/<metric>.py``): the
   end-to-end ones in an untraced run, the per-layer ones in a traced run;
4. the numbers compared go to standard error, one a line, and the result
   goes to standard output as one JSON line, ``checked`` its last key; a
   traced run's line also carries the device seconds of each kernel
   family (``families``) beside the ``breakdown``.

A run whose process holds JAX, Flax, Orbax or the JAX package once the
window has closed exits 3 with no result (module names compared whole
before the first dot, so the port's own package never matches).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from portbench import registry
from portbench.lib.compare import judge
from portbench.reference.precision import float32_matmuls

__all__ = ["FORBIDDEN", "Ctx", "forbidden_modules", "make_ctx", "run_cell",
           "main"]

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "wavedm_tpu")


@dataclass
class Ctx:
    """What a runner gets: the cell, its files, the parsed configuration
    and the run's arguments."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config_file: dict
    raw: dict              # the configuration's sections, as run
    cfg: object            # the program's parse of ``raw``
    device: object
    t_start: float

    @property
    def dtype(self) -> str:
        return self.raw["parallel"]["compute_dtype"]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _peaks() -> dict:
    with open(os.path.join(registry.ROOT, "lib", "peaks.json")) as f:
        return json.load(f)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _metrics(bench: dict, cell: str, record: dict, trace: bool) -> Dict:
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = registry.metric(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def make_ctx(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: Optional[dict] = None,
             config_overrides: Sequence[str] = (),
             workload_overrides: Optional[dict] = None) -> Ctx:
    """The runner's context for one run of ``cell``.  The overrides shrink
    a cell for the tests."""
    import torch

    from wavedm_tpu_torch.config import apply_overrides, config_from_dict

    bench = registry.benchmark() if bench is None else bench
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    wl = dict(registry.workload(cell), **(workload_overrides or {}))
    conf = registry.config(entry["config"])
    raw = apply_overrides(json.loads(json.dumps(conf["config"])),
                          config_overrides)
    return Ctx(cell=cell, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), workload=wl, config_file=conf, raw=raw,
               cfg=config_from_dict(json.loads(json.dumps(raw))),
               device=torch.device(device), t_start=t_start)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, bench: Optional[dict] = None,
             config_overrides: Sequence[str] = (),
             workload_overrides: Optional[dict] = None) -> dict:
    """The result of one run of ``cell`` on ``device``."""
    import torch

    bench = registry.benchmark() if bench is None else bench
    ctx = make_ctx(cell, seed, seconds, trace, device, t_start, bench,
                   config_overrides, workload_overrides)
    wl, conf = ctx.workload, ctx.config_file
    chips = next(w for w in bench["workloads"] if w["name"] == cell)["chips"]
    float32_matmuls(conf["precision"]["tf32"])
    out = registry.runner(wl["runner"]).run(ctx)
    record = out["record"]
    record.update(kind=wl["runner"], dtype=ctx.dtype)
    on_card = ctx.device.type == "cuda"
    kind = torch.cuda.get_device_name(ctx.device) if on_card else "cpu"
    peak = _peaks().get(kind, {}).get(ctx.dtype)
    record["peak_flops"] = None if peak is None else float(peak)
    ok, rows = judge(out["numbers"], wl["limits"])
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": chips if on_card else 1,
                   "memory_peak_bytes": int(record["peak_mem_bytes"])}
    if trace:
        device_info.update(busy_s=record["trace"]["busy_s"],
                           window_s=record["trace"]["window_s"])
    if on_card:
        device_info["card"] = _power_limit()
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": _metrics(bench, cell, record, trace),
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}
        result["families"] = sorted(record["trace"]["family_s"].items(),
                                    key=lambda kv: -kv[1])
    result["checked"] = {name: {"value": v, "limit": lim}
                         for name, v, lim in rows}
    result["where"] = out.get("where", {})
    return result


def main(argv: Sequence[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    bench = registry.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell named {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"cell {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start, bench)
    held = forbidden_modules()
    if held:
        print(f"the run loaded {', '.join(held)}: the benchmark measures "
              "the PyTorch port alone", file=sys.stderr)
        return 3
    where = result.pop("where")
    for name, c in result["checked"].items():
        at = f" (leaf {where[name]})" if name in where else ""
        print(f"check {name} {c['value']!r} limit {c['limit']!r}{at}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
