"""Start a world of ranks on this machine and collect what each returns.

``World("pkg.module:function", world, args)`` runs ``function(*args)`` in
``world`` fresh Python processes, each a rank of one process group joined
through :func:`initialize_multihost` with ``torchrun``'s environment
variables set; its ``join()`` returns the ranks' return values in rank
order.  It is how the tests (gloo on the CPU) and ``chip_smoke.py`` (the
card) run the multi-process paths without ``torchrun``:

- the rendezvous is a file in a temporary directory (``file://``), so two
  worlds started at once never contend for a port; ``rendezvous="env"``
  takes torchrun's own path instead (``MASTER_ADDR`` 127.0.0.1 and a free
  port);
- a rank that raises makes :meth:`World.join` kill the others and raise
  its traceback in the caller; past the deadline every rank is killed and
  ``TimeoutError`` raised, so no rank outlives the call;
- :meth:`World.join` returns once every rank has written its result and
  kills those still leaving their group (a card's teardown takes seconds
  and does nothing the caller waits for);
- arguments and results travel as ``torch.save`` files in that directory.

    python -m wavedm_tpu_torch.parallel.launch <dir> <rank>

is the rank's side.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch

__all__ = ["World"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``world`` ranks running ``target`` (``"module:function"``); started
    by the constructor, collected by :meth:`join`."""

    def __init__(self, target: str, world: int, args: Sequence = (), *,
                 device=None, backend: Optional[str] = None,
                 deadline: float = 300.0, rendezvous: str = "file",
                 threads: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None):
        self.world = world
        self.dir = tempfile.mkdtemp(prefix="wavedm_world_")
        self.deadline = time.monotonic() + deadline
        init = (f"file://{os.path.join(self.dir, 'rendezvous')}"
                if rendezvous == "file" else "env://")
        torch.save({"target": target, "args": tuple(args),
                    "device": None if device is None else str(device),
                    "backend": backend, "init_method": init,
                    "threads": threads, "timeout_s": deadline},
                   os.path.join(self.dir, "spec.pt"))
        base = dict(os.environ, **(env or {}))
        # the ranks import what the caller can
        base["PYTHONPATH"] = os.pathsep.join(
            p for p in [os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))] + sys.path if p)
        base.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(_free_port()))
        if threads:
            base["OMP_NUM_THREADS"] = str(threads)
        self.procs = []
        for rank in range(world):
            rank_env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
            # -X faulthandler: a rank that crashes prints its stack
            self.procs.append(subprocess.Popen(
                [sys.executable, "-X", "faulthandler", "-m",
                 "wavedm_tpu_torch.parallel.launch", self.dir, str(rank)],
                env=rank_env))

    def close(self) -> None:
        """Kill every rank still running (the ranks of a joined world have
        all ended)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self) -> List[Any]:
        """Wait for every rank's result; their return values in rank
        order."""
        outs = [os.path.join(self.dir, f"out{r}.pt")
                for r in range(self.world)]
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                # a rank that raised may still be leaving its group
                failed = [r for r, c in enumerate(codes)
                          if c not in (None, 0) or os.path.exists(
                              os.path.join(self.dir, f"error{r}.txt"))]
                if failed:
                    self.close()
                    # the first rank to raise: the others fail after it
                    errs = {r: os.path.join(self.dir, f"error{r}.txt")
                            for r in range(self.world)}
                    raised = [r for r in errs if os.path.exists(errs[r])]
                    r = (min(raised, key=lambda r: os.path.getmtime(errs[r]))
                         if raised else failed[0])
                    path = errs[r]
                    tb = (open(path).read() if os.path.exists(path)
                          else f"exit code {codes[r]}")
                    raise RuntimeError(f"rank {r} of {self.world} failed:\n"
                                       f"{tb}")
                if all(map(os.path.exists, outs)):
                    return [torch.load(path, weights_only=False)
                            for path in outs]
                if time.monotonic() > self.deadline:
                    self.close()
                    raise TimeoutError(
                        f"a world of {self.world} ranks passed its deadline")
                time.sleep(0.05)
        finally:
            self.close()
            shutil.rmtree(self.dir, ignore_errors=True)


def _rank_main(directory: str, rank: int) -> int:
    import importlib

    from wavedm_tpu_torch.parallel.distributed import initialize_multihost

    spec = torch.load(os.path.join(directory, "spec.pt"), weights_only=False)
    try:
        if spec["threads"]:
            torch.set_num_threads(spec["threads"])
        initialize_multihost(spec["backend"], spec["device"],
                             spec["init_method"], spec["timeout_s"])
        module, name = spec["target"].split(":")
        out = getattr(importlib.import_module(module), name)(*spec["args"])
        tmp = os.path.join(directory, f"out{rank}.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(directory, f"out{rank}.pt"))
    except Exception:
        tmp = os.path.join(directory, f"error{rank}.tmp")
        with open(tmp, "w") as f:
            f.write(traceback.format_exc())
        os.replace(tmp, os.path.join(directory, f"error{rank}.txt"))
        return 1
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
