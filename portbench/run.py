"""Run one cell of the benchmark once and print its result line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of the repository.
See ``portbench/harness.py`` for what a run does and prints.
"""

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where there is
    none)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, "portbench", "_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
# one intra-op CPU thread: the card does the work, and idle OpenMP workers
# spinning beside the launching thread only add noise to its pace
os.environ["OMP_NUM_THREADS"] = "1"
if REPO not in sys.path:
    sys.path.insert(0, REPO)

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
