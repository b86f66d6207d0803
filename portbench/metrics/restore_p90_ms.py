"""restore_p90_ms: the 90th percentile of every window call's wall time,
from the call to its ``torch.cuda.synchronize()``."""

from portbench.lib.stats import percentile


def read(rec):
    if rec["kind"] != "restore":
        return None
    return 1e3 * percentile(rec["call_s"], 90)
