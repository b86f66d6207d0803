"""sync_wait_ms.restore: the time a traced restore call blocks the host
until the card catches up, per call: the sum of its ``sync.*`` spans
(each point where the program waits on the card; PERF.md lists them).  It
carries the profiler's own host cost, as every traced metric does."""

from portbench.metrics._program_spans import mean, restore_calls


def read(rec):
    got = restore_calls(rec)
    if got is None:
        return None
    return mean(c["sync_ms"] for c in got)
