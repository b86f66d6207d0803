"""host_ms_per_call.restore: the mean host time of a window call, from
the call until it returns (every call starts on an idle card)."""

import statistics


def read(rec):
    if rec["kind"] != "restore":
        return None
    return 1e3 * statistics.fmean(rec["host_s"])
