"""host_ms_per_step.train: the mean host time of a step that starts right
after a loss read (an idle card and an empty launch queue), until the
step returns."""

import statistics


def read(rec):
    if rec["kind"] != "train":
        return None
    return 1e3 * statistics.fmean(rec["host_s"])
