"""unet_host_ms.restore: the host time of one UNet call in a traced
restore call, the mean duration of the program's ``unet`` spans (one a
model call or micro-batch) less the ``sync.*`` spans inside them.  It
carries the profiler's own host cost, as every traced metric does."""

from portbench.metrics._program_spans import mean, restore_calls


def read(rec):
    got = restore_calls(rec)
    if got is None:
        return None
    return mean(ms - sync for c in got for ms, sync in c["spans"]["unet"])
