"""chain_host_ms.restore: the host time of a traced restore call's
sampling steps outside the UNet and the syncs, per call: the sum over its
``chain.step`` spans of their duration less their ``unet`` spans' host
time and their ``sync.*`` spans (the gather, the scatter-mean, the reverse
step and the launches between them).  It carries the profiler's own host
cost, as every traced metric does."""

from portbench.metrics._program_spans import mean, restore_calls


def read(rec):
    got = restore_calls(rec)
    if got is None:
        return None
    return mean(sum(ms - sync for ms, sync in c["spans"]["chain.step"])
                - sum(ms - sync for ms, sync in c["spans"]["unet"])
                for c in got)
