"""entry_host_ms.restore: the host time of a traced restore call outside
its sampling steps and its syncs, per call: the ``restore`` span less its
``chain.step`` spans and less the ``sync.*`` spans outside them (the
HFRM, the wavelet transforms, x_T and the output).  With
``unet_host_ms.restore`` times the UNet calls, ``chain_host_ms.restore``
and ``sync_wait_ms.restore`` it makes up the ``restore`` span.  It carries
the profiler's own host cost, as every traced metric does."""

from portbench.metrics._program_spans import mean, restore_calls


def read(rec):
    got = restore_calls(rec)
    if got is None:
        return None
    return mean(c["ms"] - c["sync_ms"]
                - sum(ms - sync for ms, sync in c["spans"]["chain.step"])
                for c in got)
