"""fwd_bwd_host_ms.train: the host time of a traced train step's forward
and backward, per step: its ``train.forward`` (the UNet and the loss) and
``train.backward`` spans.  It carries the profiler's own host cost, as
every traced metric does."""

from portbench.metrics._program_spans import mean, train_steps


def read(rec):
    got = train_steps(rec)
    if got is None:
        return None
    return mean(sum(ms for name in ("train.forward", "train.backward")
                    for ms, _ in c["spans"][name]) for c in got)
