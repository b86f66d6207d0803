"""prepare_host_ms.train: the host time of a traced train step's batch
preparation, per step: its ``train.prepare`` spans (the crops to the
wavelet batch, with the frozen HFRM's forward where the configuration
conditions on it).  It carries the profiler's own host cost, as every
traced metric does."""

from portbench.metrics._program_spans import mean, train_steps


def read(rec):
    got = train_steps(rec)
    if got is None:
        return None
    return mean(sum(ms for ms, _ in c["spans"]["train.prepare"])
                for c in got)
