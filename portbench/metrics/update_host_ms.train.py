"""update_host_ms.train: the host time of a traced train step's update,
per step: its ``train.update`` spans (the gradient norm, the optimizer's
step and the EMA).  It carries the profiler's own host cost, as every
traced metric does."""

from portbench.metrics._program_spans import mean, train_steps


def read(rec):
    got = train_steps(rec)
    if got is None:
        return None
    return mean(sum(ms for ms, _ in c["spans"]["train.update"])
                for c in got)
