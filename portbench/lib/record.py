"""A run's record under a kind of the runner's choosing.

The harness names a record's kind after its runner (``record["kind"] =
the workload's "runner"``), and the metrics read a kind ("restore",
"train").  A runner that drives the same kind of run as another, on
another path, returns a :class:`Record`, which keeps the kind it was
made with, so every metric of that kind reads it."""

from __future__ import annotations

__all__ = ["Record"]


class Record(dict):
    """``Record(kind, **fields)``: a dict whose ``kind`` an ``update``
    leaves as made."""

    def __init__(self, kind: str, **fields):
        super().__init__(fields, kind=kind)
        self._kind = kind

    def update(self, *args, **kwargs) -> None:
        super().update(*args, **kwargs)
        self["kind"] = self._kind
