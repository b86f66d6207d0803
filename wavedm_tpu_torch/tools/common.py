"""What the tools share: where their outputs go by default, and the
in-process run of an entry point with its standard output kept in a log.

Every default output lies under ``results/torch/`` (ignored by git), so no
tool writes over a file the repository holds.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = ["out_path", "run_logged", "grep"]


def out_path(*parts: str) -> str:
    """A default output path under ``results/torch/``."""
    return os.path.join("results", "torch", *parts)


class _Tee:
    """A text stream that writes to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self) -> None:
        for s in self.streams:
            s.flush()


def run_logged(main: Callable[[Optional[List[str]]], int],
               argv: Sequence[str], full_log: str) -> Tuple[int, str]:
    """``main(argv)`` in this process, its standard output shown as it
    comes and written to ``full_log``; returns (exit code, the output).
    An exception is written to the log and raised again."""
    os.makedirs(os.path.dirname(full_log) or ".", exist_ok=True)
    with open(full_log, "w") as f:
        try:
            with contextlib.redirect_stdout(_Tee(sys.stdout, f)):
                rc = main(list(argv))
        except BaseException as e:
            f.write(f"{type(e).__name__}: {e}\n")
            raise
    with open(full_log) as f:
        return rc, f.read()


def grep(text: str, pattern: str) -> str:
    """The lines of ``text`` that match ``pattern`` (``grep -E``)."""
    rx = re.compile(pattern)
    return "".join(line + "\n" for line in text.splitlines()
                   if rx.search(line))
