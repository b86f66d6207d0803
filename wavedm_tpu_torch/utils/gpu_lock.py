"""Single-flight lock for each local CUDA card.

The port's counterpart of ``wavedm_tpu/utils/tpu_lock.py``: every entry
point that runs on the card (the ``serve``, ``restore``, ``eval_diffusion``,
``train_diffusion`` and ``train_hfrm`` CLIs) takes this advisory ``flock``
before it builds anything there, so two of them never share a card by
accident.  There is one lock a card, keyed by the device's index: the
ranks of a ``torchrun`` world each take their own card's, so none waits on
another's while that one waits for it in the rendezvous.

* the CLIs block until the card is free, printing the holder's note every
  minute;
* with a ``timeout`` the call gives up and returns False, and the caller
  decides whether to go on;
* shell pipelines interoperate: ``flock <path> -c '...'`` locks the same
  file with the same fcntl semantics.

The lock is taken only when the resolved device is CUDA: runs on the CPU
(the tests) never contend for it.  It is re-entrant per process (later
calls return True at once) and held until the process exits.

Env knobs: ``WAVEDM_GPU_LOCK`` (card 0's path, default ``wavedm_gpu.lock``
in the temporary directory; card k's is that path with ``.k`` appended),
``WAVEDM_GPU_LOCK_DISABLE=1`` (skip entirely).
"""

from __future__ import annotations

import atexit
import fcntl
import os
import sys
import tempfile
import time

import torch

from wavedm_tpu_torch.utils.device import resolve_device

__all__ = ["lock_path", "acquire_gpu_lock", "release_gpu_lock"]

_held = {}  # path -> open fd (kept for the process's lifetime)


def lock_path(index: int = 0) -> str:
    """The lock file of card ``index``."""
    base = os.environ.get("WAVEDM_GPU_LOCK",
                          os.path.join(tempfile.gettempdir(),
                                       "wavedm_gpu.lock"))
    return base if index == 0 else f"{base}.{index}"


def _card_index(device: torch.device) -> int:
    if device.index is not None:
        return device.index
    return torch.cuda.current_device() if torch.cuda.is_available() else 0


def _holder_note(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()[:200]
    except OSError:
        return "?"


def acquire_gpu_lock(name: str, device=None, timeout: float | None = None,
                     poll: float = 5.0, verbose: bool = True) -> bool:
    """Take the lock of the card ``device`` names (the card when None, the
    current one for a bare ``cuda``; raises, as ``resolve_device`` does,
    when there is none) and hold it until the process exits.

    A device that is not CUDA takes no lock and returns True.  Blocks up
    to ``timeout`` seconds (``None`` = for ever); returns True when
    acquired, False on timeout."""
    device = resolve_device(device)
    if device.type != "cuda":
        return True
    if os.environ.get("WAVEDM_GPU_LOCK_DISABLE") == "1":
        return True
    path = lock_path(_card_index(device))
    if path in _held:
        return True
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
    t0 = time.time()
    last_note = 0.0
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            break
        except OSError:
            waited = time.time() - t0
            if timeout is not None and waited >= timeout:
                os.close(fd)
                if verbose:
                    print(f"gpu_lock: {name}: gave up after {waited:.0f}s "
                          f"(holder: {_holder_note(path)})", file=sys.stderr)
                return False
            if verbose and time.time() - last_note > 60:
                print(f"gpu_lock: {name}: waiting for the card "
                      f"({waited:.0f}s; holder: {_holder_note(path)})",
                      file=sys.stderr)
                last_note = time.time()
            time.sleep(poll)
    os.ftruncate(fd, 0)
    os.write(fd, f"pid={os.getpid()} name={name} "
                 f"since={time.strftime('%FT%TZ', time.gmtime())}\n".encode())
    os.fsync(fd)
    _held[path] = fd
    atexit.register(release_gpu_lock)
    return True


def release_gpu_lock() -> None:
    for path, fd in list(_held.items()):
        try:
            os.ftruncate(fd, 0)
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)
        except OSError:
            pass
        _held.pop(path, None)
