"""PyTorch port: the card's single-flight lock (``utils/gpu_lock.py``),
mirroring ``tests/test_tpu_lock.py``.

The lock is taken only for a CUDA device; this host has no card, so the
tests that take it pretend the device resolves to CUDA.  They use a
private lock path, never the default one.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from wavedm_tpu_torch.utils import gpu_lock
from wavedm_tpu_torch.utils.gpu_lock import acquire_gpu_lock, release_gpu_lock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def lock_file(tmp_path, monkeypatch):
    path = tmp_path / "card.lock"
    monkeypatch.setenv("WAVEDM_GPU_LOCK", str(path))
    monkeypatch.delenv("WAVEDM_GPU_LOCK_DISABLE", raising=False)
    yield path
    release_gpu_lock()


@pytest.fixture
def as_cuda(monkeypatch):
    monkeypatch.setattr(gpu_lock, "resolve_device",
                        lambda device=None: torch.device("cuda"))


def test_exclusion_and_handoff(lock_file, as_cuda, tmp_path):
    ready = tmp_path / "ready"
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time, torch; sys.path.insert(0, sys.argv[1]);"
         "from wavedm_tpu_torch.utils import gpu_lock;"
         "gpu_lock.resolve_device = lambda d=None: torch.device('cuda');"
         "assert gpu_lock.acquire_gpu_lock('holder');"
         f"open({str(ready)!r}, 'w').write('1'); time.sleep(5)", REPO],
        env=dict(os.environ))
    try:
        for _ in range(300):
            if ready.exists():
                break
            time.sleep(0.1)
        assert ready.exists(), "holder never acquired"
        assert "name=holder" in lock_file.read_text()
        assert not acquire_gpu_lock("t", timeout=1, poll=0.2, verbose=False)
        assert acquire_gpu_lock("t", timeout=30, poll=0.2, verbose=False)
        assert "name=t" in lock_file.read_text()
    finally:
        holder.wait(60)


def test_reentrant_and_disable(lock_file, as_cuda, monkeypatch):
    assert acquire_gpu_lock("a", timeout=5, verbose=False)
    assert acquire_gpu_lock("a-again", timeout=0, verbose=False)
    assert "name=a " in lock_file.read_text()
    release_gpu_lock()
    assert lock_file.read_text() == ""
    monkeypatch.setenv("WAVEDM_GPU_LOCK_DISABLE", "1")
    assert acquire_gpu_lock("noop", timeout=0, verbose=False)
    assert not gpu_lock._held and lock_file.read_text() == ""


def test_not_taken_for_the_cpu(lock_file):
    assert acquire_gpu_lock("cpu run", device="cpu", timeout=0)
    assert not gpu_lock._held and not lock_file.exists()


def test_no_card_and_no_device_raises(lock_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acquire_gpu_lock("serve")
    assert not lock_file.exists()


def test_one_lock_a_card(lock_file, monkeypatch, tmp_path):
    """Card 1's lock is its own file: a holder of card 0's (another
    process, as another rank of a torchrun world would be) keeps card 0
    from this process and leaves card 1 free."""
    assert gpu_lock.lock_path(0) == str(lock_file)
    assert gpu_lock.lock_path(1) == f"{lock_file}.1"
    ready = tmp_path / "ready"
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, time, torch; sys.path.insert(0, sys.argv[1]);"
         "from wavedm_tpu_torch.utils import gpu_lock;"
         "gpu_lock.resolve_device = lambda d=None: torch.device('cuda', 0);"
         "assert gpu_lock.acquire_gpu_lock('rank0');"
         f"open({str(ready)!r}, 'w').write('1'); time.sleep(5)", REPO],
        env=dict(os.environ))
    try:
        for _ in range(300):
            if ready.exists():
                break
            time.sleep(0.1)
        assert ready.exists(), "holder never acquired"
        monkeypatch.setattr(gpu_lock, "resolve_device",
                            lambda device=None: torch.device(device))
        assert acquire_gpu_lock("rank1", "cuda:1", timeout=0, verbose=False)
        assert "name=rank1" in open(f"{lock_file}.1").read()
        assert "name=rank0" in lock_file.read_text()
        assert not acquire_gpu_lock("t", "cuda:0", timeout=1, poll=0.2,
                                    verbose=False)
    finally:
        holder.wait(60)
