"""PyTorch port: patch-parallel serving (``cli/serve.py --patch-shard``) over
gloo on the CPU, a world of 2 against a world of 1.

Each world runs the CLI as ``torchrun`` would start it, one process a rank
(``parallel/launch.py``).  Rank 0 serves HTTP on 127.0.0.1 and a client
thread in it posts the requests one at a time, then interrupts the server
as Ctrl-C does; the other rank follows each chain and leaves when rank 0's
server stops.  Both worlds restore the same requests from the same seeded
weights and x_T (rank 0's), so the replies agree within one uint8 level
(the split patch sum rounds in another order).
"""

import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

from wavedm_tpu_torch.parallel.launch import World
from wavedm_tpu_torch.utils.images import decode_png, encode_png

TINY = ("model.ch=32", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
        "model.attn_resolutions=[4]", "data.image_size=8",
        "data.patch_size=32", "hfrm.dim=8", "hfrm.enc_blk_nums=[1,1]",
        "hfrm.dec_blk_nums=[1,1]", "hfrm.middle_blk_num=1",
        "sampling.sampling_timesteps=2", "sampling.grid_r=8")
ARGV = ["--config", "production", "--device", "cpu", "--resume", "",
        "--host", "127.0.0.1", "--port", "0", "--batch", "1", "--no-resize",
        "--warmup", "--patch-shard"] + [a for ov in TINY for a in ("--set",
                                                                    ov)]


def serve_rank(argv, bodies):
    """``cli.serve.main(argv)`` on this rank; rank 0 also posts ``bodies``
    to its own server, then interrupts it.  Returns the exit code and, on
    rank 0, the replies."""
    import torch
    import torch.distributed as dist

    from wavedm_tpu_torch.cli import serve as cli
    from wavedm_tpu_torch.inference import server as server_mod

    torch.set_num_threads(1)
    replies, bound = [], []
    serve = server_mod.RestorationServer.serve

    def recording_serve(self, host, port):
        httpd = serve(self, host, port)
        bound.append(httpd.server_address[1])
        return httpd

    server_mod.RestorationServer.serve = recording_serve

    def client():
        while not bound:
            time.sleep(0.05)
        for body in bodies:
            req = urllib.request.Request(
                f"http://127.0.0.1:{bound[0]}/restore", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                replies.append(r.read())
        os.kill(os.getpid(), signal.SIGINT)      # Ctrl-C

    if dist.get_rank() == 0:
        threading.Thread(target=client, daemon=True).start()
    return {"rc": cli.main(argv), "replies": replies}


def _png(seed):
    img = np.random.default_rng(seed).integers(0, 256, (32, 48, 3),
                                               dtype=np.uint8)
    return encode_png(img)


@pytest.fixture(scope="module")
def worlds():
    bodies = [_png(s) for s in (1, 2)]
    kw = dict(device="cpu", threads=1, deadline=240.0)
    one = World(f"{__name__}:serve_rank", 1, (ARGV, bodies), **kw)
    two = World(f"{__name__}:serve_rank", 2, (ARGV, bodies), **kw)
    return one.join(), two.join()


def test_patch_shard_at_world2_replies_as_world1(worlds):
    one, two = worlds
    assert len(one[0]["replies"]) == len(two[0]["replies"]) == 2
    for a, b in zip(one[0]["replies"], two[0]["replies"]):
        x = decode_png(a, "world 1").astype(int)
        y = decode_png(b, "world 2").astype(int)
        assert x.shape == y.shape == (32, 48, 3)
        assert int(np.abs(x - y).max()) <= 1


def test_every_rank_leaves_when_rank0_stops(worlds):
    one, two = worlds
    assert [r["rc"] for r in one + two] == [0, 0, 0]
    assert two[1]["replies"] == []          # the follower serves no HTTP


def test_serve_refuses_several_processes_without_patch_shard():
    argv = [a for a in ARGV if a != "--patch-shard"]
    with pytest.raises(RuntimeError, match="pass --patch-shard"):
        World(f"{__name__}:serve_rank", 2, (argv, []), device="cpu",
              threads=1, deadline=120.0).join()



class _Mesh:
    """A mesh of two ranks in one process: ``broadcast`` records what it
    is given and hands the int64 headers out of ``heads`` in turn."""
    size = 2

    def __init__(self, rank, heads=()):
        import torch
        self.rank, self.sent = rank, []
        self.heads = [torch.tensor(h, dtype=torch.int64) for h in heads]

    def broadcast(self, t):
        import torch
        if t.dtype == torch.int64 and self.heads:
            t.copy_(self.heads.pop(0))
        self.sent.append(t.clone())


class _FailingRestorer:
    device = "cpu"

    def __init__(self, mesh):
        self.mesh = mesh

    def restore_image(self, batch, generator=None):
        raise RuntimeError("out of memory")

    restore_image_device = restore_image


def test_a_follower_whose_chain_fails_raises():
    """A follower that fails inside a chain raises out of ``follow()``
    (its launcher then ends the world) rather than waiting for the next
    header while rank 0 is still inside the chain's collectives."""
    from wavedm_tpu_torch.inference.server import _RUN, _STOP, RestorationServer

    mesh = _Mesh(1, heads=[(_RUN, 1, 2, 2), (_STOP, 0, 0, 0)])
    server = RestorationServer(_FailingRestorer(mesh), batch=1)
    with pytest.raises(RuntimeError, match="out of memory"):
        server.follow()
    assert len(mesh.heads) == 1             # the stop header never read


def test_a_failed_batch_on_rank0_stops_the_patch_parallel_server():
    """Rank 0's failed batch fails its requests, stops the device owner and
    the HTTP server without a stop header (the followers may be inside the
    chain), keeps the error in ``failed``, and refuses later requests."""
    from wavedm_tpu_torch.inference.server import (_RUN, RestorationServer,
                                                   _Request)

    mesh = _Mesh(0)
    server = RestorationServer(_FailingRestorer(mesh), batch=1,
                               window_ms=1.0)
    httpd = server.serve("127.0.0.1", 0)
    http = threading.Thread(target=httpd.serve_forever, daemon=True)
    http.start()
    req = _Request(np.zeros((2, 2, 3), np.float32))
    server.batcher.submit(req)
    assert req.done.wait(30)
    assert "out of memory" in req.error
    server._worker.join(30)
    http.join(30)
    assert not server._worker.is_alive() and not http.is_alive()
    httpd.server_close()
    assert isinstance(server.failed, RuntimeError)
    assert [int(t[0]) for t in mesh.sent if t.ndim == 1] == [_RUN]
    with pytest.raises(RuntimeError, match="stopped after a failed batch"):
        server.restore_bytes(_png(3))
