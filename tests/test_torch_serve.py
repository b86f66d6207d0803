"""PyTorch port: the serving stack against the JAX package's
(``wavedm_tpu/inference/server.py``), on the CPU at a tiny size.

- The microbatching policy: the port's ``Microbatcher`` forms the same
  groups as JAX's on the same submission sequences.
- The request side: ``_decode`` of the same PNG bytes equals JAX's
  PIL-based ``_decode`` exactly (RGB, grey, RGBA; a LANCZOS resize to
  720x480 and a /16 round-up under ``no_resize``).
- The reply side: the port's PNG reply decodes (with PIL) to the same
  uint8 image as JAX's reply for the same restored array.
- End to end: a float32 served reply is within one uint8 level of JAX's
  served reply for the same PNG, weights (``utils/convert.py``) and x_T.
  The two servers draw x_T from different RNGs (a torch generator, JAX
  keys), so a test-only adapter hands the port's restorer the x_T of JAX's
  key path for the first batch; the server itself is unchanged.
- Mirrors of ``tests/test_serve.py``: HTTP round trip with concurrent
  posts, ``/healthz``, a bad request answered 500 with the loop surviving,
  padding to the fixed batch; and ``cli.serve``'s refusals.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.inference import server as jax_server
from wavedm_tpu.inference.restoration import \
    DiffusiveRestoration as JaxRestoration
from wavedm_tpu.models.hfrm import HFRM as JaxHFRM
from wavedm_tpu.models.unet import DiffusionUNet as JaxUNet

from wavedm_tpu_torch.cli import serve as serve_cli
from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.inference import server
from wavedm_tpu_torch.inference.loader import build_restorer
from wavedm_tpu_torch.utils.convert import (hfrm_state_dict_from_flax,
                                            unet_state_dict_from_flax)
from wavedm_tpu_torch.utils.images import decode_png

SEED = 61
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = {
    "data": {"image_size": 8, "patch_size": 32},
    "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
              "attn_resolutions": [4]},
    "diffusion": {"num_diffusion_timesteps": 50},
    "hfrm": {"dim": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
             "dec_blk_nums": [1, 1]},
    "training": {"seed": SEED},
    "sampling": {"sampling_timesteps": 3, "grid_r": 4},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the suite runs several pytest-xdist workers on
    a few cores, where small ops on a thread per core run ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _pil_decode(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


# ------------------------------------------------------------ microbatcher

SEQUENCES = {
    "one_shape": (4, [(8, 8, 3)] * 3),
    "overflow": (2, [(8, 8, 3)] * 5),
    "mixed_oldest_first": (8, [(8, 8, 3), (16, 16, 3), (8, 8, 3)]),
    "mixed_overflow": (2, [(8, 8, 3), (16, 16, 3), (8, 8, 3), (8, 8, 3),
                           (16, 16, 3), (8, 8, 3), (16, 16, 3)]),
}


def _groups(module, batch, shapes):
    """The request indices of each batch ``collect`` returns, until empty."""
    mb = module.Microbatcher(batch=batch, window_ms=20)
    for i, shape in enumerate(shapes):
        mb.submit(module._Request(np.full(shape, i, np.float32)))
    out = []
    while True:
        reqs = mb.collect(timeout=0.05)
        if not reqs:
            return out
        out.append([int(r.arr.flat[0]) for r in reqs])


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_microbatcher_groups_match_jax(name):
    batch, shapes = SEQUENCES[name]
    ours = _groups(server, batch, shapes)
    assert ours == _groups(jax_server, batch, shapes)
    assert sorted(i for g in ours for i in g) == list(range(len(shapes)))
    assert all(len({shapes[i] for i in g}) == 1 for g in ours)


# ----------------------------------------------------------- decode/encode

def _image(mode, h, w):
    rng = np.random.default_rng(h * 1000 + w)
    channels = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return arr[..., 0] if channels == 1 else arr


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
@pytest.mark.parametrize("h,w,no_resize", [(37, 50, False), (27, 40, True),
                                           (32, 48, True)],
                         ids=["lanczos_to_720x480", "round_up_to_16",
                              "native"])
def test_decode_equals_jax(mode, h, w, no_resize):
    body = _png(_image(mode, h, w))
    ours = server.RestorationServer(None, no_resize=no_resize)._decode(body)
    theirs = jax_server.RestorationServer(None, no_resize=no_resize)._decode(
        body)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)


def test_decode_refuses_what_is_not_png():
    """A GIF body, once refused, is taken as JAX's PIL takes it; a body
    that is no image is refused naming the request body and why (JPEG,
    BMP, WebP and TIFF: ``test_decode_takes_jpeg_palette_and_bmp_as_jax``,
    ``test_decode_takes_pil_formats_as_jax``)."""
    buf = io.BytesIO()
    Image.fromarray(_image("RGB", 8, 8)).save(buf, "GIF")
    srv = server.RestorationServer(None)
    assert np.array_equal(srv._decode(buf.getvalue()),
                          jax_server.RestorationServer(None)._decode(
                              buf.getvalue()))
    with pytest.raises(ValueError, match="PIL cannot identify it") as err:
        srv._decode(b"not an image")
    assert "request body" in str(err.value)


PIL_FORMATS = {"webp_lossy": ("WEBP", {"quality": 80}),
               "webp_lossless": ("WEBP", {"lossless": True}),
               "webp_rgba": ("WEBP", {"lossless": True}),
               "gif": ("GIF", {}), "tiff": ("TIFF", {})}


def _encoded(fmt):
    """A 32x48 RainDrop crop as ``fmt``: a JPEG, a palette PNG, a BMP, or
    one of ``PIL_FORMATS``."""
    img = decode_png(open(os.path.join(
        REPO, "data", "raindrop", "raindrop_test", "input", "0000.png"),
        "rb").read())[200:232, 300:348]
    buf = io.BytesIO()
    if fmt == "palette":
        Image.fromarray(img).convert("P", palette=Image.ADAPTIVE).save(
            buf, "PNG")
    elif fmt in PIL_FORMATS:
        name, kw = PIL_FORMATS[fmt]
        if fmt == "webp_rgba":
            img = np.dstack([img, np.arange(32 * 48, dtype=np.uint8)
                             .reshape(32, 48)])
        Image.fromarray(img).save(buf, name, **kw)
    else:
        Image.fromarray(img).save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["JPEG", "palette", "BMP"])
@pytest.mark.parametrize("no_resize", [False, True],
                         ids=["lanczos_to_720x480", "native"])
def test_decode_takes_jpeg_palette_and_bmp_as_jax(fmt, no_resize):
    """The port's ``_decode`` of a JPEG (the data library), a palette PNG
    and a BMP body equals JAX's PIL ``_decode``, resized or not."""
    body = _encoded(fmt)
    ours = server.RestorationServer(None, no_resize=no_resize)._decode(body)
    theirs = jax_server.RestorationServer(None, no_resize=no_resize)._decode(
        body)
    assert ours.dtype == theirs.dtype == np.float32
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("fmt", list(PIL_FORMATS))
@pytest.mark.parametrize("no_resize", [False, True],
                         ids=["lanczos_to_720x480", "native"])
def test_decode_takes_pil_formats_as_jax(fmt, no_resize):
    """WebP (lossy, lossless, RGBA), GIF and TIFF bodies: the port's
    ``_decode`` through PIL equals JAX's, resized or not."""
    body = _encoded(fmt)
    ours = server.RestorationServer(None, no_resize=no_resize)._decode(body)
    theirs = jax_server.RestorationServer(None, no_resize=no_resize)._decode(
        body)
    assert ours.dtype == theirs.dtype == np.float32
    assert np.array_equal(ours, theirs)


class FixedRestorer:
    """Returns ``out`` for whatever batch it is given (either package's
    calling convention)."""

    def __init__(self, out):
        self.out = out

    def restore_image(self, batch, rng=None, generator=None):
        return np.repeat(self.out[None], len(batch), axis=0), None


def test_reply_decodes_to_jax_reply():
    """The same restored array, out of range and on rounding boundaries
    included, encodes to PNG bytes that decode to the same uint8."""
    rng = np.random.default_rng(0)
    out = rng.uniform(-0.1, 1.1, (16, 24, 3)).astype(np.float32)
    out[0, :10, 0] = (np.arange(10) + 0.5) / 255.0
    body = _png(_image("RGB", 16, 24))
    replies = []
    for module in (server, jax_server):
        srv = module.RestorationServer(FixedRestorer(out), batch=2,
                                       window_ms=5, no_resize=True)
        srv.start()
        try:
            replies.append(_pil_decode(srv.restore_bytes(body, timeout=60)))
        finally:
            srv.stop()
    assert replies[0].dtype == np.uint8 and replies[0].shape == (16, 24, 3)
    assert np.array_equal(replies[0], replies[1])
    assert np.array_equal(decode_png(_png(replies[0])), replies[0])


def test_device_loop_pads_to_fixed_batch():
    """Short batches are padded to the fixed batch before the restorer
    sees them; padding rows are not counted as served."""
    seen = []

    class Echo:
        def restore_image(self, batch, generator=None):
            seen.append((batch.shape, generator.device.type))
            return batch, None

    srv = server.RestorationServer(Echo(), batch=4, window_ms=20)
    srv.start()
    req = server._Request(np.full((8, 8, 3), 0.25, np.float32))
    srv.batcher.submit(req)
    assert req.done.wait(10)
    srv.stop(timeout=10)
    assert not srv._worker.is_alive()
    assert req.error is None
    assert seen == [((4, 8, 8, 3), "cpu")]        # padded 1 -> 4
    np.testing.assert_allclose(req.out, req.arr)
    assert srv.stats["served"] == 1
    assert srv.stats["last_batch_size"] == 1


# --------------------------------------------------------------- vs JAX

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config_from_dict(RAW)
    uparams = jax.jit(JaxUNet.from_config(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 96)),
        jnp.zeros((1,)))["params"]
    hparams = jax.jit(JaxHFRM.from_config(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 48, 3)))["params"]
    rng = np.random.default_rng(4)
    hparams = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(0.5 * rng.standard_normal(v.shape),
                                    v.dtype)
        if path[-1].key in ("beta", "gamma") else v, hparams)
    return uparams, hparams


class JaxKeyPathRestorer:
    """Test-only: the port's restorer given the x_T that JAX's server
    draws for its first batch (``split(PRNGKey(seed))`` per batch, then
    ``prep``'s own split), in place of the server's generator draw."""

    def __init__(self, restorer, seed):
        self.restorer, self.device = restorer, restorer.device
        _, sub = jax.random.split(jax.random.PRNGKey(seed))
        self.key_init, _ = jax.random.split(sub)

    def restore_image(self, batch, generator=None):
        b, h, w, _ = batch.shape
        noise = np.asarray(jax.random.normal(self.key_init,
                                             (b, h // 4, w // 4, 3)))
        return self.restorer.restore_image(
            batch, noise=torch.from_numpy(noise.transpose(0, 3, 1, 2).copy()),
            generator=generator)


def test_float32_served_reply_matches_jax(weights):
    uparams, hparams = weights
    jcfg, cfg = jax_config_from_dict(RAW), config_from_dict(RAW)
    jrest = JaxRestoration(jcfg, JaxUNet.from_config(jcfg).apply, uparams,
                           JaxHFRM.from_config(jcfg).apply, hparams)
    rest = build_restorer(cfg, unet_state_dict_from_flax(uparams, 2, 1),
                          hfrm_state_dict_from_flax(hparams, (1, 1), 1,
                                                    (1, 1)), device="cpu")
    body = _png(_image("RGB", 32, 48))
    replies = []
    for srv in (
            server.RestorationServer(JaxKeyPathRestorer(rest, SEED), batch=2,
                                     window_ms=5, no_resize=True,
                                     rng_seed=SEED),
            jax_server.RestorationServer(jrest, batch=2, window_ms=5,
                                         no_resize=True, rng_seed=SEED)):
        srv.start()
        try:
            replies.append(_pil_decode(srv.restore_bytes(body, timeout=300)))
        finally:
            srv.stop()
    ours, theirs = replies
    assert ours.shape == theirs.shape == (32, 48, 3)
    assert int(np.abs(ours.astype(int) - theirs.astype(int)).max()) <= 1


# ------------------------------------------------------------------- HTTP

@pytest.fixture(scope="module")
def tiny_server():
    rest = build_restorer(config_from_dict(RAW).validate(), None, None,
                          device="cpu")
    srv = server.RestorationServer(rest, batch=4, window_ms=200,
                                   no_resize=True)
    httpd = srv.serve("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield srv, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    srv.stop(timeout=60)
    t.join(10)
    assert not srv._worker.is_alive() and not t.is_alive()


def _post(port, body, results):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/restore",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        results.append((r.status, r.read()))


def test_http_restore_health_and_survival(tiny_server):
    srv, port = tiny_server
    body = _png(_image("RGB", 32, 32))
    results = []
    threads = [threading.Thread(target=_post, args=(port, body, results))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert len(results) == 2
    for status, png in results:
        assert status == 200
        out = decode_png(png)
        assert out.dtype == np.uint8 and out.shape == (32, 32, 3)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=30) as r:
        health = json.loads(r.read())
    assert health["served"] == 2 and health["errors"] == 0
    assert health["batches"] <= 2 and health["queue_depth"] == 0

    for path, data in (("/restore", b"not an image"), ("/nowhere", None)):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=data,
                                     method="POST" if data else "GET")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == (500 if data else 404)
        if data:
            assert b"PIL cannot identify it" in err.value.read()
    _post(port, body, results)          # the device owner survived
    assert results[-1][0] == 200


@pytest.mark.parametrize("fmt", ["JPEG", "palette", "BMP"])
def test_http_restores_jpeg_palette_and_bmp_bodies(tiny_server, fmt):
    """A JPEG, a palette-PNG and a BMP body are decoded as PIL decodes
    them and answered 200 with a PNG of their geometry."""
    srv, port = tiny_server
    body = _encoded(fmt)
    assert np.array_equal(srv._decode(body),
                          _pil_decode(body).astype(np.float32) / 255.0)
    results = []
    _post(port, body, results)
    status, png = results[0]
    assert status == 200
    out = decode_png(png)
    assert out.dtype == np.uint8 and out.shape == (32, 48, 3)


def _bomb_jpeg(h=20000, w=20000):
    """A 16x16 JPEG whose SOF0 claims h x w: a body of a few hundred bytes
    whose header asks for far more pixels than PIL's decompression-bomb
    limit."""
    buf = io.BytesIO()
    Image.fromarray(_image("RGB", 16, 16)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = h.to_bytes(2, "big") + w.to_bytes(2, "big")
    return bytes(data)


def test_http_refuses_a_decompression_bomb_header(tiny_server):
    """A JPEG body whose header claims 20000x20000 pixels is refused by
    its header, as JAX's PIL refuses it, and answered 500; the server goes
    on serving."""
    srv, port = tiny_server
    body = _bomb_jpeg()
    assert len(body) < 1000
    with pytest.raises(Image.DecompressionBombError):
        jax_server.RestorationServer(None)._decode(body)
    with pytest.raises(ValueError, match="decompression-bomb limit"):
        srv._decode(body)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/restore",
                                 data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 500
    assert b"decompression-bomb limit" in err.value.read()
    results = []
    _post(port, _encoded("JPEG"), results)
    assert results[0][0] == 200


@pytest.mark.parametrize("fmt", list(PIL_FORMATS))
def test_http_restores_pil_format_bodies(tiny_server, fmt):
    """WebP (lossy, lossless, RGBA), GIF and TIFF bodies over HTTP are
    decoded as PIL decodes them and answered 200 with a PNG of their
    geometry."""
    srv, port = tiny_server
    body = _encoded(fmt)
    assert np.array_equal(srv._decode(body),
                          _pil_decode(body).astype(np.float32) / 255.0)
    results = []
    _post(port, body, results)
    status, png = results[0]
    assert status == 200
    out = decode_png(png)
    assert out.dtype == np.uint8 and out.shape == (32, 48, 3)


def test_a_burst_beyond_the_stdlib_backlog_fills_one_batch():
    """16 concurrent connections reach the batcher within the window: the
    standard library's listen backlog of 5 (JAX's server) drops the rest,
    whose retries come about a second later, splitting the batch."""
    srv = server.RestorationServer(FixedRestorer(np.zeros((32, 32, 3))),
                                   batch=16, window_ms=900, no_resize=True)
    httpd = srv.serve("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    body, results = _png(_image("RGB", 32, 32)), []
    try:
        clients = [threading.Thread(target=_post, args=(
            httpd.server_address[1], body, results)) for _ in range(16)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(120)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(timeout=60)
    assert len(results) == 16 and all(r[0] == 200 for r in results)
    assert srv.stats["batches"] == 1 and srv.stats["served"] == 16


# -------------------------------------------------------------------- CLI

def test_serve_cli_refuses_a_missing_card(monkeypatch):
    """(``--patch-shard`` serves: ``tests/test_torch_parallel_serve.py``.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--config", "production", "--resume", ""])


def test_serve_cli_serves_until_interrupted():
    """``python -m wavedm_tpu_torch.cli.serve`` on the CPU at a tiny size:
    warm-up, a restore over HTTP, ``/healthz``, and a clean exit on
    SIGINT."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "wavedm_tpu_torch.cli.serve", "--config",
            "production", "--device", "cpu", "--resume", "", "--host",
            "127.0.0.1", "--port", "0", "--batch", "1", "--no-resize",
            "--warmup"]
    for ov in ("model.ch=32", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
               "model.attn_resolutions=[4]", "data.image_size=8",
               "data.patch_size=32", "hfrm.dim=8", "hfrm.enc_blk_nums=[1,1]",
               "hfrm.dec_blk_nums=[1,1]", "hfrm.middle_blk_num=1",
               "sampling.sampling_timesteps=2", "sampling.grid_r=8"):
        argv += ["--set", ov]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving restoration on"):
                break
        assert lines and lines[-1].startswith("serving"), (
            lines, proc.stderr.read() if proc.poll() is not None else "")
        assert lines[0].startswith("warmup (batch 1, 720x480)"), lines
        port = int(lines[-1].split()[3].rsplit(":", 1)[1])
        results = []
        _post(port, _png(_image("RGB", 32, 32)), results)
        assert results[0][0] == 200
        assert decode_png(results[0][1]).shape == (32, 32, 3)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read())["served"] == 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
