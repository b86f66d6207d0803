"""PyTorch port: the training data path against the JAX package.

The RainDrop training crops (streamed and through the device cache), the
paired-folder batches and PIL's BILINEAR resample are held to the JAX
package's PIL path bit for bit, over PNG pairs written into a temporary
tree.  Both packages' native crop streams are switched off in these
tests (the JAX package's library is built in the tree, and the port's
builds wherever libjpeg's and libpng's headers are): they hold the PIL
path, which the device caches follow.  The native streams are held to
each other in ``tests/test_torch_native_loader.py``.  PIL is imported by
the tests only.
"""

import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.data import device_cache as jax_device_cache
from wavedm_tpu.data import folder as jax_folder
from wavedm_tpu.data import native_loader
from wavedm_tpu.data import raindrop as jax_raindrop

from wavedm_tpu_torch.config import ConfigError, config_from_dict
from wavedm_tpu_torch.data import raindrop
from wavedm_tpu_torch.data.device_cache import (DeviceCropCache,
                                                build_pair_cache, to_unit)
from wavedm_tpu_torch.data.folder import PairedImageFolder
from wavedm_tpu_torch.utils.images import resize_bilinear, write_png

H, W = 64, 96
N_TRAIN = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_native_decoder(monkeypatch):
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(raindrop.native_loader, "available", lambda: False)


def _write_pairs(root, n, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        for folder, name in (("input", f"{i}_rain.png"),
                             ("gt", f"{i}_clean.png")):
            path = os.path.join(root, folder, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_png(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _write_pairs(str(root / "raindrop" / "train"), N_TRAIN)
    _write_pairs(str(root / "raindrop" / "raindrop_test"), 2, seed=1)
    return str(root)


def _raw(data_dir, **data):
    return {"data": {"image_size": 8, "patch_size": 32,
                     "data_dir": data_dir, **data},
            "training": {"patch_n": 2, "batch_size": 2, "seed": 7}}


def _configs(raw):
    return jax_config_from_dict(raw), config_from_dict(raw)


@pytest.mark.parametrize("proc", [(0, 1), (0, 2), (1, 2)],
                         ids=["one", "stripe0of2", "stripe1of2"])
def test_train_batches_match_jax(data_dir, proc):
    jcfg, cfg = _configs(_raw(data_dir))
    for epoch in (0, 1):
        want = list(jax_raindrop.RainDrop(jcfg, *proc).train_batches(
            epoch, prefetch=False, use_native=False))
        got = list(raindrop.RainDrop(cfg, *proc).train_batches(epoch))
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (4, 32, 32, 6)
            assert np.array_equal(g, w)
    # the epoch is folded into the crops: two epochs differ
    e0 = next(raindrop.RainDrop(cfg, *proc).train_batches(0))
    e1 = next(raindrop.RainDrop(cfg, *proc).train_batches(1))
    assert not np.array_equal(e0, e1)


def _same_pixels_as_jax_cache(got, want):
    """JAX's cache computes uint8 / 255 under jit, which XLA turns into
    uint8 * float32(1/255): one ulp off the division in about half the
    values, so off JAX's own streamed path.  The port's cache divides, as
    both streamed paths do.  Held here: the same uint8 pixels, and values
    within one float32 ulp below 1 (6e-8)."""
    want = np.asarray(want)
    assert np.array_equal(np.rint(got * 255.0), np.rint(want * 255.0))
    assert np.abs(got - want).max() <= 2.0 ** -24


def test_device_cache_matches_jax_and_the_streamed_path(data_dir):
    jcfg, cfg = _configs(_raw(data_dir, device_cache=True))
    ds = raindrop.RainDrop(cfg, device="cpu")
    for epoch in (0, 1):
        got = list(ds.train_batches(epoch))
        want = list(jax_raindrop.RainDrop(jcfg).train_batches(
            epoch, use_native=False))
        cfg.data.device_cache = False
        streamed = list(ds.train_batches(epoch, prefetch=False))
        cfg.data.device_cache = True
        assert len(got) == len(want) == len(streamed) == N_TRAIN // 2
        for g, w, s in zip(got, want, streamed):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            assert np.array_equal(g.numpy(), s)
            _same_pixels_as_jax_cache(g.numpy(), w)
    # and bit for bit the JAX package's streamed batches
    jcfg.data.device_cache = False
    want = jax_raindrop.RainDrop(jcfg).train_batches(1, use_native=False,
                                                     prefetch=False)
    for g, w in zip(ds.train_batches(1), want):
        assert np.array_equal(g.numpy(), w)
    # the same coordinates through both caches directly
    rows = np.array([[0, 0, 0], [4, 32, 64], [2, 17, 3]], np.int32)
    jcache = jax_device_cache.build_pair_cache(
        *jax_raindrop._list_pairs(os.path.join(data_dir, "raindrop", "train")),
        32, use_native=False)
    _same_pixels_as_jax_cache(ds._cache.crop_batch(rows).numpy(),
                              jcache.crop_batch(rows))
    assert ds._cache.data.shape == (N_TRAIN, H, W, 6)
    assert ds._cache.data.dtype == torch.uint8


def test_to_unit_divides_as_numpy_does():
    x = np.arange(256, dtype=np.uint8)
    assert np.array_equal(to_unit(torch.from_numpy(x)).numpy(),
                          x.astype(np.float32) / 255.0)


def test_device_cache_refuses_mixed_sizes_and_bad_coordinates(tmp_path):
    _write_pairs(str(tmp_path / "a"), 1)
    _write_pairs(str(tmp_path / "b"), 1, h=H + 4)
    inputs = [str(tmp_path / d / "input" / "0_rain.png") for d in "ab"]
    gts = [str(tmp_path / d / "gt" / "0_clean.png") for d in "ab"]
    with pytest.raises(ConfigError, match="uniform train-image geometry"):
        build_pair_cache(inputs, gts, 32, "cpu")
    cache = DeviceCropCache(np.zeros((2, H, W, 6), np.uint8), 32, "cpu")
    for rows in ([[2, 0, 0]], [[0, H - 31, 0]], [[0, 0, -1]]):
        with pytest.raises(ValueError, match="out of range"):
            cache.crop_batch(np.array(rows))
    with pytest.raises(ValueError, match="exceeds"):
        DeviceCropCache(np.zeros((1, 16, 16, 6), np.uint8), 32, "cpu")


def test_prefetcher_reraises_a_worker_error():
    def items():
        yield 1
        yield 2
        raise OSError("decode failed")

    got = []
    with pytest.raises(OSError, match="decode failed"):
        for item in raindrop._Prefetcher(items()):
            got.append(item)
    assert got == [1, 2]


def test_prefetcher_runs_ahead_by_its_depth():
    produced = []

    def items():
        for i in range(6):
            produced.append(i)
            yield i

    pf = raindrop._Prefetcher(items(), depth=2)
    deadline = time.monotonic() + 10
    while len(produced) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    # two items queued and a third waiting to be: no more before a get
    assert len(produced) == 3
    assert list(pf) == list(range(6))
    pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


def test_a_decode_error_in_the_split_stops_the_epoch(tmp_path):
    root = tmp_path / "raindrop" / "train"
    _write_pairs(str(root), 3)
    (root / "gt" / "1_clean.png").write_bytes(b"not a png")
    _, cfg = _configs(_raw(str(tmp_path)))
    cfg.training.batch_size = 1
    with pytest.raises(ValueError, match="not a PNG"):
        list(raindrop.RainDrop(cfg).train_batches(0))


def test_global_attn_crops_are_refused(data_dir):
    """The device cache refuses global_attn crops, as JAX's does: they are
    streamed with each image's whole, LANCZOS-resized to 720x480 (the
    global crops' parity with JAX is in tests/test_torch_global_attn.py)."""
    _, cfg = _configs(_raw(data_dir))
    cfg.data.global_attn = True
    cfg.data.device_cache = True
    data = raindrop.RainDrop(cfg, device="cpu")
    crops, totals = next(data.train_batches(0))
    assert data._cache is None
    assert isinstance(crops, np.ndarray)
    assert crops.shape[0] == cfg.training.batch_size * cfg.training.patch_n
    assert totals.shape == (cfg.training.batch_size, 480, 720, 3)


def test_webp_pairs_train_and_evaluate_as_jax(tmp_path, monkeypatch):
    """A split of WebP pairs (lossy inputs, lossless ground truths) trains
    and evaluates as JAX's PIL path reads it.  The port's default stream
    is the PIL-order one even where the data library is available, since
    the library decodes only PNG and JPEG; its device cache reads the
    same pixels."""
    rng = np.random.default_rng(3)
    for split, n in (("train", 4), ("raindrop_test", 2)):
        for i in range(n):
            for folder, name, kw in (("input", f"{i}_rain.webp",
                                      {"quality": 85}),
                                     ("gt", f"{i}_clean.webp",
                                      {"lossless": True})):
                path = tmp_path / "raindrop" / split / folder / name
                path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(rng.integers(0, 256, (H, W, 3),
                                             dtype=np.uint8)).save(path, **kw)
    monkeypatch.setattr(raindrop.native_loader, "available", lambda: True)
    jcfg, cfg = _configs(_raw(str(tmp_path)))
    want = list(jax_raindrop.RainDrop(jcfg).train_batches(
        0, prefetch=False, use_native=False))
    got = list(raindrop.RainDrop(cfg).train_batches(0))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    cached = list(raindrop.RainDrop(config_from_dict(_raw(
        str(tmp_path), device_cache=True)), device="cpu").train_batches(0))
    for g, w in zip(cached, want):
        assert np.array_equal(np.asarray(g), w)
    ours = list(raindrop.RainDrop(cfg).eval_samples())
    theirs = list(jax_raindrop.RainDropDataset(
        os.path.join(str(tmp_path), "raindrop", "raindrop_test"), 32, 2,
        parse_patches=False).epoch(0, 0, shuffle=False))
    assert [i for _, i in ours] == [i for _, i in theirs] == ["0_rain",
                                                              "1_rain"]
    for (a, _), (b, _) in zip(ours, theirs):
        assert a.shape == (480, 720, 6) and np.array_equal(a, b)


def test_eval_samples_stripe_over_processes(data_dir):
    _, cfg = _configs(_raw(data_dir))
    ids = [[i for _, i in raindrop.RainDrop(cfg, k, 2).eval_samples()]
           for k in (0, 1)]
    assert ids == [["0_rain"], ["1_rain"]]


@pytest.mark.parametrize("crop,resize,size", [
    (True, True, (40, 24)), (True, False, (40, 24)), (False, True, (24, 24)),
    (False, False, (96, 64))], ids=["crop_resize", "crop", "resize", "full"])
def test_paired_folder_matches_jax(data_dir, crop, resize, size):
    root = os.path.join(data_dir, "raindrop", "train")
    kw = dict(crop=crop, resize=resize, crop_size=size[0],
              resize_size=size[1])
    for index, count in ((0, 1), (1, 2)):
        kw.update(process_index=index, process_count=count)
        want = list(jax_folder.PairedImageFolder(root, **kw)
                    .batches(2, epoch=1, seed=3))
        got = list(PairedImageFolder(root, **kw).batches(2, epoch=1, seed=3))
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            assert np.array_equal(g, w)
    if not crop and not resize:
        # a root naming raindrop is held to 720x480
        assert got[0].shape == (2, 480, 720, 6)


def test_paired_folder_crop_beyond_the_image_is_zero(tmp_path):
    _write_pairs(str(tmp_path), 2)
    kw = dict(crop=True, resize=False, crop_size=80)
    want = list(jax_folder.PairedImageFolder(str(tmp_path), **kw)
                .batches(2, epoch=0, seed=0))
    got = list(PairedImageFolder(str(tmp_path), **kw)
               .batches(2, epoch=0, seed=0))
    assert np.array_equal(got[0], want[0])
    assert got[0].shape == (2, 80, 80, 6) and (got[0][:, H:] == 0).all()


@pytest.mark.parametrize("src,size", [
    ((48, 64), (32, 32)), ((48, 64), (100, 70)), ((37, 53), (53, 20)),
    ((64, 96), (256, 256)), ((31, 17), (17, 31)), ((480, 720), (256, 256))])
def test_resize_bilinear_matches_pil(src, size):
    img = np.random.default_rng(sum(src)).integers(
        0, 256, src + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
    assert np.array_equal(resize_bilinear(img, size), want)
