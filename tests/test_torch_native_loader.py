"""PyTorch port: the data library (``native/wavedm_data.cc``, built by
``native/build.py``, bound by ``data/native_loader.py``) against the JAX
package's own library (``wavedm_tpu/data/libwavedm_data.so``) and PIL.

The port's library decodes with its own JPEG and PNG decoders, written to
give what libjpeg-turbo and libpng give in the JAX package's library, so
every comparison is exact: float32 bytes, or uint8.  Decodes equal JAX's and
PIL's ``convert("RGB")`` (16-bit grey aside: libpng keeps the high byte
where PIL clips); crop batches equal JAX's over seeds, thread counts and
pairs of several sizes; ``RainDrop.train_batches(use_native=True)`` and
the default stream equal JAX's.  The build is keyed on the sources' hash,
refuses nothing quietly, and never loads the JAX package's library.
PIL and the JAX package are imported by the tests only.
"""

import io
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from wavedm_tpu.config import config_from_dict as jax_config_from_dict
from wavedm_tpu.data import native_loader as jax_native
from wavedm_tpu.data import raindrop as jax_raindrop

from wavedm_tpu_torch.config import config_from_dict
from wavedm_tpu_torch.data import native_loader, raindrop
from wavedm_tpu_torch.native import build
from wavedm_tpu_torch.utils.images import decode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "images")
JPEGS = ["rain_q95_444.jpg", "rain_q90_420.jpg", "rain_q75_422.jpg",
         "rain_progressive.jpg", "grey.jpg"]
INV = np.float32(1.0 / 255.0)        # the libraries' `* (1.0f/255)`


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_library():
    if not jax_native.available():
        pytest.fail("the JAX package's committed libwavedm_data.so is gone")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """name -> path: the committed JPEGs, a PNG and a palette PNG of the
    same crop, and a 16-bit grey PNG."""
    d = tmp_path_factory.mktemp("native")
    paths = {name: os.path.join(GOLDEN, name) for name in JPEGS}
    crop = np.asarray(Image.open(paths["rain_q95_444.jpg"]).convert("RGB"))
    for name, img in (("rgb.png", Image.fromarray(crop)),
                      ("palette.png", Image.fromarray(crop).convert("P")),
                      ("grey16.png", Image.fromarray(
                          (crop[..., 0].astype(np.uint16) * 300)))):
        paths[name] = str(d / name)
        img.save(paths[name])
    return paths


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


DECODED = JPEGS + ["rgb.png", "palette.png"]


@pytest.mark.parametrize("name", DECODED)
def test_decode_image_equals_jax_and_pil(images, jax_library, name):
    path = images[name]
    ours = native_loader.decode_image(path)
    assert ours.dtype == np.float32 and ours.shape == (40, 64, 3)
    assert ours.tobytes() == jax_native.decode_image(path).tobytes()
    assert np.array_equal(ours, _pil(path) * INV)


@pytest.mark.parametrize("name", DECODED)
def test_decode_bytes_equals_the_file_path(images, name):
    path = images[name]
    with open(path, "rb") as f:
        ours = native_loader.decode_bytes(f.read(), name)
    assert ours.dtype == np.uint8
    assert np.array_equal(ours, _pil(path))
    assert np.array_equal(ours * INV, native_loader.decode_image(path))


def test_sixteen_bit_grey_keeps_the_high_byte(images, jax_library):
    """libpng's strip_16 keeps the high byte, in both libraries; PIL's
    "I;16" converts by clipping at 255, and ``decode_png`` follows PIL
    (ROADMAP §3: JAX's server and data path part here)."""
    path = images["grey16.png"]
    raw = np.asarray(Image.open(path)).astype(np.int64)
    ours = native_loader.decode_image(path)
    assert ours.tobytes() == jax_native.decode_image(path).tobytes()
    assert np.array_equal(ours, np.repeat((raw >> 8)[..., None], 3, 2)
                          .astype(np.uint8) * INV)
    pure = decode_png(open(path, "rb").read())
    assert np.array_equal(pure, _pil(path))
    assert np.array_equal(pure[..., 0], np.minimum(raw, 255))
    assert not np.array_equal(pure, np.rint(ours * 255).astype(np.uint8))


def test_decode_image_refusals_raise_ioerror(images, jax_library, tmp_path):
    with pytest.raises(IOError, match=r"rc=1\) for .*missing.png"):
        native_loader.decode_image(str(tmp_path / "missing.png"))
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image")
    with pytest.raises(IOError, match="rc=1"):
        native_loader.decode_image(str(junk))
    with pytest.raises(IOError, match="rc=2"):
        native_loader.decode_image(images["rgb.png"], max_h=39)
    with pytest.raises(ValueError, match="body: not a JPEG or PNG"):
        native_loader.decode_bytes(b"GIF89a....", "body")
    # a body cut short is refused, as PIL refuses it; a file cut short
    # takes libjpeg's grey fill, as the JAX package's library does
    data = open(os.path.join(GOLDEN, "raindrop_0000.jpg"), "rb").read()
    with pytest.raises(ValueError, match="cut.jpg: .* failed to decode"):
        native_loader.decode_bytes(data[:len(data) * 2 // 3], "cut.jpg")
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:len(data) * 2 // 3])
    assert native_loader.decode_image(str(cut)).tobytes() == \
        jax_native.decode_image(str(cut)).tobytes()


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Six (input, gt) pairs of four sizes, PNG and JPEG mixed."""
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    inputs, gts = [], []
    for i, (h, w) in enumerate([(40, 64), (48, 56), (64, 40), (40, 64),
                                (33, 70), (48, 56)]):
        for kind, out in (("rain", inputs), ("clean", gts)):
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                               dtype=np.uint8))
            path = str(d / f"{i}_{kind}.{'jpg' if i % 2 else 'png'}")
            img.save(path)
            out.append(path)
    return inputs, gts


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_make_crop_batch_equals_jax(pairs, jax_library, seed, n_threads):
    inputs, gts = pairs
    ours = native_loader.make_crop_batch(inputs, gts, patch_n=3, patch=32,
                                         seed=seed, n_threads=n_threads)
    theirs = jax_native.make_crop_batch(inputs, gts, patch_n=3, patch=32,
                                        seed=seed, n_threads=n_threads)
    assert ours.shape == (18, 32, 32, 6) and ours.dtype == np.float32
    assert ours.tobytes() == theirs.tobytes()


def test_a_pair_smaller_than_the_patch_raises(pairs):
    """The JAX library reads past such an image (ROADMAP §3); the port's
    skips it as it skips a failed decode."""
    inputs, gts = pairs
    with pytest.raises(IOError, match="only 2/6 image pairs"):
        native_loader.make_crop_batch(inputs, gts, patch_n=1, patch=41,
                                      seed=0)
    ok = native_loader.make_crop_batch(inputs[:1], gts[:1], patch_n=2,
                                       patch=40, seed=0)
    assert ok.shape == (2, 40, 40, 6)


def test_a_missing_pair_raises(pairs, tmp_path):
    inputs, gts = pairs
    with pytest.raises(IOError, match="only 1/2 image pairs"):
        native_loader.make_crop_batch(
            inputs[:2], [gts[0], str(tmp_path / "missing.png")], 1, 16, 0)
    with pytest.raises(ValueError, match="2 inputs but 1 ground truths"):
        native_loader.make_crop_batch(inputs[:2], gts[:1], 1, 16, 0)


# ------------------------------------------------------------- the build

@pytest.fixture
def own_build(monkeypatch, tmp_path):
    """The build module pointed at a copy of the sources and a build
    directory under ``tmp_path``, with nothing loaded yet; returns the
    copy of ``wavedm_data.cc``."""
    for path in build.SOURCES + build.HEADERS_LOCAL:
        shutil.copy(path, tmp_path)
    monkeypatch.setattr(build, "SOURCES", tuple(
        str(tmp_path / os.path.basename(p)) for p in build.SOURCES))
    monkeypatch.setattr(build, "HEADERS_LOCAL", tuple(
        str(tmp_path / os.path.basename(p)) for p in build.HEADERS_LOCAL))
    src = tmp_path / "wavedm_data.cc"
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "LIB_PATH",
                        str(tmp_path / "_build" / "lib.so"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "last_build_seconds", None)
    return src


def test_a_source_change_rebuilds_the_library(own_build):
    build.build()
    first = build.last_build_seconds
    assert first is not None and build._is_current(build.source_hash())
    build.last_build_seconds = None
    build.build()                             # current: nothing to do
    assert build.last_build_seconds is None
    old = build.source_hash()
    own_build.write_text(own_build.read_text() + "\n// changed\n")
    assert build.source_hash() != old and not build._is_current(
        build.source_hash())
    build.build()
    assert build.last_build_seconds is not None
    assert build._is_current(build.source_hash())
    assert os.listdir(build.BUILD_DIR) == ["lib.so"]     # no temporaries


def test_a_compile_error_raises_with_the_toolchain_present(own_build):
    own_build.write_text(own_build.read_text() + "\nint broken(\n")
    assert build.unavailable_reason() is None
    with pytest.raises(RuntimeError, match="failed to build"):
        native_loader.available()
    assert not os.path.exists(build.LIB_PATH)


@pytest.mark.parametrize("missing", ["compiler", "zlib.h"])
def test_unavailable_names_what_is_missing(own_build, monkeypatch, missing):
    probe = {"compiler": None if missing == "compiler" else "/usr/bin/c++",
             "headers": {h: h != missing for h in build.HEADERS}}
    monkeypatch.setattr(build, "probe", lambda: probe)
    assert native_loader.available() is False
    reason = native_loader.unavailable_reason()
    assert ("no C++ compiler" if missing == "compiler" else "zlib.h") \
        in reason
    assert build.status()["available"] is False
    with pytest.raises(RuntimeError, match=re.escape(reason)):
        build.library()


def test_status_reports_the_toolchain():
    st = build.status()
    assert st["available"] is True and st["reason"] is None
    assert st["library"] == build.LIB_PATH
    assert st["headers"] == {h: True for h in build.HEADERS}


def test_the_library_is_the_ports_own():
    """The port builds and maps its own library, never the JAX package's
    ``libwavedm_data.so``, with the JAX package blocked."""
    assert os.path.basename(build.LIB_PATH) == "libwavedm_tpu_torch_data.so"
    assert {os.path.dirname(p) for p in build.SOURCES} == {os.path.join(
        REPO, "wavedm_tpu_torch", "native")}
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "wavedm_tpu", "PIL"):
            sys.modules[name] = None
        from wavedm_tpu_torch.data import native_loader
        img = native_loader.decode_image({os.path.join(GOLDEN, JPEGS[0])!r})
        assert img.shape == (40, 64, 3)
        maps = open("/proc/self/maps").read()
        assert "libwavedm_tpu_torch_data.so" in maps
        assert "libwavedm_data.so" not in maps
        print("own library")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "own library" in res.stdout


# -------------------------------------------------- the RainDrop stream

@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """``tests/test_data_pipeline.py``'s fixture: 6 train pairs of
    120x180, the gt the input's negative."""
    root = tmp_path_factory.mktemp("raindrop_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("raindrop_test", 2)):
        for sub in ("input", "gt"):
            os.makedirs(root / "raindrop" / split / sub)
        for i in range(n):
            arr = (rng.random((120, 180, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(
                root / "raindrop" / split / "input" / f"{i}_rain.png")
            Image.fromarray(255 - arr).save(
                root / "raindrop" / split / "gt" / f"{i}_clean.png")
    return str(root)


def _raw(dataset_dir):
    return {"data": {"image_size": 8, "patch_size": 32,
                     "data_dir": dataset_dir, "num_workers": 3},
            "training": {"patch_n": 4, "batch_size": 2, "seed": 5}}


@pytest.mark.parametrize("proc", [(0, 1), (1, 2)],
                         ids=["one", "stripe1of2"])
def test_native_train_batches_equal_jax(dataset_dir, jax_library, proc):
    raw = _raw(dataset_dir)
    jcfg, cfg = jax_config_from_dict(raw), config_from_dict(raw)
    for epoch in (0, 1):
        want = list(jax_raindrop.RainDrop(jcfg, *proc).train_batches(
            epoch, use_native=True))
        got = list(raindrop.RainDrop(cfg, *proc).train_batches(
            epoch, use_native=True))
        assert len(got) == len(want) == {1: 3, 2: 1}[proc[1]]
        for g, w in zip(got, want):
            assert g.shape == (8, 32, 32, 6) and g.dtype == np.float32
            assert g.tobytes() == w.tobytes()
        # the fixture's gt is the input's negative
        np.testing.assert_allclose(got[0][..., :3] + got[0][..., 3:], 1.0,
                                   atol=2 / 255)


def test_default_stream_is_jax_default_stream(dataset_dir, jax_library):
    """With the library built and global attention off, both packages
    default to the native stream; its first batch is
    ``make_crop_batch`` of the shuffled order's first pair of images."""
    raw = _raw(dataset_dir)
    jcfg, cfg = jax_config_from_dict(raw), config_from_dict(raw)
    assert native_loader.available() and jax_native.available()
    got = list(raindrop.RainDrop(cfg).train_batches(1))
    want = list(jax_raindrop.RainDrop(jcfg).train_batches(1))
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    ds = raindrop.RainDropDataset(
        os.path.join(dataset_dir, "raindrop", "train"), 32, 4)
    order = np.array(ds.indices)
    np.random.default_rng(5 + 1).shuffle(order)
    first = native_loader.make_crop_batch(
        [ds.inputs[i] for i in order[:2]], [ds.gts[i] for i in order[:2]],
        4, 32, (5 * 100003 + 1) * 1000003, 3)
    assert first.tobytes() == got[0].tobytes()
    pil = next(raindrop.RainDrop(cfg).train_batches(1, use_native=False))
    assert not np.array_equal(pil, got[0])


def test_the_device_cache_comes_before_the_native_stream(dataset_dir):
    raw = _raw(dataset_dir)
    raw["data"]["device_cache"] = True
    data = raindrop.RainDrop(config_from_dict(raw), device="cpu")
    batch = next(data.train_batches(0, use_native=True))
    assert isinstance(batch, torch.Tensor) and data._cache is not None


def test_a_train_step_on_the_native_stream(dataset_dir):
    """``DiffusionTrainer.fit`` over ``RainDrop.train_batches`` on its
    default (native) stream, as ``cli/train_diffusion.py`` runs it: two
    steps at a tiny width, finite loss, the crops the library gave."""
    from wavedm_tpu_torch.training.trainer import DiffusionTrainer

    root = dataset_dir
    raw = {"data": {"image_size": 8, "patch_size": 32, "data_dir": root},
           "model": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                     "attn_resolutions": [4], "use_gt_in_train": True},
           "training": {"patch_n": 2, "batch_size": 2, "seed": 3}}
    cfg = config_from_dict(raw).validate()
    data = raindrop.RainDrop(cfg)
    seen = []

    def batches(epoch):
        for b in data.train_batches(epoch):
            seen.append(b)
            yield b

    trainer = DiffusionTrainer(cfg, device="cpu", log_fn=lambda s: None)
    losses = []
    step = trainer.train_step
    trainer.train_step = lambda *a: losses.append(step(*a)) or losses[-1]
    trainer.fit(batches, max_steps=2)
    assert trainer.state.step == 2
    assert all(np.isfinite(float(m.loss)) for m in losses)
    ds = raindrop.RainDropDataset(os.path.join(root, "raindrop", "train"),
                                  32, 2)
    order = np.array(ds.indices)
    np.random.default_rng(3).shuffle(order)
    first = native_loader.make_crop_batch(
        [ds.inputs[i] for i in order[:2]], [ds.gts[i] for i in order[:2]],
        2, 32, 3 * 100003 * 1000003, cfg.data.num_workers)
    assert first.tobytes() == seen[0].tobytes()


def test_serve_body_decode_of_a_jpeg_equals_pil(images):
    """``decode_bytes`` of a JPEG held in memory (a request body): the
    uint8 PIL gives, at a size the header gave."""
    buf = io.BytesIO()
    crop = _pil(images["rain_q95_444.jpg"])
    Image.fromarray(crop).save(buf, "JPEG", quality=80, subsampling="4:2:0")
    data = buf.getvalue()
    assert np.array_equal(native_loader.decode_bytes(data),
                          np.asarray(Image.open(io.BytesIO(data))
                                     .convert("RGB")))
