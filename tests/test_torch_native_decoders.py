"""PyTorch port: the data library's own JPEG and PNG decoders
(``native/jpeg_decode.cc``, ``native/png_decode.cc``) against the JAX
package's committed ``wavedm_tpu/data/libwavedm_data.so``, which links this
host's libjpeg-turbo and libpng.

Equality is to the byte: the float32 of ``wdm_decode_image`` (JAX's
``decode_image`` beside the port's), the uint8 of the port's
``decode_bytes`` against JAX's float32 times 255, and whole crop batches.
A file one library refuses the other refuses too.  Covered: every
committed JPEG/PNG fixture and ``decodes.npz`` (among them libjpeg-written
4:4:0, 4:1:1, a restart interval of 5 MCUs and arithmetic coding,
sequential and progressive); PIL-written JPEGs of
every size from 1x1 to 67x67 at qualities 5-100, 4:4:4/4:2:2/4:2:0,
progressive, optimized, grey, with restart markers, and CMYK (refused);
baseline and progressive files cut short (by file both libraries fill in
as libjpeg does, block smoothing included; from memory the port refuses);
PNGs of every colour type and bit depth, Adam7, short palettes, split
IDATs, CRC and Adler-32 errors and cut files; and ``make_crop_batch`` over
seeds, thread counts and a split mixing JPEG and PNG pairs.

A grey, RGB or palette PNG with a tRNS chunk is the one departure
(ROADMAP §3): JAX's library writes its RGBA rows into RGB rows there (a
heap overflow), so those are held to PIL's ``convert("RGB")`` and the
high byte instead.  Hypothesis runs with a fixed seed and a case budget.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, seed, settings
from hypothesis import strategies as st
from PIL import Image

from wavedm_tpu.data import native_loader as jax_native

from wavedm_tpu_torch.data import native_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "images")
FIXTURES = sorted(f for f in os.listdir(GOLDEN)
                  if f.endswith((".jpg", ".png")))
CROP = Image.open(os.path.join(GOLDEN, "rain_q95_444.jpg")).convert("RGB")
INV = np.float32(1.0 / 255.0)
SETTINGS = dict(deadline=None, derandomize=True, database=None,
                suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.fixture(scope="module", autouse=True)
def libraries():
    if not jax_native.available():
        pytest.fail("the JAX package's committed libwavedm_data.so is gone")
    assert native_loader.available(), native_loader.unavailable_reason()


def _jax(path, cap=128):
    try:
        return jax_native.decode_image(path, cap, cap)
    except IOError:
        return None


def _port(path, cap=128):
    try:
        return native_loader.decode_image(path, cap, cap)
    except IOError:
        return None


def _port_bytes(data):
    try:
        return native_loader.decode_bytes(data)
    except ValueError:
        return None


def _same_as_jax(path, cap=128):
    """The port's file decode equals JAX's to the byte, or both refuse;
    returns JAX's decode."""
    ref, ours = _jax(path, cap), _port(path, cap)
    assert (ref is None) == (ours is None), (path, ref is None)
    if ref is not None:
        assert ours.shape == ref.shape and ours.tobytes() == ref.tobytes()
    return ref


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


# ------------------------------------------------------------ fixtures

@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixtures_decode_as_jax(name):
    path = os.path.join(GOLDEN, name)
    ref = _same_as_jax(path, 720)
    expect = np.load(os.path.join(GOLDEN, "decodes.npz"))[name]
    assert np.array_equal(ref, expect * INV)
    with open(path, "rb") as f:
        assert np.array_equal(native_loader.decode_bytes(f.read()), expect)


def test_crop_batch_fixture_equals_the_ports():
    fx = np.load(os.path.join(GOLDEN, "crop_batch.npz"))
    batch = native_loader.make_crop_batch(
        [os.path.join(REPO, p) for p in fx["inputs"]],
        [os.path.join(REPO, p) for p in fx["gts"]], int(fx["patch_n"]),
        int(fx["patch"]), int(fx["seed"]), n_threads=2)
    assert np.array_equal(batch, fx["batch"] * INV)


# ---------------------------------------------------------- PIL's JPEGs

def _pil_jpeg(h, w, grey, quality, sub, prog, opt, restart, rng):
    base = np.asarray(CROP.resize((w, h)))
    noise = rng.integers(0, 256, base.shape)
    pixels = np.where(rng.random((h, w, 1)) < 0.2, noise, base)
    img = Image.fromarray(pixels.astype(np.uint8))
    kw = dict(quality=quality, progressive=prog, optimize=opt)
    if grey:
        img = img.convert("L")
    else:
        kw["subsampling"] = sub
    if restart:
        kw["restart_marker_blocks"] = restart
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


@seed(20261018)
@settings(max_examples=400, **SETTINGS)
@given(h=st.integers(1, 67), w=st.integers(1, 67), grey=st.booleans(),
       quality=st.integers(5, 100), sub=st.sampled_from([0, 1, 2]),
       prog=st.booleans(), opt=st.booleans(),
       restart=st.sampled_from([0, 0, 1, 3]), rs=st.integers(0, 2**16))
def test_pil_jpegs_decode_as_jax(tmp_path, h, w, grey, quality, sub, prog,
                                 opt, restart, rs):
    data = _pil_jpeg(h, w, grey, quality, sub, prog, opt, restart,
                     np.random.default_rng(rs))
    ref = _same_as_jax(_write(tmp_path, "t.jpg", data))
    assert ref is not None and ref.shape == (h, w, 3)
    assert np.array_equal(_port_bytes(data) * INV, ref)


def test_cmyk_jpeg_is_refused_by_both(tmp_path):
    buf = io.BytesIO()
    CROP.convert("CMYK").save(buf, "JPEG", quality=90)
    path = _write(tmp_path, "cmyk.jpg", buf.getvalue())
    assert _jax(path) is None and _port(path) is None
    assert _port_bytes(buf.getvalue()) is None


# ------------------------------------------------------- cut-short JPEGs

CUT_FILES = {
    "baseline": dict(quality=85, subsampling=2),
    "progressive": dict(quality=85, subsampling=2, progressive=True),
    "progressive_444": dict(quality=60, subsampling=0, progressive=True),
    "restarts": dict(quality=70, subsampling=1, restart_marker_blocks=2),
}


@pytest.mark.parametrize("kind", sorted(CUT_FILES) + [
    "rain_arith_progressive.jpg", "rain_440.jpg"])
def test_cut_jpegs_fill_as_jax_from_files_and_are_refused_from_memory(
        tmp_path, kind):
    """Cut points inside every scan: by file, libjpeg's fill after its
    end-of-data warning (zeros, and block smoothing of the progressive
    rows from the coefficient state before the cut scan); from memory,
    refused."""
    if kind in CUT_FILES:
        buf = io.BytesIO()
        np_img = np.asarray(Image.open(os.path.join(
            GOLDEN, "raindrop_0000.jpg")).convert("RGB"))[96:196, 200:313]
        Image.fromarray(np_img).save(buf, "JPEG", **CUT_FILES[kind])
        data = buf.getvalue()
    else:
        data = open(os.path.join(GOLDEN, kind), "rb").read()
    rng = np.random.default_rng(len(data))
    cuts = sorted(set(rng.integers(2, len(data) - 1, 40).tolist()))
    decoded = 0
    for cut in cuts:
        ref = _same_as_jax(_write(tmp_path, "cut.jpg", data[:cut]))
        decoded += ref is not None
        assert _port_bytes(data[:cut]) is None
    assert decoded >= len(cuts) // 2


# ---------------------------------------------------------------- PNGs

PASSES = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: [1, 2, 4, 8, 16], 2: [8, 16], 3: [1, 2, 4, 8], 4: [8, 16],
          6: [8, 16]}


def _chunk(kind, data, bad_crc=False):
    crc = zlib.crc32(kind + data) ^ (1 if bad_crc else 0)
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", crc & 0xFFFFFFFF)


def _row_bytes(samples, depth):
    if depth == 16:
        return b"".join(struct.pack(">H", int(v)) for v in samples)
    if depth == 8:
        return bytes(int(v) for v in samples)
    bits = "".join(format(int(v), f"0{depth}b") for v in samples)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _filter(raw, prev, f, bpp):
    out = bytearray(len(raw))
    for i, x in enumerate(raw):
        a = raw[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if f == 0:
            p = 0
        elif f == 1:
            p = a
        elif f == 2:
            p = b
        elif f == 3:
            p = (a + b) >> 1
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - p) & 255
    return bytes([f]) + bytes(out)


def _png(rng, w, h, ct, depth, interlace=False, palette=None, trns=None,
         idats=1, bad_crc=None, bad_adler=False):
    """A PNG from samples drawn by rng, every row with a random filter;
    returns (bytes, samples (h, w, channels))."""
    top = (1 << depth) - 1
    if ct == 3:
        top = int(rng.integers(0, top + 1))     # may pass the palette
    px = rng.integers(0, top + 1, (h, w, CHANNELS[ct]))
    bpp = max(1, CHANNELS[ct] * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (PASSES if interlace else [(0, 0, 1, 1)]):
        if x0 >= w or y0 >= h:
            continue
        prev = None
        for row in px[y0::dy, x0::dx]:
            rb = _row_bytes(row.reshape(-1), depth)
            raw += _filter(rb, prev or bytes(len(rb)),
                           int(rng.integers(0, 5)), bpp)
            prev = rb
    z = zlib.compress(raw, int(rng.integers(0, 10)))
    if bad_adler:
        z = z[:-1] + bytes([z[-1] ^ 1])
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct, 0, 0,
                             int(interlace)), bad_crc == b"IHDR")
    if palette is not None:
        out += _chunk(b"PLTE", palette, bad_crc == b"PLTE")
    if trns is not None:
        out += _chunk(b"tRNS", trns, bad_crc == b"tRNS")
    out += _chunk(b"tEXt", b"k\x00v", bad_crc == b"tEXt")
    cuts = np.linspace(0, len(z), idats + 1).astype(int)
    for i in range(idats):
        out += _chunk(b"IDAT", z[cuts[i]:cuts[i + 1]],
                      bad_crc == b"IDAT" and i == idats - 1)
    return out + _chunk(b"IEND", b""), px


def _expected_rgb(px, ct, depth, palette):
    """JAX's transforms: the high byte of 16 bits, grey of 1/2/4 bits
    scaled to 8, palette looked up (black past its end), alpha dropped."""
    v = px.astype(np.int64)
    if ct == 3:
        pal = np.zeros((256, 3), np.int64)
        entries = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        pal[:len(entries)] = entries[:1 << depth]
        return pal[v[..., 0]].astype(np.uint8)
    v = v >> 8 if depth == 16 else v * (255 // ((1 << depth) - 1))
    rgb = np.repeat(v[..., :1], 3, 2) if ct in (0, 4) else v[..., :3]
    return rgb.astype(np.uint8)


@st.composite
def png_cases(draw):
    ct = draw(st.sampled_from(sorted(CHANNELS)))
    return dict(ct=ct, depth=draw(st.sampled_from(DEPTHS[ct])),
                w=draw(st.integers(1, 40)), h=draw(st.integers(1, 40)),
                interlace=draw(st.booleans()), idats=draw(st.integers(1, 3)),
                trns_on_alpha=draw(st.booleans()),
                n_palette=draw(st.integers(1, 256)),
                fault=draw(st.sampled_from(
                    [None] * 6 + [b"IHDR", b"PLTE", b"IDAT", b"tEXt",
                                  b"tRNS", "adler", "cut"])),
                rs=draw(st.integers(0, 2**16)))


@seed(20261018)
@settings(max_examples=400, **SETTINGS)
@given(case=png_cases())
def test_pngs_decode_as_jax(tmp_path, case):
    rng = np.random.default_rng(case["rs"])
    ct, depth, fault = case["ct"], case["depth"], case["fault"]
    palette = None
    if ct == 3:
        n = min(case["n_palette"], 1 << depth)
        palette = bytes(rng.integers(0, 256, 3 * n).astype(np.uint8))
    # tRNS only where libpng drops it as invalid (types with alpha)
    trns = b"\x00\x00" if ct in (4, 6) and case["trns_on_alpha"] else None
    if fault == b"tRNS" and trns is None:
        fault = None
    if fault == b"PLTE" and palette is None:
        fault = None
    data, px = _png(rng, case["w"], case["h"], ct, depth, case["interlace"],
                    palette, trns, case["idats"],
                    bad_crc=fault if isinstance(fault, bytes) else None,
                    bad_adler=fault == "adler")
    if fault == "cut":
        data = data[:int(rng.integers(8, len(data) - 12))]
    ref = _same_as_jax(_write(tmp_path, "t.png", data))
    if fault in (None, b"tEXt", b"tRNS"):    # a CRC error there only warns
        assert ref is not None
        assert np.array_equal(_port_bytes(data),
                              _expected_rgb(px, ct, depth, palette))
    elif fault in (b"IHDR", b"PLTE", b"IDAT", "cut"):
        assert ref is None and _port_bytes(data) is None


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("ct,depth", [(0, 1), (0, 4), (0, 8), (0, 16),
                                      (2, 8), (2, 16), (3, 2), (3, 8)])
def test_trns_pngs_drop_the_alpha(tmp_path, ct, depth):
    """The departure: with tRNS in a grey, RGB or palette PNG JAX's
    library overruns its rows (not run here); the port drops the alpha,
    as PIL's convert("RGB") does (16-bit: the high byte)."""
    rng = np.random.default_rng(ct * 100 + depth)
    palette = bytes(rng.integers(0, 256, 3 * (1 << min(depth, 4)))
                    .astype(np.uint8)) if ct == 3 else None
    trns = {0: struct.pack(">H", 1), 2: struct.pack(">HHH", 1, 2, 3),
            3: b"\x00\x80"}[ct]
    data, px = _png(rng, 13, 11, ct, depth, palette=palette, trns=trns)
    ours = _port_bytes(data)
    assert np.array_equal(ours, _expected_rgb(px, ct, depth, palette))
    if depth <= 8:
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(ours, pil)
    path = _write(tmp_path, "trns.png", data)
    assert np.array_equal(_port(path), ours * INV)


# --------------------------------------------------------- crop batches

@pytest.fixture(scope="module")
def mixed_pairs(tmp_path_factory):
    """Six pairs of 70x90 images: JPEG inputs over PNG ground truths, PNG
    over JPEG, both JPEG (one progressive), both PNG (one Adam7)."""
    d = tmp_path_factory.mktemp("pairs")
    full = np.asarray(Image.open(os.path.join(
        GOLDEN, "raindrop_0000.jpg")).convert("RGB"))
    kinds = [("jpg", "png"), ("png", "jpg"), ("jpg", "jpg"),
             ("png", "png"), ("jpg", "jpg"), ("png", "png")]
    inputs, gts = [], []
    for i, (ki, kg) in enumerate(kinds):
        for side, kind, out in (("in", ki, inputs), ("gt", kg, gts)):
            img = Image.fromarray(full[40 * i:40 * i + 70,
                                       60 * i + (side == "gt"):][:, :90])
            path = str(d / f"{side}{i}.{kind}")
            if kind == "jpg":
                img.save(path, quality=80 + i, progressive=i == 4)
            else:
                img.save(path, optimize=i == 3)
                if i == 5:
                    data, _ = _png(np.random.default_rng(i), 90, 70, 2, 8,
                                   interlace=True)
                    open(path, "wb").write(data)
            out.append(path)
    return inputs, gts


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("seed_", [0, 7, 2**40 + 3])
def test_crop_batches_equal_jax(mixed_pairs, threads, seed_):
    inputs, gts = mixed_pairs
    ref = jax_native.make_crop_batch(inputs, gts, 3, 32, seed_, threads)
    ours = native_loader.make_crop_batch(inputs, gts, 3, 32, seed_, threads)
    assert ours.tobytes() == ref.tobytes()
