"""PyTorch port: the PIL-free image readers, PNG writer and LANCZOS
resize against PIL (imported here only; the port never imports it).

``read_png`` must equal PIL's ``Image.open(p).convert("RGB")`` exactly, on
the RainDrop test split and on PNGs built here with every row filter,
colour type, bit depth and interlacing (a tiny encoder of this file writes
the Adam7 and 16-bit files PIL cannot).  ``read_image`` must equal it on
BMPs and on JPEGs (through the port's data library), and refuse other
formats by name.  ``resize_lanczos`` must equal ``Image.resize(size,
Image.LANCZOS)`` exactly (no grey level off), shrinking, enlarging and at
odd sizes.
"""

import glob
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from wavedm_tpu.data.raindrop import eval_resize_dims as jax_eval_resize_dims

from wavedm_tpu_torch.data.raindrop import eval_resize_dims
from wavedm_tpu_torch.native import build as native_build
from wavedm_tpu_torch.utils.images import (decode_image, make_grid,
                                           read_image, read_png,
                                           resize_lanczos, save_image,
                                           to_uint8, write_png)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAINDROP = sorted(glob.glob(os.path.join(
    REPO, "data", "raindrop", "raindrop_test", "*", "*.png")))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples a pixel
GOLDEN = os.path.join(REPO, "tests", "golden", "images")


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_the_test_split_is_sixteen_pngs():
    assert len(RAINDROP) == 16


@pytest.mark.parametrize("path", RAINDROP,
                         ids=[os.path.relpath(p, REPO) for p in RAINDROP])
def test_read_png_equals_pil_on_raindrop(path):
    ours = read_png(path)
    assert ours.dtype == np.uint8 and ours.shape == (480, 720, 3)
    np.testing.assert_array_equal(ours, _pil_rgb(path))


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _filtered(rows, kinds, bpp):
    """PNG filtering of (H, stride) uint8 rows, row y with kinds[y]."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for row, kind in zip(rows.astype(np.int64), kinds):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - (left + prev) // 2
        else:
            pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = row - pred
        out.append(np.concatenate([[kind], f & 255]).astype(np.uint8))
        prev = row
    return np.stack(out).tobytes()


def _build_png(path, img, colour, kinds, depth=8, interlace=0, idat_parts=1):
    h, w = img.shape[:2]
    bpp = CHANNELS.get(colour, 1)
    raw = zlib.compress(_filtered(img.reshape(h, -1), kinds, bpp))
    cut = np.linspace(0, len(raw), idat_parts + 1).astype(int)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                          0, 0, interlace))
            + _chunk(b"tEXt", b"Comment\x00ancillary chunks are skipped")
            + b"".join(_chunk(b"IDAT", raw[a:b])
                       for a, b in zip(cut[:-1], cut[1:]))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("colour", [0, 2, 6], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_read_png_undoes_every_filter(tmp_path, colour, kind):
    h, w, c = 13, 17, CHANNELS[colour]
    img = np.random.default_rng(colour).integers(0, 256, (h, w, c),
                                                 dtype=np.uint8)
    kinds = [y % 5 for y in range(h)] if kind == "mixed" else [kind] * h
    path = str(tmp_path / "x.png")
    _build_png(path, img, colour, kinds, idat_parts=3)
    ours = read_png(path)
    np.testing.assert_array_equal(ours, _pil_rgb(path))
    want = np.repeat(img, 3, 2) if c == 1 else img[..., :3]
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("filter_type", [0, 2])
@pytest.mark.parametrize("shape", [(31, 45, 3), (1, 9, 3), (7, 1, 3)],
                         ids=["rgb", "one_row", "one_column"])
def test_write_png_round_trip(tmp_path, shape, filter_type):
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "y.png")
    write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    with pytest.raises(ValueError, match="takes \\(H, W, 3\\) uint8"):
        write_png(path, img[..., :2])


def test_save_image_writes_the_rounded_image(tmp_path):
    img = np.random.default_rng(6).random((10, 12, 3)).astype(np.float32)
    path = str(tmp_path / "sub" / "z.png")
    save_image(img, path)
    np.testing.assert_array_equal(read_png(path), to_uint8(img))
    with pytest.raises(ValueError, match="only PNG"):
        save_image(img, str(tmp_path / "z.jpg"))


def _special(tmp_path, case):
    """A PNG (or, for ``jpeg``, a JPEG) file of one of the cases below."""
    path = str(tmp_path / f"{case}.png")
    rgb = np.random.default_rng(3).integers(0, 256, (6, 6, 3),
                                            dtype=np.uint8)
    if case == "palette":
        Image.fromarray(rgb).convert("P").save(path)
    elif case == "grey_alpha":
        Image.fromarray(rgb).convert("LA").save(path)
    elif case == "16bit":
        Image.fromarray((rgb[..., 0].astype(np.uint16) * 257)).save(path)
    elif case == "adam7":
        open(path, "wb").write(_encode(rgb, 2, 8, 1))
    elif case == "jpeg":
        path = str(tmp_path / "x.jpg")
        Image.fromarray(rgb).save(path)
    elif case == "bad_crc":
        write_png(path, rgb)
        data = bytearray(open(path, "rb").read())
        data[40] ^= 0xFF                        # inside the IDAT body
        open(path, "wb").write(bytes(data))
    elif case == "truncated":
        write_png(path, rgb)
        data = open(path, "rb").read()
        open(path, "wb").write(data[:-12])
    return path


@pytest.mark.parametrize("case,field", [
    ("jpeg", "not a PNG"), ("bad_crc", "CRC"), ("truncated", "truncated"),
])
def test_unsupported_pngs_raise_naming_file_and_field(tmp_path, case, field):
    path = _special(tmp_path, case)
    with pytest.raises(ValueError, match=field) as err:
        read_png(path)
    assert os.path.basename(path) in str(err.value)


@pytest.mark.parametrize("case", ["palette", "grey_alpha", "16bit", "adam7"])
def test_pngs_once_refused_equal_pil(tmp_path, case):
    """The encodings ``read_png`` refused before it took every PNG."""
    path = _special(tmp_path, case)
    ours = read_png(path)
    assert ours.dtype == np.uint8 and ours.shape == (6, 6, 3)
    np.testing.assert_array_equal(ours, _pil_rgb(path))


# ------------------------------------------ every PNG encoding, own encoder

def _pack(samples, depth):
    """(h, w, c) samples -> (h, stride) uint8 rows at ``depth`` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _encode(samples, colour, depth, interlace, palette=None):
    """A PNG of (h, w, c) samples at any colour type, depth and
    interlacing, rows filtered in turn with all five filters."""
    h, w = samples.shape[:2]
    bpp = max(1, CHANNELS[colour] * depth // 8)
    raw = b""
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw += _filtered(_pack(sub, depth), [y % 5 for y in
                                             range(sub.shape[0])], bpp)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                          0, 0, interlace))
            + (_chunk(b"PLTE", palette) if palette is not None else b"")
            + (_chunk(b"tRNS", b"\x00\x07") if colour == 0 else b"")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    return data


ENCODINGS = [(c, d) for c, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                      (3, (1, 2, 4, 8)), (4, (8, 16)),
                                      (6, (8, 16)))
             for d in depths]


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour,depth", ENCODINGS,
                         ids=[f"type{c}_{d}bit" for c, d in ENCODINGS])
def test_every_png_encoding_equals_pil(tmp_path, colour, depth, interlace):
    """Every colour type at every bit depth PNG allows, plain and Adam7
    (13 x 11: passes of every size, an odd stride), against PIL's
    ``convert("RGB")``: grey below 8 bits scaled, 16-bit grey clipped at
    255, 16-bit colour to its high byte, palette indices past the PLTE
    black, tRNS ignored."""
    rng = np.random.default_rng(depth * 10 + colour)
    h, w = 13, 11
    top = (1 << depth) - 1
    if depth == 16 and colour == 0:
        top = 600                   # around the clip at 255
    samples = rng.integers(0, top + 1, (h, w, CHANNELS[colour]))
    palette = None
    if colour == 3:                 # fewer entries than indices
        palette = rng.integers(0, 256, 3 * max(1, (top + 1) * 3 // 4),
                               dtype=np.uint8).tobytes()
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_encode(samples, colour, depth, interlace, palette))
    ours = read_png(path)
    assert ours.dtype == np.uint8 and ours.shape == (h, w, 3)
    np.testing.assert_array_equal(ours, _pil_rgb(path))


def test_png_image_data_of_the_wrong_size_raises(tmp_path):
    rgb = np.zeros((4, 4, 3), np.uint8)
    data = _encode(rgb, 2, 8, 1)
    path = str(tmp_path / "short.png")
    # declared interlaced, but the data of a plain image
    plain = _encode(rgb, 2, 8, 0)
    idat = plain[plain.index(b"IDAT") - 4:plain.index(b"IEND") - 4]
    data = data[:data.index(b"IDAT") - 4] + idat + _chunk(b"IEND", b"")
    open(path, "wb").write(data)
    with pytest.raises(ValueError, match="IHDR asks for") as err:
        read_png(path)
    assert "short.png" in str(err.value)


# ------------------------------------------------------------- BMP, JPEG

def _bmp(img, top_down=False):
    """A 24-bit BI_RGB BMP written here (PIL writes bottom-up only)."""
    h, w, _ = img.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[..., ::-1].reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    body = rows.tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 24,
                       0, len(body), 2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54) + info
            + body)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "top_down"])
def test_read_image_takes_bmp_as_pil(tmp_path, mode):
    """24-bit, 32-bit, 8-bit palette and grey (PIL's writer) and a
    top-down 24-bit file, at a width whose rows need padding."""
    rgb = np.random.default_rng(9).integers(0, 256, (7, 13, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "x.bmp")
    if mode == "top_down":
        open(path, "wb").write(_bmp(rgb, top_down=True))
    else:
        im = Image.fromarray(rgb)
        (im.convert(mode) if mode != "RGB" else im).save(path)
    ours = read_image(path)
    assert ours.dtype == np.uint8 and ours.shape == (7, 13, 3)
    np.testing.assert_array_equal(ours, _pil_rgb(path))
    if mode in ("RGB", "top_down"):
        np.testing.assert_array_equal(ours, rgb)


def test_read_image_refuses_compressed_bmp(tmp_path):
    data = bytearray(_bmp(np.zeros((2, 2, 3), np.uint8)))
    data[30:34] = struct.pack("<I", 1)               # BI_RLE8
    with pytest.raises(ValueError, match="compression 1"):
        decode_image(bytes(data), "rle.bmp")


@pytest.mark.parametrize("name", ["rain_q95_444.jpg", "rain_q90_420.jpg",
                                  "rain_q75_422.jpg",
                                  "rain_progressive.jpg", "grey.jpg"])
def test_read_image_takes_jpeg_as_pil(name):
    """The committed 40x64 JPEGs through the data library, against PIL."""
    path = os.path.join(GOLDEN, name)
    ours = read_image(path)
    assert ours.dtype == np.uint8 and ours.shape == (40, 64, 3)
    np.testing.assert_array_equal(ours, _pil_rgb(path))


def test_jpeg_without_the_data_library_raises_the_reason(monkeypatch):
    monkeypatch.setattr(native_build, "unavailable_reason",
                        lambda: "jpeglib.h not found by c++")
    data = open(os.path.join(GOLDEN, "rain_q90_420.jpg"), "rb").read()
    with pytest.raises(ValueError, match="jpeglib.h not found") as err:
        decode_image(data, "photo.jpg")
    assert "photo.jpg" in str(err.value)


@pytest.mark.parametrize("fmt,field", [
    ("WEBP", "WebP is not supported"), ("GIF", "GIF is not supported"),
    ("TIFF", "not a PNG, JPEG or BMP"), ("text", "not a PNG, JPEG or BMP")])
def test_read_image_refuses_other_formats_by_name(tmp_path, fmt, field):
    path = str(tmp_path / f"x.{fmt.lower()}")
    if fmt == "text":
        open(path, "wb").write(b"not an image")
    else:
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path, fmt)
    with pytest.raises(ValueError, match=field) as err:
        read_image(path)
    assert os.path.basename(path) in str(err.value)


@pytest.mark.parametrize("src,dst", [
    ((1000, 700), (720, 480)),      # down
    ((500, 300), (720, 480)),       # up
    ((333, 217), (720, 480)),       # odd, up
    ((721, 481), (720, 480)),       # one pixel down
    ((720, 500), (720, 480)),       # rows only
    ((97, 61), (50, 33)),           # odd, down
], ids=lambda s: "x".join(map(str, s)))
def test_resize_lanczos_equals_pil(src, dst):
    rng = np.random.default_rng(sum(src))
    w, h = src
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (127.5 + 127.5 * np.sin(xx / 7.0 + yy / 11.0))[..., None]
    for img in (noise, np.repeat(smooth, 3, 2).astype(np.uint8)):
        ours = resize_lanczos(img, dst)
        ref = np.asarray(Image.fromarray(img).resize(dst, Image.LANCZOS))
        assert ours.shape == ref.shape == (dst[1], dst[0], 3)
        np.testing.assert_array_equal(ours, ref)


def test_resize_lanczos_same_size_is_identity():
    img = np.random.default_rng(7).integers(0, 256, (9, 11, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(resize_lanczos(img, (11, 9)), img)


@pytest.mark.parametrize("size", [(720, 480), (500, 300), (3000, 2000),
                                  (480, 3000)])
def test_eval_resize_dims_match_jax(size):
    assert eval_resize_dims(*size) == jax_eval_resize_dims(*size)


def test_make_grid_places_images():
    ims = [np.full((4, 5, 3), k / 10, np.float32) for k in range(5)]
    grid = make_grid(ims, nrow=3, pad=1)
    assert grid.shape == (2 * 5 + 1, 3 * 6 + 1, 3)
    assert grid[1, 1, 0] == 0.0 and grid[6, 7, 0] == np.float32(0.4)
