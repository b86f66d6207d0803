"""PyTorch port: the PIL-free PNG codec and LANCZOS resize against PIL
(imported here only; the port never imports it).

``read_png`` must equal PIL's ``Image.open(p).convert("RGB")`` exactly, on
the RainDrop test split and on PNGs built here with every row filter and
colour type.  ``resize_lanczos`` must equal ``Image.resize(size,
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
from wavedm_tpu_torch.utils.images import (make_grid, read_png,
                                           resize_lanczos, save_image,
                                           to_uint8, write_png)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAINDROP = sorted(glob.glob(os.path.join(
    REPO, "data", "raindrop", "raindrop_test", "*", "*.png")))
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples a pixel


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


def _unsupported(tmp_path, case):
    path = str(tmp_path / f"{case}.png")
    rgb = np.zeros((6, 6, 3), np.uint8)
    if case == "palette":
        Image.fromarray(rgb).convert("P").save(path)
    elif case == "grey_alpha":
        Image.fromarray(rgb).convert("LA").save(path)
    elif case == "16bit":
        Image.fromarray(np.zeros((6, 6), np.uint16)).save(path)
    elif case == "adam7":
        _build_png(path, rgb, 2, [0] * 6, interlace=1)
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
    ("palette", "colour type 3"), ("grey_alpha", "colour type 4"),
    ("16bit", "bit depth 16"),
    ("adam7", "interlace"), ("jpeg", "not a PNG"), ("bad_crc", "CRC"),
    ("truncated", "truncated"),
])
def test_unsupported_pngs_raise_naming_file_and_field(tmp_path, case, field):
    path = _unsupported(tmp_path, case)
    with pytest.raises(ValueError, match=field) as err:
        read_png(path)
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
