"""Image I/O without PIL: a PNG reader and writer on ``zlib``/``struct`` and
numpy, PIL's LANCZOS and BILINEAR resamples in numpy, and the dump helpers of
``wavedm_tpu/utils/images.py``.

``decode_png`` (``read_png`` for a file) takes 8-bit, non-interlaced PNGs
of colour type 0 (grey), 2 (RGB) or 6 (RGBA) and returns (H, W, 3) uint8
RGB, the alpha dropped and grey replicated as PIL's ``convert("RGB")``
does.  All five row filters are undone; Sub and Up vectorise per row, Average and
Paeth run a Python loop (the RainDrop test split uses only Sub and Up).
Palette images, other bit depths, Adam7 interlacing and other formats
raise ``ValueError`` naming the file and the field.  ``encode_png``
(``write_png`` for a file) writes an RGB image as one IDAT with filter 0
(None) or 2 (Up) on every row.

``resize_lanczos`` and ``resize_bilinear`` are PIL's ``Image.resize``
with ``Image.LANCZOS`` and ``Image.BILINEAR`` on a uint8 image: a
support-3 Lanczos window or the support-1 triangle, widened by the scale
when shrinking, coefficients normalized per output pixel and rounded to
22-bit fixed point, the horizontal pass first, each pass rounding and
clipping to uint8.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

__all__ = ["to_uint8", "save_image", "make_grid", "read_png", "write_png",
           "decode_png", "encode_png", "resize_lanczos", "resize_bilinear"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}            # colour type -> samples a pixel
_PRECISION_BITS = 32 - 8 - 2             # PIL's fixed-point coefficients


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float HWC -> uint8."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_image(img: np.ndarray, path: str) -> None:
    """Save an HWC [0,1] float (or uint8) image as PNG, creating
    directories."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG is written")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img if img.dtype == np.uint8 else to_uint8(img))


def make_grid(images: Sequence[np.ndarray], nrow: int = 4,
              pad: int = 2) -> np.ndarray:
    """Tile HWC [0,1] images into a grid, ``nrow`` images a row."""
    n = len(images)
    h, w, c = images[0].shape
    nr = (n + nrow - 1) // nrow
    grid = np.zeros((nr * (h + pad) + pad, nrow * (w + pad) + pad, c),
                    dtype=np.float32)
    for k, im in enumerate(images):
        r, cl = divmod(k, nrow)
        y = pad + r * (h + pad)
        x = pad + cl * (w + pad)
        grid[y:y + h, x:x + w] = im
    return grid


# ------------------------------------------------------------------- PNG

def _chunks(name: str, data: bytes):
    """(type, body) of each chunk, CRCs checked, up to IEND."""
    pos = len(_PNG_SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: chunk {ctype!r} is corrupt (CRC)")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length


def _unfilter_average(line: np.ndarray, prev: np.ndarray,
                      bpp: int) -> np.ndarray:
    cur, up = bytearray(line.tobytes()), prev.tobytes()
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter_paeth(line: np.ndarray, prev: np.ndarray,
                    bpp: int) -> np.ndarray:
    cur, up = bytearray(line.tobytes()), prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of an 8-bit PNG -> (H, W, 3) uint8 RGB; errors name
    ``name``."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file (signature); only PNG "
                         "input is supported")
    header, idat = None, []
    for ctype, body in _chunks(name, data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype[0] & 0x20 == 0 and ctype not in (b"PLTE", b"IEND"):
            raise ValueError(f"{name}: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour not in _CHANNELS:
        kind = " (palette)" if colour == 3 else ""
        raise ValueError(f"{name}: colour type {colour}{kind} is not "
                         "supported")
    if depth != 8:
        raise ValueError(f"{name}: bit depth {depth} is not supported "
                         "(8 only)")
    if interlace != 0:
        raise ValueError(f"{name}: interlace method {interlace} (Adam7) is "
                         "not supported")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{name}: compression/filter method "
                         f"{compression}/{filtering} is not PNG's")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, "
                         f"IHDR asks for {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = line + prev
        elif kind == 3:
            out[y] = _unfilter_average(line, prev, bpp)
        elif kind == 4:
            out[y] = _unfilter_paeth(line, prev, bpp)
        else:
            raise ValueError(f"{name}: row {y} has filter type {kind}")
        prev = out[y]
    img = out.reshape(h, w, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG file
    (:func:`encode_png`)."""
    data = encode_png(img, filter_type, path)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray, filter_type: int = 2,
               name: str = "encode_png") -> bytes:
    """An (H, W, 3) uint8 image -> the bytes of an 8-bit RGB PNG, every row
    with ``filter_type`` 0 (None) or 2 (Up), one IDAT; errors name
    ``name``."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{name}: write_png takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    if filter_type not in (0, 2):
        raise ValueError(f"{name}: filter type {filter_type} (0 or 2)")
    h, w, _ = img.shape
    rows = np.ascontiguousarray(img).reshape(h, w * 3)
    if filter_type == 2:
        rows = rows - np.concatenate([np.zeros_like(rows[:1]), rows[:-1]])
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


# ------------------------------------------------------------- resampling

def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


# PIL's filters: (function, support at scale 1)
LANCZOS = (_lanczos, 3.0)
BILINEAR = (_triangle, 1.0)


def _coeffs(in_size: int, out_size: int, resample
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(out_size, ksize) source indices and int64 22-bit coefficients of
    one resample pass, computed in double as PIL's precompute_coeffs."""
    fn, base_support = resample
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    index = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    one = 1 << _PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        index[xx, :xmax] = np.arange(xmin, xmin + xmax)
        kk[xx, :xmax] = [int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
                         for v in k]
    return index, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   resample) -> np.ndarray:
    """One uint8 pass along ``axis`` (0: rows, 1: columns) of (H, W, C)."""
    index, kk = _coeffs(img.shape[axis], out_size, resample)
    src = img.astype(np.int64)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(index.shape[1]):
        acc += np.take(src, index[:, j], axis=axis) * kk[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, size: Tuple[int, int], resample,
            name: str) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"{name} takes an (H, W, C) uint8 image")
    w, h = size
    if img.shape[1] != w:
        img = _resample_axis(img, w, 1, resample)
    if img.shape[0] != h:
        img = _resample_axis(img, h, 0, resample)
    return img


def resize_lanczos(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for ``size`` = (w, h), as PIL's
    ``Image.resize(size, Image.LANCZOS)``."""
    return _resize(img, size, LANCZOS, "resize_lanczos")


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for ``size`` = (w, h), as PIL's
    ``Image.resize(size, Image.BILINEAR)``."""
    return _resize(img, size, BILINEAR, "resize_bilinear")
