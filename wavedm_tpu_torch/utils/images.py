"""Image I/O: a PNG reader and writer and a BMP reader on ``zlib``/``struct``
and numpy, JPEG through the port's data library, every other format
through PIL (imported only when such a file comes), PIL's LANCZOS and
BILINEAR resamples in numpy, and the dump helpers of
``wavedm_tpu/utils/images.py``.

Every reader returns (H, W, 3) uint8 RGB equal to PIL's
``Image.open(...).convert("RGB")``, which the JAX package's server, data
path and restore CLI use; errors are ``ValueError`` naming the file and
the reason.

- ``decode_image`` (``read_image`` for a file) picks the decoder by the
  signature, by a fixed rule (:func:`image_decoder` says which):
  PNG (every encoding) and BMP by the port's numpy decoders; JPEG
  (``FF D8``) by the port's data library
  (``data/native_loader.decode_bytes``: its own decoder, equal to
  libjpeg-turbo's output, built wherever a C++ compiler and zlib are, the
  card's machine included), and by PIL only where that library is
  unavailable; everything else by PIL, as JAX opens it: WebP (lossy,
  lossless, with alpha), GIF (its first frame), TIFF and the rest.  A
  file that PIL cannot identify, a machine without PIL, and a PIL built
  without the format's codec each raise naming why; an error of the data
  library on a JPEG is raised, not retried by PIL.
- ``decode_png`` (``read_png`` for a file) takes every PNG: colour types
  0 (grey at 1, 2, 4, 8 or 16 bits), 2 (RGB), 3 (palette at 1, 2, 4 or 8
  bits; an index past the PLTE reads black), 4 (grey + alpha) and 6
  (RGBA) at 8 or 16 bits, plain or Adam7-interlaced.  Alpha and tRNS are
  dropped, grey is replicated, grey below 8 bits is scaled to 0..255
  (1 bit: x255, 2: x85, 4: x17), 16-bit RGB, RGBA and grey + alpha keep
  the high byte, and 16-bit grey is clipped at 255, as PIL's "I;16" mode
  converts (libpng, and so the data library's PNG decoder, keeps the
  high byte there).
  All five row filters are undone; Sub and Up vectorise per row, Average
  and Paeth run a Python loop (the RainDrop test split uses only Sub and
  Up).  ``encode_png`` (``write_png`` for a file) writes an RGB image as
  one IDAT with filter 0 (None) or 2 (Up) on every row.
- ``decode_bmp`` takes uncompressed (``BI_RGB``) BMPs at 24 and 32 bits
  (the fourth byte dropped) and 8-bit palette ones, rows bottom-up or
  top-down.

``resize_lanczos`` and ``resize_bilinear`` are PIL's ``Image.resize``
with ``Image.LANCZOS`` and ``Image.BILINEAR`` on a uint8 image: a
support-3 Lanczos window or the support-1 triangle, widened by the scale
when shrinking, coefficients normalized per output pixel and rounded to
22-bit fixed point, the horizontal pass first, each pass rounding and
clipping to uint8.
"""

from __future__ import annotations

import io
import math
import os
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

__all__ = ["to_uint8", "save_image", "make_grid", "read_image",
           "decode_image", "image_decoder", "read_png", "write_png",
           "decode_png", "encode_png", "decode_bmp", "resize_lanczos",
           "resize_bilinear"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}                       # colour type -> its bit depths
# Adam7's seven passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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
    """A PNG file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _unfilter(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """Undo the row filters of (h, 1 + stride) uint8 rows -> (h, stride)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
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
    return out


def _samples(rows: np.ndarray, w: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered (h, stride) rows -> (h, w, channels) samples: uint8 up to
    8 bits (unscaled), uint16 at 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    if depth == 16:
        pairs = rows[:, :w * channels * 2].reshape(h, w, channels, 2)
        return (pairs[..., 0].astype(np.uint16) << 8) | pairs[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[..., None]


def _to_rgb(img: np.ndarray, colour: int, depth: int,
            palette: bytes) -> np.ndarray:
    """(H, W, channels) samples -> (H, W, 3) uint8 as PIL's
    ``convert("RGB")``."""
    if colour == 3:
        table = np.zeros((256, 3), np.uint8)       # past the PLTE: black
        entries = np.frombuffer(palette, np.uint8)[:768].reshape(-1, 3)
        table[:len(entries)] = entries
        return table[img[..., 0]]
    if depth == 16:
        img = (np.minimum(img, 255) if colour == 0 else img >> 8
               ).astype(np.uint8)
    elif depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if colour in (0, 4):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of a PNG -> (H, W, 3) uint8 RGB, as PIL's
    ``convert("RGB")``; errors name ``name``."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file (signature)")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(name, data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype[0] & 0x20 == 0 and ctype != b"IEND":
            raise ValueError(f"{name}: unknown critical chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: colour type {colour} is not PNG's")
    if depth not in _DEPTHS[colour]:
        raise ValueError(f"{name}: bit depth {depth} is not valid for "
                         f"colour type {colour}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: interlace method {interlace} is not "
                         "PNG's")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{name}: compression/filter method "
                         f"{compression}/{filtering} is not PNG's")
    if colour == 3 and (palette is None or len(palette) % 3):
        raise ValueError(f"{name}: colour type 3 (palette) without a valid "
                         "PLTE chunk")
    channels = _CHANNELS[colour]
    bits = channels * depth
    bpp = max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    passes = _passes(w, h, interlace)
    want = sum(ph * ((pw * bits + 7) // 8 + 1) for *_, pw, ph in passes)
    if len(raw) != want:
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, "
                         f"IHDR asks for {want}")
    img = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = (pw * bits + 7) // 8
        rows = np.frombuffer(raw, np.uint8, ph * (stride + 1),
                             pos).reshape(ph, stride + 1)
        pos += rows.size
        img[y0::dy, x0::dx] = _samples(_unfilter(rows, bpp, name), pw,
                                       channels, depth)
    return _to_rgb(img, colour, depth, palette)


def _passes(w: int, h: int, interlace: int):
    """(x0, y0, dx, dy, width, height) of each non-empty pass: the whole
    image, or Adam7's seven (an empty pass holds no bytes)."""
    out = []
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


# ------------------------------------------------------------------- BMP

def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of an uncompressed BMP (24 or 32 bits, or 8-bit palette)
    -> (H, W, 3) uint8 RGB; errors name ``name``."""
    if len(data) < 54 or not data.startswith(b"BM"):
        raise ValueError(f"{name}: not a BMP file (signature or headers "
                         "truncated)")
    (offset,) = struct.unpack_from("<I", data, 10)
    (info_size,) = struct.unpack_from("<I", data, 14)
    if info_size < 40:
        raise ValueError(f"{name}: BMP info header of {info_size} bytes "
                         "(OS/2) is not supported")
    w, h, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    (colours,) = struct.unpack_from("<I", data, 46)
    if compression != 0:
        raise ValueError(f"{name}: BMP compression {compression} is not "
                         "supported (0, BI_RGB, only)")
    if bits not in (8, 24, 32):
        raise ValueError(f"{name}: BMP bit count {bits} is not supported "
                         "(8, 24 or 32)")
    if w <= 0 or h == 0:
        raise ValueError(f"{name}: BMP size {w}x{h}")
    top_down, h = h < 0, abs(h)
    stride = (w * bits + 31) // 32 * 4
    if len(data) < offset + stride * h:
        raise ValueError(f"{name}: truncated BMP (pixel data)")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        n = colours or 256
        if 14 + info_size + 4 * n > offset or n > 256:
            raise ValueError(f"{name}: BMP colour table of {n} entries "
                             "does not fit before the pixels")
        table = np.frombuffer(data, np.uint8, 4 * n,
                              14 + info_size).reshape(n, 4)[:, 2::-1]
        index = rows[:, :w]
        if int(index.max()) >= n:
            raise ValueError(f"{name}: BMP palette index {index.max()} past "
                             f"its {n} colours")
        return np.ascontiguousarray(table[index])
    nb = bits // 8
    return np.ascontiguousarray(rows[:, :w * nb].reshape(h, w, nb)[..., 2::-1])


# ------------------------------------------------------- by the signature

# formats PIL reads only with an optional codec: its ``features`` name
_PIL_CODECS = {"JPEG": "jpg", "WebP": "webp"}


def _format(data: bytes) -> str:
    """The format a signature names (``other``: left to PIL to identify)."""
    if data.startswith(_PNG_SIGNATURE):
        return "PNG"
    if data.startswith(b"BM"):
        return "BMP"
    if data.startswith(b"\xff\xd8"):
        return "JPEG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return "other"


def image_decoder(data: bytes) -> Tuple[str, str]:
    """(format, decoder) of what :func:`decode_image` does with ``data``:
    ``numpy`` for PNG and BMP, ``data library`` for JPEG where
    ``native_loader.unavailable_reason()`` is None, else ``PIL``."""
    fmt = _format(data)
    if fmt in ("PNG", "BMP"):
        return fmt, "numpy"
    if fmt == "JPEG":
        from wavedm_tpu_torch.data import native_loader

        if native_loader.unavailable_reason() is None:
            return fmt, "data library"
    return fmt, "PIL"


def _decode_pil(data: bytes, name: str, fmt: str, why: str) -> np.ndarray:
    """PIL's ``Image.open(...)``, converted to RGB where its mode is not,
    as the JAX package opens every image; ``why`` says why PIL decodes
    this format here, for the errors."""
    try:
        from PIL import Image, UnidentifiedImageError, features
    except ImportError as e:
        raise ValueError(f"{name}: {why}, and PIL is not installed "
                         f"({e})") from e
    import PIL

    codec = _PIL_CODECS.get(fmt)
    if codec is not None and not features.check(codec):
        raise ValueError(f"{name}: {why}, and this PIL ({PIL.__version__}) "
                         f"was built without the {codec} codec")
    try:
        img = Image.open(io.BytesIO(data))
        img = img.convert("RGB") if img.mode != "RGB" else img
        return np.asarray(img, dtype=np.uint8).copy()
    except UnidentifiedImageError as e:
        raise ValueError(f"{name}: not a PNG, BMP or JPEG by its signature "
                         f"({data[:8]!r}), and PIL cannot identify it") from e
    except (OSError, SyntaxError, ValueError) as e:
        raise ValueError(f"{name}: PIL failed to decode this {fmt} file: "
                         f"{e}") from e


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB (:func:`decode_image`)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of an image -> (H, W, 3) uint8 RGB, decoded as
    :func:`image_decoder` says; errors name ``name``."""
    fmt, decoder = image_decoder(data)
    if fmt == "PNG":
        return decode_png(data, name)
    if fmt == "BMP":
        return decode_bmp(data, name)
    if decoder == "data library":
        from wavedm_tpu_torch.data import native_loader

        return native_loader.decode_bytes(data, name)
    if fmt == "JPEG":
        from wavedm_tpu_torch.data import native_loader

        why = ("JPEG is decoded by PIL where the port's data library is "
               f"unavailable, as here: {native_loader.unavailable_reason()}")
    else:
        why = f"{'this file' if fmt == 'other' else fmt} is decoded by PIL"
    return _decode_pil(data, name, fmt, why)


# ------------------------------------------------------------ PNG writer

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
