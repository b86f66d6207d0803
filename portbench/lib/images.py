"""The benchmark's own reader of its input images: 8-bit PNG (grey, RGB,
grey + alpha, RGBA; not interlaced), over ``zlib`` and numpy.

Rows filtered with None, Sub or Up, all that the RainDrop test images
use, are undone a row at a time in numpy (about 10 ms a 720x480 image);
a file with Average or Paeth rows is refused.
"""

from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

__all__ = ["decode_png", "load_images"]

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(kind: int, row: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:
        return row + prev
    raise ValueError(f"PNG row filter {kind} (Average or Paeth) is not read "
                     "here")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = head
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{color}, interlace {interlace}")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    out = np.empty((h, w * ch), np.uint8)
    prev = np.zeros(w * ch, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, ch)
    return out.reshape(h, w, ch)


def load_images(paths: List[str]) -> np.ndarray:
    """The images at ``paths`` as one (N, H, W, C) uint8 array."""
    arrays = []
    for p in paths:
        with open(p, "rb") as f:
            arrays.append(decode_png(f.read()))
    return np.stack(arrays)
