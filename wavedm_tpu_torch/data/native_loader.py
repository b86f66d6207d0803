"""ctypes bindings of the port's data library (``native/wavedm_data.cc``).

The port of ``wavedm_tpu/data/native_loader.py``, with its signatures and
its errors: JPEG/PNG decode and the training crop stream, assembled by a
pool of native threads into the (n * patch_n, P, P, 6) float32 batch the
train step takes.  The library is built from the port's own copy of the
source at first use (``native/build.py``); :func:`available` says whether
it is built or can be, and :func:`unavailable_reason` why not.
:func:`decode_bytes` decodes a JPEG or PNG held in memory to uint8, for the
server.  Every call releases the interpreter lock while the library runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from wavedm_tpu_torch.native import build

__all__ = ["available", "unavailable_reason", "decode_image", "decode_bytes",
           "make_crop_batch", "MAX_PIXELS"]

# the most pixels a header may claim before decode_bytes allocates for it:
# PIL's decompression-bomb limit (an error above twice
# ``Image.MAX_IMAGE_PIXELS``), which JAX's server meets on the same body
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def available() -> bool:
    """True when the library is built or builds now; False only when the
    compiler or a header is missing.  A failed build with both present
    raises."""
    if build.unavailable_reason() is not None:
        return False
    build.library()
    return True


def unavailable_reason() -> Optional[str]:
    return build.unavailable_reason()


def _int_out():
    return ctypes.c_int(), ctypes.c_int()


def decode_image(path: str, max_h: int = 4096,
                 max_w: int = 4096) -> np.ndarray:
    """Decode one JPEG/PNG to float32 [0,1] HWC RGB (``uint8 * (1/255)``
    in float32, as the JAX package's library computes it); raises
    ``IOError`` when it does not decode (rc 1) or exceeds ``max_h`` x
    ``max_w`` (rc 2)."""
    lib = build.library()
    h, w = _int_out()
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise IOError(f"native decode failed (rc=1) for {path}") from e
    rc = lib.wdm_image_size_mem(data, len(data), ctypes.byref(h),
                                ctypes.byref(w))
    if rc == 0 and (h.value > max_h or w.value > max_w):
        rc = 2
    if rc == 0:                 # a buffer of the header's size exactly
        buf = np.empty((h.value, w.value, 3), np.float32)
        rc = lib.wdm_decode_image(path.encode(), buf.ctypes.data, h.value,
                                  w.value, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"native decode failed (rc={rc}) for {path}")
    return buf


def decode_bytes(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An encoded JPEG or PNG held in memory -> (H, W, 3) uint8 RGB;
    raises ``ValueError`` naming ``name`` when it does not decode, or when
    its header claims more than :data:`MAX_PIXELS` pixels (refused before
    anything is allocated for them)."""
    lib = build.library()
    h, w = _int_out()
    if lib.wdm_image_size_mem(data, len(data), ctypes.byref(h),
                              ctypes.byref(w)) != 0:
        raise ValueError(f"{name}: not a JPEG or PNG the data library "
                         "decodes (header)")
    if h.value * w.value > MAX_PIXELS:
        raise ValueError(f"{name}: its header claims {w.value}x{h.value} = "
                         f"{h.value * w.value} pixels, above the "
                         f"{MAX_PIXELS} a body may have (PIL's "
                         "decompression-bomb limit)")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.wdm_decode_mem(data, len(data), out.ctypes.data, h.value,
                            w.value, ctypes.byref(h), ctypes.byref(w))
    if rc != 0 or out.shape[:2] != (h.value, w.value):
        raise ValueError(f"{name}: the data library failed to decode it "
                         f"(rc={rc})")
    return out


def make_crop_batch(input_paths: Sequence[str], gt_paths: Sequence[str],
                    patch_n: int, patch: int, seed: int,
                    n_threads: int = 0) -> np.ndarray:
    """Decode image pairs and assemble the training crop batch natively.

    Returns (len(paths)*patch_n, patch, patch, 6) float32 [cond|gt] in
    [0,1]: for the pair in slot k, ``patch_n`` crops at coordinates drawn
    from ``mt19937_64(Mix(seed, k))``, y before x.  Raises ``IOError`` when
    a pair fails to decode, differs in size or is smaller than the patch.
    """
    lib = build.library()
    n = len(input_paths)
    if len(gt_paths) != n:
        raise ValueError(f"{n} inputs but {len(gt_paths)} ground truths")
    out = np.zeros((n * patch_n, patch, patch, 6), np.float32)
    arr_t = ctypes.c_char_p * n
    inp = arr_t(*[p.encode() for p in input_paths])
    gts = arr_t(*[p.encode() for p in gt_paths])
    ok = lib.wdm_make_crop_batch(inp, gts, n, patch_n, patch,
                                 ctypes.c_uint64(seed), n_threads,
                                 out.ctypes.data)
    if ok != n:
        raise IOError(f"native batch: only {ok}/{n} image pairs decoded")
    return out
