"""The decoded training split resident on the device, cropped there.

The port of ``wavedm_tpu/data/device_cache.py``.  The split is decoded once
(``utils/images.read_png``) and uploaded as one (N, H, W, 6) uint8 tensor
(RainDrop's 192 training pairs at 720x480: 398 MB).  A step's crops are
then one gather on the device driven by a (B, 3) int32 array of
[image, y, x] rows, so a step moves a few hundred bytes from the host
instead of its crops.  The coordinates come from the streamed path's
generator (per (seed, epoch, image), ys before xs), so both paths give the
same batches.
"""

from __future__ import annotations

from typing import Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from wavedm_tpu_torch.config import ConfigError
from wavedm_tpu_torch.utils.images import read_png

__all__ = ["to_unit", "DeviceCropCache", "build_pair_cache"]


def to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 ``x / 255``, correctly rounded on every device as
    numpy's division is.  (On CUDA, dividing by a Python number multiplies
    by its float32 reciprocal, one ulp off in about half the values.)"""
    return x.float() / torch.tensor(255.0, device=x.device)


class DeviceCropCache:
    """(N, H, W, 6) uint8 [input | gt] pairs on ``device`` (the card when
    None); :meth:`crop_batch` returns (B, P, P, 6) float32 crops in
    [0, 1] there."""

    def __init__(self, pairs_uint8: np.ndarray, patch_size: int,
                 device=None):
        from wavedm_tpu_torch.inference.loader import resolve_device

        pairs = np.asarray(pairs_uint8)
        if pairs.dtype != np.uint8 or pairs.ndim != 4:
            raise ValueError("DeviceCropCache takes (N, H, W, C) uint8 pairs, "
                             f"got {pairs.shape} {pairs.dtype}")
        self.n, self.h, self.w, self.c = pairs.shape
        self.patch_size = int(patch_size)
        if self.patch_size > min(self.h, self.w):
            raise ValueError(f"patch {self.patch_size} exceeds the images' "
                             f"{self.h}x{self.w}")
        self.device = resolve_device(device)
        self.data = torch.from_numpy(pairs).to(self.device)   # one transfer
        self._offsets = torch.arange(self.patch_size, device=self.device)

    def crop_batch(self, coords: np.ndarray) -> torch.Tensor:
        """coords: (B, 3) int rows [image, y, x] -> (B, P, P, 6) float32
        crops on the device, as ``uint8 / 255`` (:func:`to_unit`)."""
        coords = np.asarray(coords)
        p = self.patch_size
        if (coords.ndim != 2 or coords.shape[1] != 3 or coords.min() < 0
                or coords[:, 0].max() >= self.n
                or coords[:, 1].max() > self.h - p
                or coords[:, 2].max() > self.w - p):
            raise ValueError(f"crop coordinates out of range for {self.n} "
                             f"images of {self.h}x{self.w} and patch {p}")
        c = torch.from_numpy(coords.astype(np.int64)).to(self.device)
        rows = (c[:, 1, None] + self._offsets)[:, :, None]       # (B, P, 1)
        cols = (c[:, 2, None] + self._offsets)[:, None, :]       # (B, 1, P)
        return to_unit(self.data[c[:, 0, None, None], rows, cols])

    def draw_coords(self, order: Sequence[int], seed: int, epoch: int,
                    patch_n: int, rows: Optional[Mapping[int, int]] = None
                    ) -> Iterator[np.ndarray]:
        """(patch_n, 3) int32 coordinates for each image of ``order`` (its
        index in the split), drawn as the streamed path draws its crops;
        ``rows`` maps an index to its row of the cache when the cache holds
        one process's stripe of the split (the index itself otherwise)."""
        p = self.patch_size
        for idx in order:
            rng = np.random.default_rng((seed, epoch, int(idx)))
            ys = rng.integers(0, max(1, self.h - p + 1), patch_n)
            xs = rng.integers(0, max(1, self.w - p + 1), patch_n)
            row = int(idx) if rows is None else rows[int(idx)]
            yield np.stack([np.full(patch_n, row), ys, xs],
                           axis=1).astype(np.int32)


def build_pair_cache(input_paths: List[str], gt_paths: List[str],
                     patch_size: int, device=None) -> DeviceCropCache:
    """Decode every pair once and upload the split as one uint8 tensor;
    raises ``ConfigError`` for a split of mixed geometries."""
    pairs = [np.concatenate([read_png(a), read_png(b)], axis=-1)
             for a, b in zip(input_paths, gt_paths)]
    shapes = {p.shape for p in pairs}
    if len(shapes) > 1:
        raise ConfigError(
            "data.device_cache requires a uniform train-image geometry "
            f"(one HBM-resident (N,H,W,6) tensor); got sizes {sorted(shapes)}."
            " Use the streamed pipeline (device_cache: false) for mixed-size "
            "splits.")
    return DeviceCropCache(np.stack(pairs), patch_size, device)
