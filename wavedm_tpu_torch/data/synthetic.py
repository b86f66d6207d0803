"""Synthetic paired-image source for smoke runs (numpy only).

The port's own copy of ``wavedm_tpu/data/synthetic.py``: deterministic
degraded/clean pairs with raindrop-like blob degradations, so the training
loss is meaningful without the RainDrop dataset on disk.  The same seed
gives the same pairs as the JAX package's copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticPairs:
    """Yields (cond, gt) uint8-like float arrays in [0, 1], NHWC.

    ``severity``: "light" (default; a couple dozen local blobs -- input PSNR
    ~48 dB, fine for smoke tests and benchmarks) or "heavy" (dense blobs +
    global haze + rain streaks -- input PSNR ~20 dB, leaving real headroom
    for a restorer; used by tools/make_synthetic_dataset.py for the
    dress-rehearsal dataset)."""

    def __init__(self, height: int = 480, width: int = 720, n_images: int = 16,
                 seed: int = 61, severity: str = "light"):
        self.height, self.width, self.n_images = height, width, n_images
        self.seed = seed
        if severity not in ("light", "heavy"):
            raise ValueError(f"unknown severity {severity!r}")
        self.severity = severity

    def _make_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1000 + idx)
        h, w = self.height, self.width
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        gt = np.stack([
            0.5 + 0.4 * np.sin(2 * np.pi * (xx / w * (i + 1) + yy / h * (2 - i))
                               + rng.uniform(0, 6.28))
            for i in range(3)
        ], axis=-1).astype(np.float32)
        gt = np.clip(gt + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)
        # raindrop-like blobs on the degraded version
        cond = gt.copy()
        # heavy mode leans on GLOBAL degradations (haze, streaks) that a
        # restorer can actually invert; blob destruction is local information
        # loss, so it stays moderate
        heavy = self.severity == "heavy"
        n_blobs = 48 if heavy else 24
        r_lo, r_hi = (8, 30) if heavy else (6, 24)
        for _ in range(n_blobs):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = rng.integers(r_lo, r_hi)
            y0, y1 = max(0, cy - r), min(h, cy + r)
            x0, x1 = max(0, cx - r), min(w, cx + r)
            dist = ((np.arange(y0, y1)[:, None] - cy) ** 2
                    + (np.arange(x0, x1)[None, :] - cx) ** 2) / float(r * r)
            mask = np.clip(1.0 - dist, 0, 1)[..., None].astype(np.float32)
            blur = cond[y0:y1, x0:x1].mean(axis=(0, 1), keepdims=True)
            cond[y0:y1, x0:x1] = (1 - 0.8 * mask) * cond[y0:y1, x0:x1] + 0.8 * mask * blur
        if heavy:
            # global haze towards the mean + diagonal rain streaks
            haze = cond.mean(axis=(0, 1), keepdims=True)
            cond = 0.62 * cond + 0.38 * haze
            streaks = rng.random((h, w)) < 0.003
            ys, xs = np.nonzero(streaks)
            for sy, sx in zip(ys, xs):
                ln = int(rng.integers(8, 28))
                for k in range(ln):
                    py, px = sy + k, sx + k // 2
                    if py < h and px < w:
                        cond[py, px] = 0.85 * cond[py, px] + 0.15
            cond = np.clip(
                cond + 0.02 * rng.standard_normal((h, w, 3)).astype(np.float32),
                0, 1)
        return cond.astype(np.float32), gt

    def __len__(self) -> int:
        return self.n_images

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._make_pair(idx % self.n_images)
