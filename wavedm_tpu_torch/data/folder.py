"""Paired input/gt image folders.

The port of ``wavedm_tpu/data/folder.py``: sorted ``input/`` and ``gt/``
listings, an optional random crop shared by both images of a pair, an
optional BILINEAR resize (``utils/images.resize_bilinear``), and under a
root whose path names "raindrop" the 720x480 enforcement when neither is
on.  Images are whatever ``utils/images.read_image`` reads: what JAX's
PIL opens.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from wavedm_tpu_torch.utils.images import read_image, resize_bilinear

__all__ = ["PairedImageFolder"]


def _crop(img: np.ndarray, y: int, x: int, size: int) -> np.ndarray:
    """A size x size window at (y, x), zero beyond the image (as PIL's
    ``crop``)."""
    out = np.zeros((size, size, img.shape[2]), img.dtype)
    win = img[y:y + size, x:x + size]
    out[:win.shape[0], :win.shape[1]] = win
    return out


class PairedImageFolder:
    def __init__(self, root: str, crop: bool = True, resize: bool = True,
                 crop_size: int = 480, resize_size: int = 256,
                 process_index: int = 0, process_count: int = 1):
        self.root = root
        self.crop = crop
        self.resize = resize
        self.crop_size = crop_size
        self.resize_size = resize_size
        inp_dir = os.path.join(root, "input")
        gt_dir = os.path.join(root, "gt")
        self.inputs = sorted(os.path.join(inp_dir, f)
                             for f in os.listdir(inp_dir))
        self.gts = sorted(os.path.join(gt_dir, f) for f in os.listdir(gt_dir))
        if len(self.inputs) != len(self.gts):
            raise ValueError(f"{root}: {len(self.inputs)} inputs but "
                             f"{len(self.gts)} ground truths")
        self.indices = list(range(process_index, len(self.inputs),
                                  process_count))

    def __len__(self) -> int:
        return len(self.indices)

    def load_pair(self, idx: int,
                  rng: Optional[np.random.Generator] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(input, gt) as (H, W, 3) float32 in [0, 1]; the crop draws x
        then y from ``rng``."""
        a, b = read_image(self.inputs[idx]), read_image(self.gts[idx])
        h, w = a.shape[:2]
        if self.crop:
            rng = rng or np.random.default_rng()
            cs = self.crop_size
            x = int(rng.integers(0, max(1, w - cs + 1)))
            y = int(rng.integers(0, max(1, h - cs + 1)))
            a, b = _crop(a, y, x, cs), _crop(b, y, x, cs)
        if self.resize:
            rs = (self.resize_size, self.resize_size)
            a, b = resize_bilinear(a, rs), resize_bilinear(b, rs)
        if ("raindrop" in self.root and not self.crop and not self.resize
                and a.shape[:2] != (480, 720)):
            a = resize_bilinear(a, (720, 480))
            b = resize_bilinear(b, (720, 480))
        return a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0

    def batches(self, batch_size: int, epoch: int, seed: int,
                shuffle: bool = True) -> Iterator[np.ndarray]:
        """(B, H, W, 6) [input | gt] batches for one epoch, shuffled by
        ``default_rng(seed + epoch)``; each pair's crop from
        ``default_rng((seed, epoch, index))``.  A last partial batch is
        dropped."""
        order = np.array(self.indices)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        buf = []
        for idx in order:
            rng = np.random.default_rng((seed, epoch, int(idx)))
            a, b = self.load_pair(int(idx), rng)
            buf.append(np.concatenate([a, b], axis=-1))
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
