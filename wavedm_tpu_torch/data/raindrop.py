"""RainDrop evaluation pairs, read without PIL.

The evaluation side of ``wavedm_tpu/data/raindrop.py``: the test split
lives in ``<data_dir>/raindrop/raindrop_test/{input,gt}/``; a ground-truth
name is its input's name with "rain" replaced by "clean".  Each pair is
read as PNG (``utils/images.read_png``) and brought to the canonical eval
geometry (720x480, capped at 1024, rounded up to /16) by
``resize_lanczos`` where it is not there already.  The training side
(random crops, the native loader, the device cache) is not ported
(ROADMAP item 17), and neither is the multi-process split (item 13).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.utils.images import read_png, resize_lanczos

__all__ = ["eval_resize_dims", "fit_image", "RainDrop"]


def _list_pairs(root: str) -> Tuple[List[str], List[str]]:
    """input/ and gt/ paths; gt names derive from input names by the
    rain -> clean substitution."""
    inp_dir = os.path.join(root, "input")
    gt_dir = os.path.join(root, "gt")
    names = sorted(f for f in os.listdir(inp_dir)
                   if os.path.isfile(os.path.join(inp_dir, f)))
    inputs = [os.path.join(inp_dir, f) for f in names]
    gts = [os.path.join(gt_dir, f.replace("rain", "clean")) for f in names]
    return inputs, gts


def eval_resize_dims(w: int, h: int) -> Tuple[int, int]:
    """The canonical eval size (w, h): 720x480 whatever the input (the
    reference's protocol), capped at 1024 and rounded up to /16."""
    w, h = 720, 480
    if h > w and h > 1024:
        w, h = int(np.ceil(w * 1024 / h)), 1024
    elif h <= w and w > 1024:
        w, h = 1024, int(np.ceil(h * 1024 / w))
    return int(16 * np.ceil(w / 16.0)), int(16 * np.ceil(h / 16.0))


def fit_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) float32 in [0, 1] at (w, h) = ``size``,
    LANCZOS-resized only where the geometry differs."""
    if (img.shape[1], img.shape[0]) != tuple(size):
        img = resize_lanczos(img, size)
    return img.astype(np.float32) / 255.0


def _eval_sample(inp: str, gt: str) -> Tuple[np.ndarray, str]:
    """((H, W, 6) [input | gt] pair at the eval geometry, image id)."""
    img_id = os.path.basename(inp).rsplit(".", 1)[0]
    a, b = read_png(inp), read_png(gt)
    size = eval_resize_dims(a.shape[1], a.shape[0])
    return np.concatenate([fit_image(a, size), fit_image(b, size)],
                          axis=-1), img_id


class RainDrop:
    """The RainDrop test split of ``cfg.data.data_dir``."""

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def test_dir(self) -> str:
        return os.path.join(self.cfg.data.data_dir, "raindrop",
                            "raindrop_test")

    def eval_samples(self) -> Iterator[Tuple[np.ndarray, str]]:
        """((H, W, 6) pair, image_id) for each test pair, in name order."""
        for inp, gt in zip(*_list_pairs(self.test_dir())):
            yield _eval_sample(inp, gt)
