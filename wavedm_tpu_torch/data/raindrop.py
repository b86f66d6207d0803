"""The RainDrop dataset, read without PIL: training crops and eval pairs.

The port of ``wavedm_tpu/data/raindrop.py``.  The splits live in
``<data_dir>/raindrop/{train,raindrop_test}/{input,gt}/``; a ground-truth
name is its input's name with "rain" replaced by "clean".  Images are PNG,
JPEG or BMP (``utils/images.read_image``).

- Train: :meth:`RainDrop.train_batches` yields (batch * patch_n, P, P, 6)
  float32 [input | gt] crop batches in [0, 1] from one of three paths,
  picked as JAX picks them:

  1. ``data.device_cache`` (and not ``data.global_attn``): the decoded
     split on the device, cropped there (``data/device_cache.py``);
  2. the native crop stream, by default wherever the port's data library
     is built or builds (``data/native_loader.py``) and
     ``data.global_attn`` is off: each batch of the shuffled order is
     decoded and cropped by native threads, the crops of slot k drawn from
     ``mt19937_64(Mix(batch seed, k))``, the batch seed folding in (seed,
     epoch, batch start).  Its batches equal the JAX package's native
     stream to the byte, and differ from the other two paths' by design;
  3. otherwise (or ``use_native=False``) the streamed PIL-order path: each
     sample draws ``patch_n`` crops from a generator seeded with (seed,
     epoch, index), ys before xs, and the crops are divided by 255.  Paths
     1 and 3 give the same batches, equal to the JAX package's PIL path.

  Paths 2 and 3 run through a depth-2 thread prefetcher.  With
  ``data.global_attn`` a sample also carries its whole input image,
  LANCZOS-resized to 720x480 (once per image, not per crop), and a batch
  is (crops, totals); these batches are always on path 3, as in JAX.
- Eval: each pair at the canonical eval geometry (720x480, capped at 1024,
  rounded up to /16), ``resize_lanczos``-resized where it is not there.
- Each process takes every ``process_count``-th index from
  ``process_index`` (the ranks of a ``torchrun`` world, whose CLIs pass
  them), and its device cache holds that stripe alone.  The epoch number is
  folded into the shuffle seed.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from wavedm_tpu_torch.config import Config
from wavedm_tpu_torch.data import native_loader
from wavedm_tpu_torch.utils.images import read_image, resize_lanczos

__all__ = ["eval_resize_dims", "fit_image", "restore_input",
           "RainDropDataset", "RainDrop"]


TOTAL_SIZE = (720, 480)     # (w, h) of the global UNet's whole image


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


def restore_input(img: np.ndarray, no_resize: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 -> float32 in [0, 1] at the geometry the restore
    entry points run at: the eval protocol's (:func:`eval_resize_dims`),
    or with ``no_resize`` the image's own size rounded up to /16."""
    h, w = img.shape[:2]
    if no_resize:
        size = 16 * ((w + 15) // 16), 16 * ((h + 15) // 16)
    else:
        size = eval_resize_dims(w, h)
    return fit_image(img, size)


def _eval_sample(inp: str, gt: str) -> Tuple[np.ndarray, str]:
    """((H, W, 6) [input | gt] pair at the eval geometry, image id)."""
    img_id = os.path.basename(inp).rsplit(".", 1)[0]
    a, b = read_image(inp), read_image(gt)
    size = eval_resize_dims(a.shape[1], a.shape[0])
    return np.concatenate([fit_image(a, size), fit_image(b, size)],
                          axis=-1), img_id


class RainDropDataset:
    """One split's samples for one process."""

    def __init__(self, root: str, patch_size: int, patch_n: int,
                 parse_patches: bool = True, process_index: int = 0,
                 process_count: int = 1, return_total: bool = False):
        self.inputs, self.gts = _list_pairs(root)
        self.patch_size = patch_size
        self.patch_n = patch_n
        self.parse_patches = parse_patches
        self.return_total = return_total
        self.indices = list(range(process_index, len(self.inputs),
                                  process_count))

    def __len__(self) -> int:
        return len(self.indices)

    def _train_sample(self, idx: int, rng: np.random.Generator):
        """(patch_n, P, P, 6) crops; with ``return_total`` also the
        (1, 480, 720, 3) whole input image."""
        inp, gt = read_image(self.inputs[idx]), read_image(self.gts[idx])
        h, w = inp.shape[:2]
        p = self.patch_size
        ys = rng.integers(0, max(1, h - p + 1), self.patch_n)
        xs = rng.integers(0, max(1, w - p + 1), self.patch_n)
        crops = np.empty((self.patch_n, p, p, 6), dtype=np.uint8)
        for k, (y, x) in enumerate(zip(ys, xs)):
            crops[k, ..., :3] = inp[y:y + p, x:x + p]
            crops[k, ..., 3:] = gt[y:y + p, x:x + p]
        crops = crops.astype(np.float32) / 255.0
        if self.return_total:
            total = resize_lanczos(inp, TOTAL_SIZE).astype(np.float32) / 255.0
            return crops, total[None]
        return crops

    def _eval_sample(self, idx: int) -> Tuple[np.ndarray, str]:
        return _eval_sample(self.inputs[idx], self.gts[idx])

    def epoch(self, epoch: int, seed: int, shuffle: bool = True) -> Iterator:
        """This process's samples for one epoch, shuffled by
        ``default_rng(seed + epoch)``: crops in train mode, (pair, id) in
        eval mode."""
        order = np.array(self.indices)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        for idx in order:
            if self.parse_patches:
                rng = np.random.default_rng((seed, epoch, int(idx)))
                yield self._train_sample(int(idx), rng)
            else:
                yield self._eval_sample(int(idx))


class _Prefetcher:
    """A depth-``depth`` queue filled by one thread, so decoding overlaps
    the device's step.  An exception in the thread is raised again in the
    consumer, after the items queued before it."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self.q.put(item)
            except BaseException as e:    # handed to the consumer
                self.error = e
            finally:
                self.q.put(self._DONE)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item


class RainDrop:
    """The RainDrop splits of ``cfg.data.data_dir`` for one process.

    ``device`` is where the ``data.device_cache`` split lives (the card
    when None); the streamed path yields host arrays."""

    def __init__(self, cfg: Config, process_index: int = 0,
                 process_count: int = 1, device=None):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.device = device
        self._cache = None       # DeviceCropCache, built on first use

    def train_dir(self) -> str:
        return os.path.join(self.cfg.data.data_dir, "raindrop", "train")

    def test_dir(self) -> str:
        return os.path.join(self.cfg.data.data_dir, "raindrop",
                            "raindrop_test")

    def train_batches(self, epoch: int, batch_size: Optional[int] = None,
                      prefetch: bool = True,
                      use_native: Optional[bool] = None) -> Iterator:
        """(batch * patch_n, P, P, 6) float32 crop batches in [0, 1] for
        one epoch: numpy arrays, or tensors on the device with
        ``data.device_cache``.  With ``data.global_attn``, (crops,
        (batch, 480, 720, 3) totals) pairs of numpy arrays, streamed even
        when ``data.device_cache`` is set.  ``use_native`` picks the
        native crop stream (None: wherever the data library is available
        and ``data.global_attn`` is off), after ``data.device_cache``.  A
        last partial batch is dropped."""
        cfg = self.cfg
        use_global = cfg.data.global_attn
        ds = RainDropDataset(self.train_dir(), cfg.data.patch_size,
                             cfg.training.patch_n,
                             process_index=self.process_index,
                             process_count=self.process_count,
                             return_total=use_global)
        bs = batch_size or cfg.training.batch_size
        seed = cfg.training.seed
        if cfg.data.device_cache and not use_global:
            from wavedm_tpu_torch.data.device_cache import build_pair_cache

            if self._cache is None:
                # this process's stripe, row r holding pair ds.indices[r]
                self._cache = build_pair_cache(
                    [ds.inputs[i] for i in ds.indices],
                    [ds.gts[i] for i in ds.indices], cfg.data.patch_size,
                    self.device)
            order = np.array(ds.indices)
            np.random.default_rng(seed + epoch).shuffle(order)
            rows = {idx: r for r, idx in enumerate(ds.indices)}
            buf = []
            for coords in self._cache.draw_coords(order, seed, epoch,
                                                  cfg.training.patch_n,
                                                  rows):
                buf.append(coords)
                if len(buf) == bs:
                    yield self._cache.crop_batch(np.concatenate(buf))
                    buf = []
            return
        if use_native is None:
            # the native stream has crops only: the global path's totals
            # keep it on the PIL-order path
            use_native = native_loader.available() and not use_global
        if use_native:
            it = self._native_batches(ds, epoch, bs)
        else:
            it = self._streamed_batches(ds, epoch, bs, use_global)
        yield from (_Prefetcher(it) if prefetch else it)

    def _native_batches(self, ds: RainDropDataset, epoch: int,
                        bs: int) -> Iterator[np.ndarray]:
        """JAX's native stream: batch ``order[s:s + bs]`` of the shuffled
        order, its crops seeded by (seed, epoch, s)."""
        cfg = self.cfg
        order = np.array(ds.indices)
        np.random.default_rng(cfg.training.seed + epoch).shuffle(order)
        for s in range(0, len(order) - bs + 1, bs):
            idxs = order[s:s + bs]
            yield native_loader.make_crop_batch(
                [ds.inputs[i] for i in idxs], [ds.gts[i] for i in idxs],
                patch_n=cfg.training.patch_n, patch=cfg.data.patch_size,
                seed=(cfg.training.seed * 100003 + epoch) * 1000003 + s,
                n_threads=cfg.data.num_workers)

    def _streamed_batches(self, ds: RainDropDataset, epoch: int, bs: int,
                          use_global: bool) -> Iterator:
        buf = []
        for sample in ds.epoch(epoch, self.cfg.training.seed):
            buf.append(sample)
            if len(buf) == bs:
                if use_global:
                    yield (np.concatenate([c for c, _ in buf], axis=0),
                           np.concatenate([t for _, t in buf], axis=0))
                else:
                    yield np.concatenate(buf, axis=0)
                buf = []

    def eval_samples(self) -> Iterator[Tuple[np.ndarray, str]]:
        """((H, W, 6) pair, image_id) for each test pair of this process,
        in name order."""
        ds = RainDropDataset(self.test_dir(), self.cfg.data.patch_size,
                             self.cfg.training.patch_n, parse_patches=False,
                             process_index=self.process_index,
                             process_count=self.process_count)
        yield from ds.epoch(0, 0, shuffle=False)
