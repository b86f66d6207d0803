"""Batched HTTP restoration serving on the card.

The port's counterpart of ``wavedm_tpu/inference/server.py``.  One
device-owner thread microbatches concurrent requests (same geometry, up to
``batch``, within ``window_ms``), runs one restoration on the card and fans
the results back out; the HTTP side is the standard library's
``http.server``.

Endpoints:
  POST /restore     image bytes (what JAX's PIL opens) -> restored PNG bytes
  GET  /healthz     JSON: served/batch stats, queue depth

As in JAX: requests are grouped only with same-shape peers, a mixed queue
serves the group holding the OLDEST request (no geometry starves), and a
short batch is padded to the fixed ``batch`` by repeating its last image,
so the card always runs one batch shape per geometry.  The reply is the
restored image at the geometry the request was resized to (720x480 unless
``no_resize``), as JAX replies.

Differences from JAX, by design:
- The listening socket's backlog holds 128 pending connections.  JAX
  listens with the standard library's 5: a burst of more concurrent
  requests than that has connections dropped and retried about a second
  later, which splits a burst that should fill one batch.
- Requests are decoded by ``utils/images.decode_image``: PNG of every
  encoding and BMP in numpy, JPEG through the port's data library (its
  own decoder, equal to libjpeg's; it builds wherever a C++ compiler and
  zlib are, and PIL decodes JPEG only where it cannot), and WebP,
  GIF (its first frame), TIFF and every other format through PIL, as
  JAX's server opens every body.  So the server takes what JAX's takes;
  a body PIL cannot identify, or a format whose codec this machine's PIL
  lacks (or no PIL at all), is answered 500 with a ``ValueError`` naming
  why, where JAX's answers 500 with PIL's error.
- A restorer on the Laplacian path is refused with a ``ValueError``: it
  restores from a [cond | gt] pair, and a request carries no ground truth
  (JAX's server would fail on each request instead).
- x_T comes from one ``torch.Generator`` on the restorer's device, seeded
  with ``rng_seed`` and advanced by each batch's draws, where JAX splits a
  ``PRNGKey`` per batch; the two streams differ, so equal seeds do not give
  equal replies across the packages.

Patch-parallel serving (``cli/serve.py --patch-shard`` under ``torchrun``):
the restorer's chain is split over the ranks of its mesh.  Rank 0 runs the
HTTP server; before each batch's chain its device-owner thread broadcasts
a header (op, B, H, W) and then the batch's pixels, and the other ranks,
in :meth:`RestorationServer.follow`, join that chain (x_T is rank 0's,
``inference/restoration.py``).  A stop header ends their loop when rank 0's
server stops.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wavedm_tpu_torch.data.raindrop import restore_input
from wavedm_tpu_torch.inference.restoration import refuse_lap
from wavedm_tpu_torch.parallel.distributed import collective_device
from wavedm_tpu_torch.utils.images import decode_image, encode_png

__all__ = ["Microbatcher", "RestorationServer"]


@dataclass
class _Request:
    arr: np.ndarray                       # (H, W, 3) float32 [0,1]
    done: threading.Event = field(default_factory=threading.Event)
    out: Optional[np.ndarray] = None
    error: Optional[str] = None


class Microbatcher:
    """Groups queued requests into same-shape batches.

    ``collect()`` blocks for the first request, then drains peers arriving
    within ``window_ms`` up to ``batch``, returning the same-shape group
    containing the OLDEST request; stragglers of other shapes and the
    overflow stay pending for the next call.
    """

    def __init__(self, batch: int = 8, window_ms: float = 30.0):
        self.queue: "Queue[_Request]" = Queue()
        self.batch = batch
        self.window_ms = window_ms
        self._pending: List[_Request] = []

    def submit(self, req: _Request) -> None:
        self.queue.put(req)

    def depth(self) -> int:
        return self.queue.qsize() + len(self._pending)

    def collect(self, timeout: Optional[float] = None) -> List[_Request]:
        """Next batch (possibly empty on timeout)."""
        items = self._pending
        self._pending = []
        if not items:
            try:
                items = [self.queue.get(timeout=timeout)]
            except Empty:
                return []
        deadline = time.time() + self.window_ms / 1e3
        while len(items) < self.batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                items.append(self.queue.get(timeout=remaining))
            except Empty:
                break
        groups: Dict[Tuple[int, ...], List[_Request]] = {}
        for r in items:
            groups.setdefault(tuple(r.arr.shape), []).append(r)
        best = groups[tuple(items[0].arr.shape)]
        for reqs in groups.values():
            if reqs is not best:
                self._pending.extend(reqs)
        self._pending.extend(best[self.batch:])
        return best[:self.batch]


_STOP, _RUN = 0, 1      # the ops of a patch-parallel server's header


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = 128           # the listen backlog (stdlib: 5)


class RestorationServer:
    """Device-owner loop + HTTP front end around a ``DiffusiveRestoration``
    (``inference/loader.py:build_restorer``), which runs on the card unless
    it was built for another device.  Only the device-owner thread calls the
    restorer (its per-geometry pipeline cache is not thread-safe).  Over a
    patch-parallel mesh (the restorer's ``mesh``) this is rank 0's server
    and the other ranks call :meth:`follow`.  A batch that fails on any
    rank of such a mesh ends the world: the other ranks may be inside the
    chain's collectives, which cannot be realigned.  A follower raises out
    of :meth:`follow`; rank 0 fails the batch's requests, stops its device
    owner and HTTP server and keeps the error in ``failed``."""

    def __init__(self, restorer, *, batch: int = 8, window_ms: float = 30.0,
                 no_resize: bool = False, rng_seed: int = 61):
        if getattr(restorer, "cfg", None) is not None:
            refuse_lap(restorer.cfg, "RestorationServer")
        self.restorer = restorer
        self.batcher = Microbatcher(batch=batch, window_ms=window_ms)
        self.no_resize = no_resize
        self.stats = {"served": 0, "batches": 0, "errors": 0,
                      "last_batch_ms": 0.0, "last_batch_size": 0}
        self._seed = rng_seed
        self._device = torch.device(getattr(restorer, "device", "cpu"))
        if self._device.type == "cuda" and self._device.index is None:
            # the worker thread starts on device 0: pin it to this one's
            self._device = torch.device("cuda", torch.cuda.current_device())
        mesh = getattr(restorer, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._followers_released = False
        self.failed: Optional[BaseException] = None
        self._httpd: Optional[_HTTPServer] = None
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._device_loop,
                                        daemon=True, name="device-owner")

    # ---------------------------------------------------------- device side

    def _header(self, op: int, shape=(0, 0, 0)) -> None:
        self._mesh.broadcast(torch.tensor([op, *shape], dtype=torch.int64,
                                          device=collective_device()))

    def _release_followers(self) -> None:
        if self._mesh is not None and not self._followers_released:
            self._followers_released = True
            self._header(_STOP)

    def run_batch(self, stacked: np.ndarray,
                  generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Restore one (B, H, W, 3) batch; over a patch-parallel mesh the
        other ranks are handed the header and the pixels first.  Call it
        from one thread at a time (the device owner once started)."""
        if self._mesh is not None:
            x = torch.as_tensor(stacked, dtype=torch.float32,
                                device=self._device).contiguous()
            self._header(_RUN, x.shape[:3])
            self._mesh.broadcast(x)
            stacked = x
        out, _ = self.restorer.restore_image(stacked, generator=generator)
        return out

    def follow(self) -> None:
        """The loop of a rank other than 0 of a patch-parallel mesh: join
        every chain rank 0 announces, until it announces the stop.  A
        chain that fails here raises (see the class)."""
        gen = torch.Generator(device=self._device).manual_seed(self._seed)
        while True:
            head = torch.empty(4, dtype=torch.int64,
                               device=collective_device())
            self._mesh.broadcast(head)
            op, b, h, w = head.tolist()
            if op == _STOP:
                return
            x = torch.empty((b, h, w, 3), dtype=torch.float32,
                            device=self._device)
            self._mesh.broadcast(x)
            self.restorer.restore_image_device(x, generator=gen)

    def _device_loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        gen = torch.Generator(device=self._device).manual_seed(self._seed)
        try:
            self._serve_batches(gen)
        finally:
            if self.failed is None:
                self._release_followers()
            elif self._httpd is not None:
                # shutdown() waits for serve_forever, which may be this
                # thread's caller's to return from
                threading.Thread(target=self._httpd.shutdown,
                                 daemon=True).start()

    def _serve_batches(self, gen: torch.Generator) -> None:
        while not self._stop.is_set():
            reqs = self.batcher.collect(timeout=0.2)
            if not reqs:
                continue
            t0 = time.time()
            try:
                stacked = np.stack([r.arr for r in reqs])
                # pad short batches to the fixed batch size (repeat the last
                # image): the card runs one batch shape per geometry
                pad = self.batcher.batch - len(reqs)
                if pad > 0:
                    stacked = np.concatenate(
                        [stacked, np.repeat(stacked[-1:], pad, axis=0)])
                out = self.run_batch(stacked, gen)
                for r, img in zip(reqs, out[:len(reqs)]):
                    r.out = np.asarray(img)
                self.stats["served"] += len(reqs)
            except Exception as e:  # noqa: BLE001 -- fan the error out
                for r in reqs:
                    r.error = f"{type(e).__name__}: {e}"[:500]
                self.stats["errors"] += len(reqs)
                if self._mesh is not None:
                    self.failed = e
                    self._stop.set()
            finally:
                ms = (time.time() - t0) * 1e3
                self.stats["batches"] += 1
                self.stats["last_batch_ms"] = round(ms, 1)
                self.stats["last_batch_size"] = len(reqs)
                for r in reqs:
                    r.done.set()

    # ------------------------------------------------------------ HTTP side

    def _decode(self, body: bytes) -> np.ndarray:
        """Image bytes -> (h, w, 3) float32 in [0, 1] at the
        serving geometry: the eval protocol's 720x480 (LANCZOS), or with
        ``no_resize`` the image's own size rounded up to /16."""
        return restore_input(decode_image(body, "request body"),
                             self.no_resize)

    def restore_bytes(self, body: bytes, timeout: float = 600.0) -> bytes:
        """Decode -> enqueue -> await the device owner -> PNG bytes."""
        if self.failed is not None:
            raise RuntimeError(f"the server stopped after a failed batch: "
                               f"{self.failed}")
        req = _Request(self._decode(body))
        self.batcher.submit(req)
        if not req.done.wait(timeout):
            raise TimeoutError("restoration timed out")
        if req.error:
            raise RuntimeError(req.error)
        arr = np.clip(np.asarray(req.out) * 255.0 + 0.5, 0, 255)
        return encode_png(arr.astype(np.uint8))

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def do_GET(self):
                if self.path != "/healthz":
                    self.send_error(404)
                    return
                body = json.dumps(
                    {**server.stats, "queue_depth": server.batcher.depth()}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/restore":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    png = server.restore_bytes(self.rfile.read(n))
                except Exception as e:  # noqa: BLE001
                    msg = f"{type(e).__name__}: {e}".encode()[:1000]
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)

        return Handler

    def start(self) -> None:
        self._worker.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the device-owner loop and join its thread (after the batch
        it is running, if any); the followers of a patch-parallel mesh are
        released."""
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout)
        elif self._worker.ident is None:      # never started
            self._release_followers()

    def serve(self, host: str = "0.0.0.0", port: int = 8000):
        """Start the device owner; returns the HTTP server (not yet
        serving: call its ``serve_forever``)."""
        self.start()
        self._httpd = _HTTPServer((host, port), self.make_handler())
        return self._httpd
