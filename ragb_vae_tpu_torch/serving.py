"""Batched text-alpha inference serving (resident process + dynamic batcher).

Counterpart of `ragb_vae_tpu/serving.py` on one device (the tensor- and
pipeline-parallel variants are not ported yet):

- requests are snapped host-side to a small bucket envelope (`snap_size`),
  and a batch holds requests of one bucket only;
- a background thread drains the queues, grouping by bucket, and launches
  when `max_batch` requests wait or `max_delay_ms` has passed;
- per-request determinism: each request's posterior eps, initial latents and
  per-step noises come from a `torch.Generator` seeded with the request's
  seed, drawn in that fixed order, and feed the deterministic sampling core.
  An answer depends on (image, seed) only, not on co-batched traffic or
  batch padding.

`torch.inference_mode` is thread-local, so the batcher thread enters it
itself; otherwise every served batch would record an autograd graph.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def snap_size(
    height: int, width: int, *, multiple: int = 64, min_side: int = 64, max_pixels: int = 1024 * 1024
) -> Tuple[int, int]:
    """Snap a request size onto the serving bucket envelope: aspect kept,
    sides rounded to `multiple`, area capped at `max_pixels`."""
    if height <= 0 or width <= 0:
        raise ValueError(f"Invalid image size {height}x{width}.")
    h = max(min_side, int(round(height / multiple)) * multiple)
    w = max(min_side, int(round(width / multiple)) * multiple)
    if h * w > max_pixels:
        scale = (max_pixels / (h * w)) ** 0.5
        h = max(min_side, int(h * scale) // multiple * multiple)
        w = max(min_side, int(w * scale) // multiple * multiple)
    # the min_side clamp can push extreme aspect ratios back over the cap
    if h * w > max_pixels:
        if h >= w:
            h = max(min_side, (max_pixels // w) // multiple * multiple)
        else:
            w = max(min_side, (max_pixels // h) // multiple * multiple)
    return h, w


def resize_rgba(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear-resize an (H, W, 4) float [0,1] RGBA image to `size` (h, w),
    in float space and alpha-premultiplied (no colour fringes at alpha
    edges, no quantisation of alpha)."""
    if image.ndim != 3 or image.shape[-1] != 4:
        raise ValueError(f"Expected (H, W, 4) RGBA, got {image.shape}.")
    if image.shape[:2] == tuple(size):
        return image
    from PIL import Image

    arr = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    alpha = arr[..., 3:4]
    pre = np.concatenate([arr[..., :3] * alpha, alpha], axis=-1)
    chans = [
        np.asarray(
            Image.fromarray(pre[..., c], mode="F").resize((size[1], size[0]), Image.BILINEAR),
            np.float32,
        )
        for c in range(4)
    ]
    out = np.stack(chans, axis=-1)
    a = out[..., 3:4]
    rgb = np.where(a > 1e-6, out[..., :3] / np.maximum(a, 1e-6), 0.0)
    return np.clip(np.concatenate([rgb, a], axis=-1), 0.0, 1.0)


@dataclass
class ServeConfig:
    max_batch: int = 4
    max_delay_ms: float = 30.0
    steps: int = 20
    bucket_multiple: int = 64
    max_pixels: int = 1024 * 1024
    request_timeout_s: float = 300.0
    # warmup() times batch 1 and max_batch per bucket and serves the bucket
    # at the smallest batch within auto_batch_tol of the best throughput
    auto_batch: bool = True
    auto_batch_tol: float = 0.95


@dataclass
class _Request:
    image: np.ndarray          # bucket-sized (H, W, 4) float32 [0, 1]
    orig_size: Tuple[int, int]
    seed: int
    future: "Future[np.ndarray]" = field(default_factory=Future)
    enqueued: float = field(default_factory=time.monotonic)


class InferenceServer:
    """Resident batched sampler around a FluxTextAlphaModel.

    `submit()` is thread-safe and returns a Future of the predicted
    text-alpha RGBA (H, W, 4) float32 at the request's original size.
    `start()`/`stop()` manage the batcher thread; the object is also a
    context manager."""

    def __init__(self, model, config: Optional[ServeConfig] = None) -> None:
        self.model = model
        self.config = config or ServeConfig()
        self._bucket_batch: Dict[Tuple[int, int], int] = {}
        self._bucket_deadlines: Dict[Tuple[int, int], float] = {}
        self._queues: Dict[Tuple[int, int], "queue.Queue[_Request]"] = {}
        self._queues_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._served = 0
        self._batches = 0
        self._inflight = 0
        self._lat_sum = 0.0
        self._lat_max = 0.0

    # -- the serving program --------------------------------------------
    def _run_batch(self, images: np.ndarray, seeds: np.ndarray) -> np.ndarray:
        """encode -> sample -> decode for one assembled batch."""
        model = self.model
        steps = self.config.steps
        gt = torch.from_numpy(images).to(model.device)
        lat_shape = model.latent_shape(images.shape[1], images.shape[2])
        draws = [
            model.draw_noise(lat_shape, steps, torch.Generator(model.device).manual_seed(int(s)))
            for s in seeds
        ]
        eps, init, per_step = (torch.stack(t) for t in zip(*draws))
        cond = model.encode_latents(gt, eps)
        lat = model.sample_latents_from_noise(cond, init, per_step.transpose(0, 1))
        return model.decode_latents(lat).cpu().numpy()

    # -- public API ------------------------------------------------------
    def submit(self, image: np.ndarray, *, seed: Optional[int] = None) -> "Future[np.ndarray]":
        """Enqueue one (H, W, 4) RGBA image; returns a Future of the prediction."""
        if self._stop.is_set():
            raise RuntimeError("InferenceServer is stopped.")
        if self._draining:
            raise RuntimeError("InferenceServer is draining (shutting down).")
        # copy: the caller may reuse its buffer while the request waits
        image = np.array(image, dtype=np.float32, copy=True)
        if image.ndim != 3 or image.shape[-1] != 4:
            raise ValueError(f"submit() expects one (H, W, 4) RGBA image, got {image.shape}.")
        orig = (image.shape[0], image.shape[1])
        bucket = snap_size(*orig, multiple=self.config.bucket_multiple, max_pixels=self.config.max_pixels)
        req = _Request(
            image=resize_rgba(image, bucket),
            orig_size=orig,
            seed=(int(seed) & 0xFFFFFFFF) if seed is not None else int(time.time_ns() % (2**31)),
        )
        with self._queues_lock:
            q = self._queues.setdefault(bucket, queue.Queue())
        q.put(req)
        if self._stop.is_set() and not req.future.done():
            # raced stop(): the batcher's final drain may already have run
            try:
                req.future.set_exception(RuntimeError("Server stopped."))
            except Exception:
                pass  # the drain got it first
        self._wake.set()
        return req.future

    def _batch_for(self, bucket: Tuple[int, int]) -> int:
        return self._bucket_batch.get(bucket, self.config.max_batch)

    @torch.inference_mode()
    def warmup(self, sizes: Optional[List[Tuple[int, int]]] = None) -> None:
        """Run the serving program once per bucket before traffic arrives and,
        under auto_batch, pick each bucket's batch by measurement."""
        for size in sizes or [(512, 512)]:
            bucket = snap_size(*size, multiple=self.config.bucket_multiple,
                               max_pixels=self.config.max_pixels)
            candidates = [self.config.max_batch]
            if self.config.auto_batch and self.config.max_batch > 1:
                candidates = [1, self.config.max_batch]
            rates: Dict[int, float] = {}
            for b in candidates:
                images = np.zeros((b,) + bucket + (4,), np.float32)
                seeds = np.zeros((b,), np.uint32)
                self._run_batch(images, seeds)  # settle
                if len(candidates) > 1:
                    t0 = time.perf_counter()
                    self._run_batch(images, seeds)  # returns host arrays: synchronised
                    rates[b] = b / (time.perf_counter() - t0)
            if rates:
                best = max(rates.values())
                chosen = min(b for b in candidates if rates[b] >= self.config.auto_batch_tol * best)
                self._bucket_batch[bucket] = chosen
                print(
                    f"[serving] bucket {bucket[0]}x{bucket[1]}: "
                    + ", ".join(f"b{b} {rates[b]:.3f} img/s" for b in candidates)
                    + f" -> serving at batch {chosen}",
                    flush=True,
                )

    def start(self) -> "InferenceServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="ragb-serve-batcher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                # still inside a batch: keep the handle so a later start()
                # cannot spawn a second batcher over the same queues
                return
            self._thread = None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new requests, finish the queued ones, stop. True when the
        queues emptied within `timeout`."""
        self._draining = True
        if timeout is None:
            timeout = self.config.request_timeout_s + 60.0
        deadline = time.monotonic() + timeout
        clean = False
        while time.monotonic() < deadline:
            # a batch already taken from the queues is in flight until answered
            if self.stats["pending"] == 0 and self._inflight == 0:
                clean = True
                break
            time.sleep(0.05)
        self.stop()
        return clean

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def stats(self) -> Dict[str, float]:
        with self._queues_lock:
            pending = sum(q.qsize() for q in self._queues.values())
        out = {"served": self._served, "pending": pending, "batches": self._batches}
        if self._served:
            out["latency_avg_ms"] = round(1000.0 * self._lat_sum / self._served, 1)
            out["latency_max_ms"] = round(1000.0 * self._lat_max, 1)
        return out

    # -- batcher ---------------------------------------------------------
    def _run(self) -> None:
        with torch.inference_mode():
            self._serve_loop()

    def _serve_loop(self) -> None:
        max_delay = self.config.max_delay_ms / 1000.0
        while not self._stop.is_set():
            batch = self._collect(max_delay)
            if batch is None:
                continue
            _, reqs = batch
            # drop requests already past the client timeout
            now = time.monotonic()
            live: List[_Request] = []
            for r in reqs:
                if now - r.enqueued > self.config.request_timeout_s:
                    if not r.future.done():
                        r.future.set_exception(TimeoutError("request expired in queue"))
                else:
                    live.append(r)
            if not live:
                continue
            self._inflight = len(live)
            try:
                self._launch(live)
            except Exception as exc:  # surface the failure on the futures
                for r in live:
                    if not r.future.done():
                        r.future.set_exception(exc)
            finally:
                self._inflight = 0
        # stopped: fail anything still queued
        with self._queues_lock:
            queues = list(self._queues.values())
        for q in queues:
            while True:
                try:
                    req = q.get_nowait()
                except queue.Empty:
                    break
                if not req.future.done():
                    req.future.set_exception(RuntimeError("Server stopped."))

    def _collect(self, max_delay: float) -> Optional[Tuple[Tuple[int, int], List[_Request]]]:
        """Launch a full bucket at once; otherwise the oldest bucket whose
        first waiter has waited `max_delay` (deadlines are per bucket)."""
        deadlines = self._bucket_deadlines
        while not self._stop.is_set():
            with self._queues_lock:
                ready = [(q.qsize(), b, q) for b, q in self._queues.items() if q.qsize()]
            if not ready:
                deadlines.clear()
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            now = time.monotonic()
            active = {b for _, b, _ in ready}
            for stale in [b for b in deadlines if b not in active]:
                del deadlines[stale]
            for _, b, _ in ready:
                deadlines.setdefault(b, now + max_delay)
            ready.sort(reverse=True, key=lambda t: t[0])
            # expired deadlines first, so a busy bucket cannot starve a quiet one
            expired = [(sz, b, qq) for sz, b, qq in ready if deadlines[b] <= now]
            if expired:
                _, bucket, q = max(expired, key=lambda t: t[0])
                deadlines.pop(bucket, None)
                return bucket, self._take(q, self._batch_for(bucket))
            size, bucket, q = ready[0]
            if size >= self._batch_for(bucket):
                deadlines.pop(bucket, None)
                return bucket, self._take(q, self._batch_for(bucket))
            self._wake.wait(timeout=max(min(deadlines.values()) - now, 1e-3))
            self._wake.clear()
        return None

    @staticmethod
    def _take(q: "queue.Queue[_Request]", n: int) -> List[_Request]:
        out: List[_Request] = []
        while len(out) < n:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                break
        return out

    def _launch(self, reqs: List[_Request]) -> None:
        n = len(reqs)
        bucket = (reqs[0].image.shape[0], reqs[0].image.shape[1])
        pad = max(self._batch_for(bucket), n) - n
        images = np.stack([r.image for r in reqs] + [reqs[0].image] * pad)
        seeds = np.asarray([r.seed for r in reqs] + [0] * pad, dtype=np.uint32)
        out = self._run_batch(images, seeds)
        done = time.monotonic()
        self._batches += 1
        for r, pred in zip(reqs, out[:n]):
            if r.future.done():
                continue  # raced stop()/expiry already failed it
            r.future.set_result(resize_rgba(pred, r.orig_size))
            self._served += 1
            lat = done - r.enqueued
            self._lat_sum += lat
            self._lat_max = max(self._lat_max, lat)
