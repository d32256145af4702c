"""Dynamic micro-batcher: the serving-side scheduler
(``crnn_ocr_tpu/serve/batcher.py``).

The reference serves one image per ``model.predict`` call (SURVEY.md C11,
``predict.py`` main loop); a card is idle at batch 1. This batcher turns a
stream of concurrent single-image requests into bucket-homogeneous device
batches:

* requests enqueue from any thread and get a ``Future`` back;
* one worker thread coalesces everything that arrives within
  ``max_wait_ms`` of the first queued request (up to ``max_batch``),
  groups by width bucket (``Predictor.bucket_for``), and runs one
  ``predict`` per group;
* batch sizes are snapped UP a static ladder (1, 2, 4, ... max_batch), so
  the set of batch shapes that ``warmup`` runs ahead covers every request
  count; pad rows are blank lines whose outputs are dropped.

All device work runs on the single worker thread by design: one CUDA
stream in use, one batch in flight, no device-side locking needed.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


def batch_ladder(max_batch: int) -> tuple:
    """Static batch-size ladder: powers of two up to max_batch (inclusive,
    max_batch itself always present so a full pull pads by zero)."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def _percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if values else None


@dataclass
class BatcherStats:
    """Counters of a batcher, and per request its latency (enqueue to
    result) and its queue wait (enqueue to the start of its group's
    ``predict``), each over a rolling window of the last requests."""

    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    errors: int = 0
    batch_sizes: List[int] = field(default_factory=list)
    latencies_ms: List[float] = field(default_factory=list)
    queue_waits_ms: List[float] = field(default_factory=list)
    _max_kept: int = 4096

    def record_batch(self, n: int, latencies_ms, queue_waits_ms) -> None:
        self.batch_sizes.append(n)
        self.latencies_ms.extend(latencies_ms)
        self.queue_waits_ms.extend(queue_waits_ms)
        # rolling window: a resident daemon must not grow without bound
        for kept in (self.latencies_ms, self.queue_waits_ms,
                     self.batch_sizes):
            if len(kept) > 2 * self._max_kept:
                del kept[: -self._max_kept]

    def snapshot(self) -> dict:
        lat = self.latencies_ms[-self._max_kept:]
        wait = self.queue_waits_ms[-self._max_kept:]
        sizes = self.batch_sizes[-self._max_kept:]
        return {
            "requests": self.requests,
            "batches": self.batches,
            "padded_rows": self.padded_rows,
            "errors": self.errors,
            "mean_batch_size": float(np.mean(sizes)) if sizes else 0.0,
            "latency_ms_p50": _percentile(lat, 50),
            "latency_ms_p95": _percentile(lat, 95),
            "queue_wait_ms_p50": _percentile(wait, 50),
            "queue_wait_ms_p95": _percentile(wait, 95),
        }


class _Request:
    __slots__ = ("image", "bucket", "future", "t_enqueue")

    def __init__(self, image: np.ndarray, bucket: int):
        self.image = image
        self.bucket = bucket
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


class DynamicBatcher:
    """Coalesce concurrent OCR requests into bucket-grouped device batches.

    ``predictor`` only needs ``Predictor``'s serving surface (``cfg.height``,
    ``buckets``, ``bucket_for``, ``blank_row`` and ``predict(images,
    bucket=..., **decode_kw)``); decode options (greedy/beam) are fixed per
    batcher, so every queued request can share a batch.
    """

    def __init__(
        self,
        predictor,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        decode_kw: Optional[dict] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.decode_kw = dict(decode_kw or {})
        self.ladder = batch_ladder(self.max_batch)
        self.stats = BatcherStats()
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._stop = False
        self._worker: Optional[threading.Thread] = None

    # ---- lifecycle ----

    def start(self) -> "DynamicBatcher":
        self._stop = False
        self._worker = threading.Thread(
            target=self._run, name="ocr-batcher", daemon=True
        )
        self._worker.start()
        return self

    def stop(self, drain: bool = True, join_timeout_s: float = 600.0) -> None:
        """Stop the worker; with ``drain`` (default) pending requests are
        served first, otherwise their futures get cancelled.

        ``join_timeout_s`` bounds the wait for the worker's in-flight
        device work (a first call may build the kernels): a batch abandoned
        mid-flight at interpreter exit tears the CUDA runtime down under a
        running stream, so the default is generous and a timeout is loudly
        reported."""
        with self._cv:
            self._stop = True
            if not drain:
                for r in self._queue:
                    r.future.cancel()
                self._queue.clear()
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=join_timeout_s)
            if self._worker.is_alive():
                import sys

                print(
                    "[serve] WARNING: batcher worker still busy after "
                    f"{join_timeout_s}s; exiting anyway (the CUDA runtime "
                    "may fail on teardown)",
                    file=sys.stderr,
                )
            self._worker = None

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every (ladder size, bucket) batch once up front, at two raw
        canvas widths per bucket (16 px and the bucket): the kernels are
        built or loaded, and cuDNN and the caching allocator see each batch
        shape before the first request does."""
        h = self.predictor.cfg.height
        for b in buckets or self.predictor.buckets:
            for n in self.ladder:
                for w in (16, b):
                    imgs = [np.full((h, w), 255, np.uint8)] * n
                    self.predictor.predict(imgs, bucket=b, **self.decode_kw)

    # ---- request side ----

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one grayscale uint8 image; resolves to a ``Prediction``.

        Raises ``ValueError`` for malformed images (wrong rank, empty dims)
        — client errors, surfaced before anything enqueues."""
        image = np.asarray(image)
        if image.ndim != 2 or min(image.shape) == 0:
            raise ValueError(
                f"expected non-empty grayscale HxW image, got {image.shape}"
            )
        bucket = self.predictor.bucket_for(image)
        req = _Request(image, bucket)
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is stopped")
            self._queue.append(req)
            self._cv.notify()
        return req.future

    def predict_sync(self, image: np.ndarray, timeout: Optional[float] = None):
        return self.submit(image).result(timeout=timeout)

    # ---- worker side ----

    def _pull(self) -> List[_Request]:
        """Block for the first request, then collect arrivals for up to
        max_wait_s (or until max_batch). Returns [] only on shutdown."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            if not self._queue:
                return []
            deadline = time.perf_counter() + self.max_wait_s
            while len(self._queue) < self.max_batch and not self._stop:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            take = self._queue[: self.max_batch]
            del self._queue[: self.max_batch]
            return take

    def _run(self) -> None:
        while True:
            batch = self._pull()
            if not batch:
                with self._cv:
                    if self._stop and not self._queue:
                        return
                continue
            groups: dict = {}
            for r in batch:
                groups.setdefault(r.bucket, []).append(r)
            for bucket in sorted(groups, key=lambda b: -len(groups[b])):
                self._run_group(bucket, groups[bucket])

    def _run_group(self, bucket: int, reqs: List[_Request]) -> None:
        n = len(reqs)
        padded = next(s for s in self.ladder if s >= n)
        images = [r.image for r in reqs] + [
            self.predictor.blank_row()
        ] * (padded - n)
        started = time.perf_counter()
        try:
            preds = self.predictor.predict(
                images, bucket=bucket, **self.decode_kw
            )
        except Exception as e:  # noqa: BLE001 — forwarded to callers
            self.stats.errors += n
            for r in reqs:
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        now = time.perf_counter()
        self.stats.requests += n
        self.stats.batches += 1
        self.stats.padded_rows += padded - n
        self.stats.record_batch(
            n, [(now - r.t_enqueue) * 1e3 for r in reqs],
            [(started - r.t_enqueue) * 1e3 for r in reqs],
        )
        for r, p in zip(reqs, preds):
            if not r.future.cancelled():
                r.future.set_result(p)
