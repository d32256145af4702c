"""HTTP serving front-end for the dynamic batcher
(``crnn_ocr_tpu/serve/http.py``).

A dependency-free stdlib server (``http.server`` + ``ThreadingHTTPServer``):
each request thread decodes its own image bytes on the host, submits to
the shared :class:`DynamicBatcher`, and blocks on its Future while the
single device thread runs coalesced batches.

Endpoints:
  * ``POST /predict`` — body = encoded image (PNG/JPEG/BMP/…, anything
    cv2 decodes) or a raw ``.npy`` grayscale array. Returns JSON
    ``{"text", "score", "candidates"?, "alignments"?}`` (``candidates``
    when the daemon decodes ``top_paths`` > 1; ``alignments`` — per-char
    ``{char, x0, x1, conf}`` pixel spans — when it was started with
    ``--alignments``; greedy localizes argmax runs, beam force-aligns its
    decoded top path).
  * ``GET /healthz`` — liveness: ``{"ok": true}``.
  * ``GET /stats``   — batcher counters + latency and queue-wait
    percentiles.
  * ``GET /metrics`` — the same counters in Prometheus's text format.

``.npy`` payloads need no image codec; everything else imports ``cv2``
when the first such payload arrives, so a server fed ``.npy`` runs where
cv2 is not installed.

Deliberately NOT async-io: device work is serialized on one worker thread
anyway, so a thread per in-flight HTTP request is cheap and keeps the code
debuggable.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from crnn_ocr_torch.serve.batcher import DynamicBatcher

_NPY_MAGIC = b"\x93NUMPY"


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode request bytes to a grayscale uint8 HxW array.

    ``.npy`` payloads skip the codec entirely (fast path for in-datacenter
    callers); anything else goes through cv2's image codecs, imported here
    (SURVEY.md C18)."""
    if data[: len(_NPY_MAGIC)] == _NPY_MAGIC:
        arr = np.load(io.BytesIO(data), allow_pickle=False)
        if arr.ndim == 3:
            arr = arr.mean(axis=-1)
        return np.ascontiguousarray(arr.astype(np.uint8))
    import cv2

    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    if arr is None:
        raise ValueError("undecodable image payload")
    return arr


class _Handler(BaseHTTPRequestHandler):
    server_version = "crnn-ocr-torch/1"
    # set by OCRServer:
    batcher: DynamicBatcher
    request_timeout_s: float
    quiet: bool

    def log_message(self, fmt, *args):  # noqa: D102 — silence default spam
        if not self.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, self.batcher.stats.snapshot())
        elif self.path == "/metrics":
            # Prometheus text exposition of the same counters
            s = self.batcher.stats.snapshot()
            lines = [
                "# TYPE ocr_requests_total counter",
                f"ocr_requests_total {s['requests']}",
                "# TYPE ocr_batches_total counter",
                f"ocr_batches_total {s['batches']}",
                "# TYPE ocr_errors_total counter",
                f"ocr_errors_total {s['errors']}",
                "# TYPE ocr_padded_rows_total counter",
                f"ocr_padded_rows_total {s['padded_rows']}",
                "# TYPE ocr_mean_batch_size gauge",
                f"ocr_mean_batch_size {s['mean_batch_size']}",
            ]
            for key in ("latency_ms_p50", "latency_ms_p95",
                        "queue_wait_ms_p50", "queue_wait_ms_p95"):
                v = s[key]
                if v is not None:
                    lines += [
                        f"# TYPE ocr_{key} gauge",
                        f"ocr_{key} {v}",
                    ]
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"no such route: {self.path}"})

    max_payload_bytes: int = 32 << 20  # reject absurd bodies before reading
    inflight: "object"  # _Inflight, set by OCRServer

    def do_POST(self):  # noqa: N802 — http.server API
        with self.inflight:
            self._do_post()

    def _do_post(self):
        if self.path != "/predict":
            self._reply(404, {"error": f"no such route: {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise ValueError("empty body")
            if n > self.max_payload_bytes:
                raise ValueError(
                    f"payload {n} bytes exceeds {self.max_payload_bytes}"
                )
            image = decode_image_bytes(self.rfile.read(n))
            if image.ndim != 2 or min(image.shape) == 0:
                raise ValueError(
                    f"expected non-empty grayscale image, got {image.shape}"
                )
        except Exception as e:  # noqa: BLE001 — client error, report it
            self._reply(400, {"error": str(e)})
            return
        import concurrent.futures

        try:
            pred = self.batcher.predict_sync(
                image, timeout=self.request_timeout_s
            )
        except concurrent.futures.TimeoutError:
            self._reply(
                504,
                {"error": f"request timed out after "
                          f"{self.request_timeout_s}s (still queued)"},
            )
            return
        except Exception as e:  # noqa: BLE001 — surfaced as 5xx
            self._reply(503, {"error": f"{type(e).__name__}: {e}"})
            return
        out = {"text": pred.text, "score": pred.score}
        if pred.candidates:
            out["candidates"] = [
                {"text": t, "score": s} for t, s in pred.candidates
            ]
        if pred.spans is not None:  # daemon started with --alignments
            out["alignments"] = [
                {"char": s.char, "x0": s.x0, "x1": s.x1,
                 "conf": round(s.conf, 4)}
                for s in pred.spans
            ]
        self._reply(200, out)


class _Inflight:
    """Context-managed in-flight request counter with a drain wait — a
    graceful shutdown must not kill daemon handler threads between their
    Future resolving and the HTTP reply hitting the socket."""

    def __init__(self):
        self._n = 0
        self._cv = threading.Condition()

    def __enter__(self):
        with self._cv:
            self._n += 1

    def __exit__(self, *exc):
        with self._cv:
            self._n -= 1
            self._cv.notify_all()
        return False

    def wait_empty(self, timeout: float) -> bool:
        import time

        deadline = time.monotonic() + timeout
        with self._cv:
            while self._n > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
            return True


class _Listener(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5 — request bursts beyond it
    # get RST on a busy host. The whole point of this server is absorbing
    # bursts into device batches, so size the backlog accordingly.
    request_queue_size = 512


class OCRServer:
    """Own the HTTP listener + batcher pair; supports in-process tests
    (``start()``/``stop()``) and blocking CLI use (``serve_forever()``)."""

    def __init__(
        self,
        predictor,
        host: str = "0.0.0.0",
        port: int = 8000,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        decode_kw: Optional[dict] = None,
        request_timeout_s: float = 30.0,
        quiet: bool = True,
    ):
        self.batcher = DynamicBatcher(
            predictor,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            decode_kw=decode_kw,
        )
        self.inflight = _Inflight()
        handler = type(
            "BoundHandler",
            (_Handler,),
            {
                "batcher": self.batcher,
                "request_timeout_s": request_timeout_s,
                "quiet": quiet,
                "inflight": self.inflight,
            },
        )
        self.httpd = _Listener((host, port), handler)
        self.httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "OCRServer":
        self.batcher.start()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="ocr-http", daemon=True
        )
        self._serve_thread.start()
        return self

    def serve_forever(self) -> None:
        self.batcher.start()
        try:
            self.httpd.serve_forever()
        finally:
            # graceful: queued requests run, THEN handler threads finish
            # writing their replies — daemon threads die at interpreter
            # exit, so the drain must block until responses are on the wire
            self.batcher.stop(drain=True)
            self.inflight.wait_empty(timeout=60)

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=30)
            self._serve_thread = None
        self.batcher.stop(drain=False)
