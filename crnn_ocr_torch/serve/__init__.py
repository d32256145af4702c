"""Serving runtime: dynamic micro-batching + HTTP daemon
(``crnn_ocr_tpu/serve/``): a resident process that keeps the kernels
loaded and coalesces concurrent requests into card-sized batches. See
``batcher.py`` (scheduler) and ``http.py`` (front-end)."""

from crnn_ocr_torch.serve.batcher import (
    BatcherStats,
    DynamicBatcher,
    batch_ladder,
)
from crnn_ocr_torch.serve.http import OCRServer, decode_image_bytes

__all__ = [
    "BatcherStats",
    "DynamicBatcher",
    "OCRServer",
    "batch_ladder",
    "decode_image_bytes",
]
