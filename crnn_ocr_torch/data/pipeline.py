"""Host batches -> device batches for the training step.

A port of ``crnn_ocr_tpu/data/pipeline.py`` (``_prefetched`` :28-58,
``device_batches`` :61-97 without ``augment_offset``, ``produce_batch``
:100-141 and ``synthetic_batches`` :225-259). Raw host batches are dicts
of numpy arrays: ``the_input`` (B, Hmax, Wmax) uint8 canvas, white beyond
each image's ``heights`` and ``widths``, ``the_labels`` (B, L),
``label_length`` (B,), ``bucket`` and ``texts``. ``produce_batch`` moves one to the device and preprocesses it
there with the port's ``preprocess_batch``; ``input_length`` then counts
the frames each line covers after the conv downsample and the
``ctc_time_slice`` warm-up frames. ``device_batches`` drains the host
iterator (image decode, canvas packing) on a daemon thread through a
bounded queue while the consumer's thread does the device work.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.ops.preprocess import pack_canvas, preprocess_batch


def produce_batch(b: Dict[str, np.ndarray], device,
                  cfg: ModelConfig) -> Dict[str, object]:
    """One raw host batch -> the train step's batch on ``device``: ``x``
    (B, cfg.height, bucket) f32, standardized, ``input_length`` (B,) int32,
    ``the_labels``, ``label_length``, and the host's ``texts`` and
    ``bucket``. The frame counts follow ``cfg.width_downsample`` and
    ``cfg.ctc_time_slice``."""
    bucket = int(b["bucket"])
    x, w_new = preprocess_batch(
        torch.from_numpy(np.asarray(b["the_input"])).to(device),
        torch.from_numpy(np.asarray(b["heights"])).to(device),
        torch.from_numpy(np.asarray(b["widths"])).to(device),
        out_h=cfg.height,
        out_w=bucket,
    )
    T = cfg.time_steps(bucket)
    input_len = (torch.clamp(w_new // cfg.width_downsample, max=T)
                 - cfg.ctc_time_slice)
    return {
        "x": x,
        "input_length": torch.clamp(input_len, min=1).to(torch.int32),
        "the_labels": torch.from_numpy(np.asarray(b["the_labels"])).to(device),
        "label_length": torch.from_numpy(
            np.asarray(b["label_length"])).to(device),
        "texts": b.get("texts"),
        "bucket": bucket,
    }


def _prefetched(gen, prefetch: int):
    """Drain ``gen`` on a daemon thread through a queue of ``prefetch``
    items (``prefetch <= 0``: in the caller's thread). An exception in the
    producer (a corrupt image failing its decode) is raised in the
    consumer; it never ends the stream quietly, which would stop training
    early as if the run were complete. Closing the consumer (or dropping
    it) stops the producer after the item it is making."""
    if prefetch <= 0:
        yield from gen
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    end, err = object(), object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            put((err, e))
        else:
            put(end)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
                raise item[1]
            yield item
    finally:
        stop.set()


def device_batches(host_iter, device, cfg: ModelConfig,
                   prefetch: int = 2) -> Iterator[Dict[str, object]]:
    """``produce_batch`` over a stream of raw host batches, the host
    iterator run ``prefetch`` batches ahead on a thread of its own; the
    device work stays on the caller's thread."""
    for b in _prefetched(host_iter, prefetch):
        yield produce_batch(b, device, cfg)


def synthetic_batches(
    batch_size: int = 32,
    bucket: int = 128,
    seed: int = 0,
    augment: bool = False,
    max_label_len: int = 16,
    steps: Optional[int] = None,
    synth=None,
    skip: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Raw host batches of the synthetic glyph task. Batch ``n`` draws from
    ``default_rng([seed, n])``, so the stream is random-access (``skip``
    fast-forwards) and byte-identical to the JAX package's at equal
    arguments."""
    from crnn_ocr_torch.data.synthetic import (
        SyntheticConfig,
        SyntheticTextlines,
    )

    synth = synth or SyntheticTextlines(SyntheticConfig(augment=augment))
    n = int(skip)
    while steps is None or n < steps:
        rng = np.random.default_rng([seed, n])
        images, texts = synth.sample_batch(batch_size, rng)
        canvas, hs, ws = pack_canvas(images)
        labels, lab_len = synth.codec.encode_batch(texts, max_label_len)
        yield {
            "the_input": canvas,
            "heights": hs,
            "widths": ws,
            "the_labels": labels,
            "label_length": lab_len,
            "bucket": bucket,
            "texts": texts,
        }
        n += 1
