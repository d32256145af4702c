"""Host batches -> device batches for the training step.

A port of ``crnn_ocr_tpu/data/pipeline.py`` (``synthetic_batches``
:225-259, ``produce_batch`` :100-141, and ``device_batches`` without its
prefetch thread). Raw host batches are dicts of numpy arrays: ``the_input``
(B, Hmax, Wmax) uint8 canvas, white beyond each image's ``heights`` and
``widths``, ``the_labels`` (B, L), ``label_length`` (B,), ``bucket`` and
``texts``. ``produce_batch`` moves one to the device and preprocesses it
there with the port's ``preprocess_batch``; ``input_length`` then counts
the frames each line covers after the conv downsample and the
``ctc_time_slice`` warm-up frames.
"""

from __future__ import annotations

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


def device_batches(host_iter, device,
                   cfg: ModelConfig) -> Iterator[Dict[str, object]]:
    """``produce_batch`` over a stream of raw host batches."""
    for b in host_iter:
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
