"""Host batches -> device batches for the training step.

A port of ``crnn_ocr_tpu/data/pipeline.py`` (``_prefetched`` :28-58,
``device_batches`` :61-97, ``produce_batch`` :100-141,
``stack_host_batches`` and ``_stack_group`` :144-222, and
``synthetic_batches`` :225-259). Raw host batches are dicts of numpy
arrays: ``the_input`` (B, Hmax, Wmax) uint8 canvas, white beyond each
image's ``heights`` and ``widths``, ``the_labels`` (B, L),
``label_length`` (B,), ``bucket`` and ``texts``. ``produce_batch`` moves
one to the device and preprocesses it there with the port's
``preprocess_batch``, then augments it where asked (``ops/augment.py``,
batch ``index``'s draws); ``input_length`` then counts the frames each
line covers after the conv downsample and the ``ctc_time_slice`` warm-up
frames. ``device_batches`` drains the host iterator (image decode, canvas
packing) on a daemon thread through a bounded queue while the consumer's
thread does the device work. ``stack_host_batches`` groups raw batches
into same-bucket stacks of K for ``train.step.make_multi_train_step``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.ops.augment import augment_batch, augment_generator
from crnn_ocr_torch.ops.preprocess import (
    pack_canvas,
    preprocess_batch,
    quantize_dim,
)
from crnn_ocr_torch.utils.profiling import span


def input_lengths(w_new: torch.Tensor, bucket: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """(B,) int32 CTC frame counts of lines of content widths ``w_new`` in
    ``bucket``: the frames after ``cfg.width_downsample``, at most the
    bucket's, less the ``cfg.ctc_time_slice`` warm-up frames, at least 1."""
    T = cfg.time_steps(bucket)
    input_len = (torch.clamp(w_new // cfg.width_downsample, max=T)
                 - cfg.ctc_time_slice)
    return torch.clamp(input_len, min=1).to(torch.int32)


def produce_batch(b: Dict[str, np.ndarray], device, cfg: ModelConfig,
                  normalize: bool = True, augment: bool = False,
                  augment_seed: int = 0,
                  index: int = 0) -> Dict[str, object]:
    """One raw host batch -> the train step's batch on ``device``: ``x``
    (B, cfg.height, bucket) f32 (standardized with ``normalize``, then
    augmented with ``augment`` from the draws of batch ``index`` of the
    ``augment_seed`` stream), ``input_length`` (B,) int32, ``the_labels``,
    ``label_length``, and the host's ``texts`` and ``bucket``. The frame
    counts follow ``cfg.width_downsample`` and ``cfg.ctc_time_slice``."""
    bucket = int(b["bucket"])
    with span("crnn.data.upload"):
        img, hs, ws = (torch.from_numpy(np.asarray(b[k])).to(device)
                       for k in ("the_input", "heights", "widths"))
    with span("crnn.data.resize"):
        x, w_new = preprocess_batch(img, hs, ws, out_h=cfg.height,
                                    out_w=bucket, normalize=normalize)
    if augment:
        with span("crnn.data.augment"):
            x = augment_batch(x, augment_generator(x.device, augment_seed,
                                                   index))
    # the labels go up after the resize is enqueued, in a span of their own
    with span("crnn.data.upload"):
        labels, label_length = (torch.from_numpy(np.asarray(b[k])).to(device)
                                for k in ("the_labels", "label_length"))
    return {
        "x": x,
        "input_length": input_lengths(w_new, bucket, cfg),
        "the_labels": labels,
        "label_length": label_length,
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


def device_batches(host_iter, device, cfg: ModelConfig, prefetch: int = 2,
                   normalize: bool = True, augment: bool = False,
                   augment_seed: int = 0, augment_offset: int = 0
                   ) -> Iterator[Dict[str, object]]:
    """``produce_batch`` over a stream of raw host batches, the host
    iterator run ``prefetch`` batches ahead on a thread of its own; the
    device work stays on the caller's thread. With ``augment`` the n-th
    batch takes the draws of index ``augment_offset + n`` (a resumed run
    passes the batches it skipped, and draws what a straight run draws);
    without it every index is ``augment_offset``, as in JAX."""
    index = int(augment_offset)
    for b in _prefetched(host_iter, prefetch):
        yield produce_batch(b, device, cfg, normalize=normalize,
                            augment=augment, augment_seed=augment_seed,
                            index=index)
        if augment:
            index += 1


def stack_host_batches(host_iter: Iterator[Dict[str, np.ndarray]],
                       n_inner: int, prefetch: int = 2,
                       index_offset: int = 0
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Group raw host batches into same-bucket stacks of ``n_inner`` for
    ``train.step.make_multi_train_step``, which runs them as ``n_inner``
    steps in one call.

    A stack carries ``stacked=n_inner`` and arrays with a leading K axis:
    ``the_input`` (K, B, Hq, Wq) uint8, each canvas padded white to the
    group's largest height and width snapped up ``quantize_dim``'s ladder,
    ``heights``, ``widths``, ``label_length`` (K, B), ``the_labels`` (K, B,
    L), ``batch_index`` (K,) int32 (each batch's place in the host stream,
    from ``index_offset``: its augmentation draws), the common ``bucket``
    and the batches' ``texts``.

    Batches are regrouped by bucket, so with several buckets the step
    order differs from the host stream's (the same batches, as many); with
    one bucket it is the same. At the end of a bounded stream each bucket's
    partial group is flushed as plain raw batches, each with its
    ``batch_index``, which ``fit`` produces and steps one at a time. The
    grouping runs on the prefetch thread.
    """
    if n_inner <= 1:
        yield from host_iter
        return

    def stacks():
        pending: Dict[int, list] = {}
        n_produced = int(index_offset)
        for b in host_iter:
            b = dict(b)
            b["batch_index"] = n_produced
            n_produced += 1
            bucket = int(b["bucket"])
            group = pending.setdefault(bucket, [])
            group.append(b)
            if len(group) == n_inner:
                yield _stack_group(pending.pop(bucket), bucket)
        for bucket in sorted(pending):
            yield from pending[bucket]

    yield from _prefetched(stacks(), prefetch)


def _stack_group(group, bucket: int) -> Dict[str, np.ndarray]:
    """Stack ``n_inner`` same-bucket host batches into one K-leading dict."""
    hq = quantize_dim(max(int(b["the_input"].shape[1]) for b in group))
    wq = quantize_dim(max(int(b["the_input"].shape[2]) for b in group))
    K = len(group)
    B = group[0]["the_input"].shape[0]
    canvas = np.full((K, B, hq, wq), 255, np.uint8)
    for k, b in enumerate(group):
        _, h, w = b["the_input"].shape
        canvas[k, :, :h, :w] = b["the_input"]
    return {
        "stacked": K,
        "the_input": canvas,
        "heights": np.stack([b["heights"] for b in group]),
        "widths": np.stack([b["widths"] for b in group]),
        "the_labels": np.stack([b["the_labels"] for b in group]),
        "label_length": np.stack([b["label_length"] for b in group]),
        "batch_index": np.array([b["batch_index"] for b in group], np.int32),
        "bucket": bucket,
        "texts": [b.get("texts") for b in group],
    }


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
