"""The port's program spans (``utils/profiling.py::span``) and the batcher's
queue wait, on the CPU with a narrow model.

* Under ``torch.profiler``, one greedy ``predict`` opens each
  ``crnn.predict.*`` stage once inside its ``crnn.predict`` root; a beam
  ``predict`` opens one ``crnn.beam.frame`` a frame it runs and at least
  that many ``crnn.beam.sync``; ``produce_batch`` and a train step open
  ``crnn.data.upload``, ``crnn.data.resize`` and each ``crnn.train.*``
  stage once, the stages inside ``crnn.train.step``.
* With no profiler, ``span`` is the shared no-op and never builds a
  ``record_function``.
* Predictions and a step's loss and parameters are bitwise equal with and
  without a profiler.
* ``BatcherStats`` and ``/metrics`` carry the queue wait's percentiles.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data import pipeline
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.data.synthetic import SyntheticConfig, SyntheticTextlines
from crnn_ocr_torch.infer.predictor import Predictor
from crnn_ocr_torch.serve import BatcherStats, OCRServer
from crnn_ocr_torch.train.state import create_train_state
from crnn_ocr_torch.train.step import make_train_step
from crnn_ocr_torch.utils import profiling

ALPHABET = "0123456789"
KW = dict(num_classes=len(ALPHABET) + 1, width=64, stem_filters=8,
          block_filters=(8, 8, 12, 12), time_dense_size=16, n_units=16,
          rnn_layers=1)
STAGES = ("pack", "upload", "resize", "forward", "decode", "wait", "to_text")
TRAIN_STAGES = ("forward", "loss", "backward", "optimizer")


def _synth():
    return SyntheticTextlines(SyntheticConfig(alphabet=ALPHABET, min_len=2,
                                              max_len=4))


@pytest.fixture(scope="module")
def predictor():
    cfg = ModelConfig(**KW)
    state = create_train_state(cfg, seed=3, device="cpu")
    return Predictor(cfg, state.model.state_dict(),
                     LabelCodec(_synth().codec.classes), device="cpu")


@pytest.fixture(scope="module")
def images():
    return _synth().sample_batch(6, np.random.default_rng(5))[0]


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("crnn.")]


def _named(spans, name):
    return [e for e in spans if e.name == name]


def _inside(child, parent) -> bool:
    return (parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def test_a_greedy_predict_opens_each_stage_once_inside_its_root(
        predictor, images):
    _, spans = _profiled(lambda: predictor.predict(images, bucket=64))
    (root,) = _named(spans, "crnn.predict")
    for stage in STAGES:
        (e,) = _named(spans, f"crnn.predict.{stage}")
        assert _inside(e, root), stage
    assert not [e for e in spans if e.name.startswith("crnn.beam.")]


def test_a_beam_predict_opens_a_frame_span_a_frame_and_its_syncs(
        predictor, images):
    _, input_len = predictor.predict_probs(images, bucket=64)
    frames = int(input_len.max())
    _, spans = _profiled(lambda: predictor.predict(
        images, bucket=64, greedy=False, beam_width=4))
    assert len(_named(spans, "crnn.beam.frame")) == frames
    # the lengths' read, then one or two ladder tests a frame
    syncs = len(_named(spans, "crnn.beam.sync"))
    assert frames + 1 <= syncs <= 2 * frames + 1
    assert len(_named(spans, "crnn.beam.bound")) == syncs - frames - 1
    assert len(_named(spans, "crnn.beam.exact")) <= len(
        _named(spans, "crnn.beam.bound"))
    (root,) = _named(spans, "crnn.predict")
    (back,) = _named(spans, "crnn.beam.backtrack")
    assert all(_inside(e, root) for e in spans)
    assert _inside(back, _named(spans, "crnn.predict.decode")[0])


def _host_batch(seed=0):
    return next(pipeline.synthetic_batches(batch_size=4, bucket=64,
                                           seed=seed, synth=_synth()))


def _one_step(profiled: bool):
    """A fresh state's first ``produce_batch`` and train step: (loss,
    parameters, the crnn.* spans or None)."""
    cfg = ModelConfig(**KW, dropout_rate=0.2)
    state = create_train_state(cfg, seed=1, device="cpu")
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(7)

    def run():
        batch = pipeline.produce_batch(_host_batch(), torch.device("cpu"),
                                       cfg)
        return step(state, batch, gen)

    m, spans = _profiled(run) if profiled else (run(), None)
    return m["loss"], [p.detach().clone()
                       for p in state.model.parameters()], spans


def test_a_train_step_opens_each_stage_once_inside_its_root():
    _, _, spans = _one_step(profiled=True)
    # the images go up, the resize is enqueued, then the labels go up
    first, labels = sorted(_named(spans, "crnn.data.upload"),
                           key=lambda e: e.time_range.start)
    (resize,) = _named(spans, "crnn.data.resize")
    assert first.time_range.end <= resize.time_range.start
    assert resize.time_range.end <= labels.time_range.start
    (root,) = _named(spans, "crnn.train.step")
    for stage in TRAIN_STAGES:
        (e,) = _named(spans, f"crnn.train.{stage}")
        assert _inside(e, root), stage
    assert not _named(spans, "crnn.train.all_reduce")  # no mesh
    assert not _named(spans, "crnn.data.augment")


def test_the_smoke_counts_no_range_row_as_busy():
    """``chip_smoke``'s device busy time and top ops leave out the rows
    that ranges leave on the device's timeline (first kernel to last, the
    gaps between included): a ``crnn.*`` span's, a ``RANGES`` name's, any
    host user range's. The busy time is the kernels' alone."""
    from types import SimpleNamespace as NS

    import chip_smoke

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev, start, end, ann=False):
        return NS(name=name, device_type=dev, is_user_annotation=ann,
                  time_range=NS(start=start, end=end))

    events = [ev("crnn.predict.forward", cpu, 0, 50, True),
              ev("crnn.predict.forward", cuda, 10, 1000),
              ev("an_operators_range", cpu, 0, 50, True),
              ev("an_operators_range", cuda, 10, 1000),
              ev("bigru_backward", cuda, 10, 1000),
              ev("kernel_a", cuda, 10, 20), ev("kernel_b", cuda, 990, 1000)]
    rows = [NS(key=k, self_device_time_total=t, self_cpu_time_total=t,
               count=1)
            for k, t in (("crnn.predict.forward", 990), ("bigru_backward", 990),
                         ("an_operators_range", 990), ("kernel_a", 10),
                         ("kernel_b", 10))]
    prof = NS(events=lambda: events, key_averages=lambda: rows)
    assert [e.name for e in chip_smoke.device_work(prof)] == ["kernel_a",
                                                              "kernel_b"]
    out = chip_smoke._trace_summary(prof, 2000.0, 1)
    assert out["device_busy_ms_per_iteration"] == pytest.approx(0.02)
    assert out["device_idle_share"] == pytest.approx(0.99)
    assert {k for k, _ in out["top_device_ms"]} == {"kernel_a", "kernel_b"}


def test_no_profiler_no_record_function(monkeypatch, predictor, images):
    def refuse(*a, **kw):
        raise AssertionError("record_function with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("crnn.x") is profiling.span("crnn.y")
    assert len(predictor.predict(images, bucket=64)) == len(images)
    assert len(predictor.predict(images[:2], bucket=64, greedy=False,
                                 beam_width=3)) == 2
    loss, _, _ = _one_step(profiled=False)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("decode", [dict(), dict(greedy=False, beam_width=4)])
def test_predictions_are_bitwise_equal_with_and_without_a_profiler(
        predictor, images, decode):
    plain = predictor.predict(images, bucket=64, **decode)
    traced, spans = _profiled(lambda: predictor.predict(images, bucket=64,
                                                        **decode))
    assert spans
    assert [(p.text, p.score) for p in plain] == \
        [(p.text, p.score) for p in traced]


def test_a_step_is_bitwise_equal_with_and_without_a_profiler():
    loss0, params0, _ = _one_step(profiled=False)
    loss1, params1, spans = _one_step(profiled=True)
    assert spans
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))


def test_batcher_stats_carry_the_queue_wait():
    s = BatcherStats()
    assert s.snapshot()["queue_wait_ms_p50"] is None
    s.record_batch(2, [10.0, 12.0], [1.0, 3.0])
    s.record_batch(1, [20.0], [5.0])
    snap = s.snapshot()
    assert snap["queue_wait_ms_p50"] == 3.0
    assert snap["queue_wait_ms_p95"] == pytest.approx(4.8)
    assert snap["latency_ms_p50"] == 12.0


def test_metrics_export_the_queue_wait(predictor, images):
    srv = OCRServer(predictor, host="127.0.0.1", port=0, max_batch=2,
                    max_wait_ms=5.0).start()
    try:
        fut = srv.batcher.submit(images[0])
        fut.result(timeout=60)
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            snap = json.loads(r.read())
        assert 0 <= snap["queue_wait_ms_p50"] <= snap["latency_ms_p50"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            body = r.read().decode()
        for q in ("p50", "p95"):
            assert f"# TYPE ocr_queue_wait_ms_{q} gauge" in body
            assert f"ocr_queue_wait_ms_{q} {snap[f'queue_wait_ms_{q}']}" \
                in body
    finally:
        srv.stop()
