"""The STN's program spans (``models/stn.py``, ``kernels/grid_sample.py``)
on the CPU with a narrow ``use_stn`` model.

* A forward opens ``crnn.stn.localize`` then ``crnn.stn.warp``, once each;
  in a train step both sit inside ``crnn.train.forward``, and the
  sampler's backward opens ``grid_sample_backward`` once, inside
  ``crnn.train.backward`` (on the CPU autograd runs it on the caller's
  thread; on the card on its device thread, which the profiler's state
  reaches too).
* With no profiler none of them builds a ``record_function``.
* A step's loss and parameters are bitwise equal with and without a
  profiler.
"""

import numpy as np
import torch

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.data import pipeline
from crnn_ocr_torch.train.state import create_train_state
from crnn_ocr_torch.train.step import make_train_step

KW = dict(num_classes=11, height=32, width=64, stem_filters=8,
          block_filters=(8, 8, 12, 12), time_dense_size=16, n_units=16,
          rnn_layers=1, use_stn=True)
NAMES = ("crnn.stn.localize", "crnn.stn.warp", "grid_sample_backward",
         "crnn.train.forward", "crnn.train.backward")


def _state():
    state = create_train_state(ModelConfig(**KW), seed=4, device="cpu")
    with torch.no_grad():  # theta off the identity: the warp samples
        state.model.stn.theta.bias.copy_(torch.tensor(
            [0.95, 0.04, -0.03, 0.02, 0.9, 0.05]))
    return state


def _batch(cfg):
    rng = np.random.default_rng(2)
    host = {"the_input": rng.integers(0, 256, (4, 28, 60), np.uint8),
            "heights": np.array([28, 20, 24, 16], np.int32),
            "widths": np.array([60, 40, 52, 30], np.int32),
            "the_labels": np.array([[1, 2, 0], [3, 0, 0], [4, 4, 0],
                                    [5, 6, 7]], np.int32),
            "label_length": np.array([2, 1, 2, 3], np.int32), "bucket": 64}
    b = pipeline.produce_batch(host, "cpu", cfg)
    return {k: v for k, v in b.items() if k not in ("texts", "bucket")}


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in NAMES]


def _named(spans, name):
    return [e for e in spans if e.name == name]


def _inside(child, parent) -> bool:
    return (parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def _step(profiled: bool):
    state = _state()
    batch = _batch(state.model.cfg)
    step = make_train_step(state.model.cfg)

    def run():
        return step(state, batch, torch.Generator().manual_seed(9))["loss"]

    loss, spans = _profiled(run) if profiled else (run(), [])
    return loss, [p.detach().clone() for p in state.model.parameters()], \
        spans


def test_a_forward_opens_localize_then_warp():
    state = _state()
    model = state.model.eval()
    x = torch.randn(2, 32, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, spans = _profiled(lambda: model(x))
    (loc,) = _named(spans, "crnn.stn.localize")
    (warp,) = _named(spans, "crnn.stn.warp")
    assert loc.time_range.end <= warp.time_range.start
    assert not _named(spans, "grid_sample_backward")


def test_a_train_step_opens_the_stn_spans_in_its_stages():
    _, _, spans = _step(profiled=True)
    (fwd,) = _named(spans, "crnn.train.forward")
    (bwd,) = _named(spans, "crnn.train.backward")
    for name in ("crnn.stn.localize", "crnn.stn.warp"):
        (e,) = _named(spans, name)
        assert _inside(e, fwd), name
    (g,) = _named(spans, "grid_sample_backward")
    assert _inside(g, bwd)


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    loss, _, _ = _step(profiled=False)
    assert torch.isfinite(loss)


def test_a_step_is_bitwise_equal_with_and_without_a_profiler():
    loss0, params0, _ = _step(profiled=False)
    loss1, params1, spans = _step(profiled=True)
    assert _named(spans, "grid_sample_backward")
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))
