"""Port parity: greedy and forced alignment (``crnn_ocr_torch/ops/ctc.py``)
and the predictor's beam and alignment surface against the JAX package's,
on the CPU.

Frames (starts, ends) and labels must be equal; confidences are the
probabilities themselves, held to rtol 1e-6. The predictors run a narrow
CRNN in f32 with the same weights on both sides: texts, candidates and
spans equal, scores within rtol 1e-4 (atol 1e-5), the greedy path's
tolerance in ``tests/test_torch_predictor.py``.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data.codec import LabelCodec
from crnn_ocr_torch.infer.predictor import Predictor
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.ops import ctc as tctc
from crnn_ocr_tpu.data.codec import LabelCodec as JaxCodec
from crnn_ocr_tpu.infer.h5_import import import_keras_h5
from crnn_ocr_tpu.infer.predictor import Predictor as JaxPredictor
from crnn_ocr_tpu.models import ModelConfig
from crnn_ocr_tpu.ops import ctc as jctc

GOLDENS = pathlib.Path(__file__).parent / "goldens"


def _probs(rng, B, T, C, peak):
    p = np.exp(peak * rng.random((B, T, C))).astype(np.float32)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _assert_align(got, want, n_int):
    for g, w in zip(got[:n_int], want[:n_int]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[n_int].numpy(), np.asarray(want[n_int]),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("B,T,C,peak", [(4, 12, 6, 3.0), (6, 30, 20, 8.0),
                                        (3, 9, 3, 1.0)])
def test_greedy_alignment_matches_jax(B, T, C, peak):
    rng = np.random.default_rng(B * T)
    probs = _probs(rng, B, T, C, peak)
    il = rng.integers(1, T + 1, (B,)).astype(np.int32)
    got = tctc.ctc_greedy_alignment(torch.from_numpy(probs),
                                    torch.from_numpy(il))
    _assert_align(got, jctc.ctc_greedy_alignment(probs, il), 3)
    # the labels are greedy decode's (merge_repeated) output
    dec, _ = tctc.ctc_greedy_decode(torch.from_numpy(probs),
                                    torch.from_numpy(il))
    np.testing.assert_array_equal(got[0].numpy(), dec.numpy())


@pytest.mark.parametrize("B,T,C,L", [(5, 14, 7, 4), (4, 20, 12, 9)])
def test_forced_alignment_matches_jax(B, T, C, L):
    """Random label sequences, some too long for their inputs (infeasible:
    every span -1), and empty ones (label_length 0)."""
    rng = np.random.default_rng(B + T)
    probs = _probs(rng, B, T, C, 4.0)
    il = rng.integers(1, T + 1, (B,)).astype(np.int32)
    labels = rng.integers(0, C - 1, (B, L)).astype(np.int32)
    ll = rng.integers(0, L + 1, (B,)).astype(np.int32)
    ll[0], il[1], ll[1] = 0, 2, L  # empty; infeasible
    got = tctc.ctc_forced_alignment(*map(torch.from_numpy,
                                         (probs, il, labels, ll)))
    want = jctc.ctc_forced_alignment(probs, il, labels, ll)
    _assert_align(got, want, 2)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert not bool(got[3][1]) and (got[0][1] == -1).all()
    assert (got[0][0] == -1).all() and bool(got[3][0])


def test_forced_alignment_double_letter():
    """"aa" needs a blank between its letters: peaked frames [a, a, blank,
    a] align the first a to frames 0-1 and the second to frame 3; with
    three frames and no blank room the path is infeasible."""
    C = 3  # labels {0, 1}, blank 2
    frames = np.full((4, C), 1e-3, np.float32)
    frames[[0, 1, 3], 0] = 1.0
    frames[2, 2] = 1.0
    probs = np.stack([frames, frames]) / frames.sum(-1, keepdims=True)
    probs = probs.astype(np.float32)
    il = np.array([4, 2], np.int32)
    labels = np.zeros((2, 2), np.int32)
    ll = np.array([2, 2], np.int32)
    got = tctc.ctc_forced_alignment(*map(torch.from_numpy,
                                         (probs, il, labels, ll)))
    _assert_align(got, jctc.ctc_forced_alignment(probs, il, labels, ll), 2)
    assert got[0][0].tolist() == [0, 3] and got[1][0].tolist() == [1, 3]
    assert got[3].tolist() == [True, False]


def _narrow_predictors():
    """The narrow GRU CRNN of ``tests/test_keras_parity.py`` (f32, its
    golden ``.h5`` weights) behind both packages' predictors."""
    kw = dict(num_classes=12, width=64, stem_filters=8,
              block_filters=(16, 16, 24, 24), time_dense_size=16, n_units=12,
              rnn_layers=1, rnn_cell="gru", dropout_rate=0.0)
    jcfg = ModelConfig(**kw)
    params, stats = import_keras_h5(
        str(GOLDENS / "keras_small_gru_weights.h5"), jcfg)
    alphabet = "abcdefghijkl"
    ref = JaxPredictor(jcfg, params, stats, JaxCodec.from_alphabet(alphabet),
                       buckets=(64, 96))
    port = Predictor(
        TorchConfig(**kw),
        params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                        jax.tree_util.tree_map(np.asarray, stats)),
        LabelCodec.from_alphabet(alphabet), buckets=(64, 96), device="cpu")
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (32, int(w))).astype(np.uint8)
              for w in (40, 64, 88, 57, 96, 71)]
    return ref, port, images


def _spans(preds):
    return [[(s.char, s.x0, s.x1) for s in p] for p in preds]


def _confs(preds):
    return [s.conf for p in preds for s in p]


@pytest.mark.parametrize("exact_tf", [False, True])
def test_predictor_beam_surface_matches_jax(exact_tf):
    ref, port, images = _narrow_predictors()
    kw = dict(greedy=False, top_paths=2, alignments=True, exact_tf=exact_tf)
    want, got = ref.predict(images, **kw), port.predict(images, **kw)
    assert [p.text for p in got] == [p.text for p in want]
    assert ([[c[0] for c in p.candidates] for p in got]
            == [[c[0] for c in p.candidates] for p in want])
    np.testing.assert_allclose(
        [c[1] for p in got for c in p.candidates],
        [c[1] for p in want for c in p.candidates], rtol=1e-4, atol=1e-5)
    assert _spans([p.spans for p in got]) == _spans([p.spans for p in want])
    np.testing.assert_allclose(_confs([p.spans for p in got]),
                               _confs([p.spans for p in want]), rtol=1e-4)
    assert any(p.spans for p in got)  # the spans are not all empty
    assert [p.text for p in got] == ["".join(s.char for s in p.spans)
                                     for p in got]


def test_predict_with_alignment_matches_jax():
    ref, port, images = _narrow_predictors()
    want = ref.predict_with_alignment(images)
    got = port.predict_with_alignment(images)
    assert _spans(got) == _spans(want)
    np.testing.assert_allclose(_confs(got), _confs(want), rtol=1e-4)
    greedy = port.predict(images, alignments=True)
    assert _spans(got) == _spans([p.spans for p in greedy])
    assert port.default_merge_repeated is False  # provenance "native"
