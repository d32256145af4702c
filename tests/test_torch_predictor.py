"""Port parity: crnn_ocr_torch's Predictor and pretrained models on the CPU.

``load_pretrained(..., device="cpu")`` against the JAX package's Predictor
on the committed golden lines (``crnn_ocr_torch/testdata/
greedy_goldens.npz``, from ``tools/gen_torch_goldens.py``): texts equal,
scores within rtol 1e-4 (atol 1e-5: a score is minus a sum of about 60
log-probabilities, and a near-certain line scores near 0, where only an
absolute bound is meaningful). ``fonts-hard`` is forced to f32 for that
comparison; as shipped (bf16) it is held to the JAX bf16 golden texts.
"""

import os

import numpy as np
import pytest
import torch

import crnn_ocr_torch
from crnn_ocr_torch import load_pretrained
from crnn_ocr_tpu.infer import load_pretrained as jax_load_pretrained
from crnn_ocr_tpu.infer.predictor import Predictor as JaxPredictor

GOLDENS = os.path.join(os.path.dirname(crnn_ocr_torch.__file__), "testdata",
                       "greedy_goldens.npz")
KEYS = {"fonts-small": "small", "fonts-hard": "hard"}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDENS)


def _lines(g, key, n=None):
    c, hs, ws = g[f"{key}_canvas"], g[f"{key}_heights"], g[f"{key}_widths"]
    n = n or len(hs)
    return [c[i, :hs[i], :ws[i]] for i in range(n)]


@pytest.mark.parametrize("name", sorted(KEYS))
def test_predictor_matches_jax_predictor(golden, name):
    import dataclasses

    lines = _lines(golden, KEYS[name], 8)
    ref = jax_load_pretrained(name)
    cfg = dataclasses.replace(ref.cfg, dtype="float32")
    ref = JaxPredictor(cfg, ref._vars["params"], ref._vars["batch_stats"],
                       ref.codec)
    want = ref.predict(lines)
    got = load_pretrained(name, device="cpu", dtype="float32").predict(lines)
    assert [p.text for p in got] == [p.text for p in want]
    np.testing.assert_allclose([p.score for p in got],
                               [p.score for p in want], rtol=1e-4, atol=1e-5)
    probs, il = load_pretrained(name, device="cpu", dtype="float32") \
        .predict_probs(lines)
    want_probs, want_il = ref.predict_probs(lines)
    np.testing.assert_array_equal(il.numpy(), np.asarray(want_il))
    assert tuple(probs.shape) == want_probs.shape


@pytest.mark.parametrize("name", sorted(KEYS))
def test_f32_reads_all_golden_lines(golden, name):
    key = KEYS[name]
    got = load_pretrained(name, device="cpu", dtype="float32").predict(
        _lines(golden, key))
    assert [p.text for p in got] == [str(t) for t in golden[f"{key}_texts_f32"]]
    np.testing.assert_allclose([p.score for p in got],
                               golden[f"{key}_scores_f32"], rtol=1e-4,
                               atol=1e-5)


def test_fonts_hard_bf16_reads_golden_lines(golden):
    """As shipped (bf16): at most 1 of the 64 lines may differ from the JAX
    package's bf16 texts (its Pallas kernels in interpret mode)."""
    pred = load_pretrained("fonts-hard", device="cpu")
    assert pred.model.dtype == torch.bfloat16
    got = [p.text for p in pred.predict(_lines(golden, "hard"))]
    want = [str(t) for t in golden["hard_texts_bf16"]]
    assert sum(a != b for a, b in zip(got, want)) <= 1


def test_bucket_routing_matches_jax():
    ref = jax_load_pretrained("fonts-small")
    pred = load_pretrained("fonts-small", device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(20):
        imgs = [np.zeros((int(rng.integers(8, 80)), int(rng.integers(4, 600))),
                         np.uint8) for _ in range(3)]
        assert pred.resolve_bucket(imgs) == ref.resolve_bucket(imgs)
    assert pred.resolve_bucket(imgs, 192) == 192


def test_entry_points_refuse_what_is_not_ported():
    """A model the port does not have raises; beam decoding, once refused
    here, is ported (``tests/test_torch_beam.py`` holds it to JAX)."""
    pred = load_pretrained("fonts-small", device="cpu")
    out = pred.predict([np.full((32, 40), 255, np.uint8)], greedy=False)
    assert len(out) == 1 and isinstance(out[0].text, str)
    with pytest.raises(NotImplementedError, match="not available"):
        load_pretrained("nope", device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_pretrained("fonts-small")
