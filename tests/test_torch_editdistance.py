"""Port parity: the edit distances and the host C++ of item 12
(``crnn_ocr_torch/ops/editdistance.py``, ``crnn_ocr_torch/native/``,
``utils/metrics.py``, ``evaluate(on_device_cer=True)``) against
``crnn_ocr_tpu``'s.

Tolerances: the edit distances, their sums and the CERs built from them
are integers or ratios of integers, held equal; the C++ line preprocess
(built here with ``-O3``, the JAX package's with ``-march=native``, which
lets g++ fuse products into FMAs) at atol 1e-6 against JAX's, and at 2e-2
against cv2, as ``tests/test_native.py`` holds JAX's; the eval loss rtol
1e-4, as ``tests/test_torch_eval.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch import native
from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.ops import editdistance as ted
from crnn_ocr_torch.train import loop as tloop
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep
from crnn_ocr_torch.utils import metrics as tmetrics
from crnn_ocr_tpu import native as jnative
from crnn_ocr_tpu.data import pipeline as jpipe
from crnn_ocr_tpu.data.synthetic import SyntheticConfig as JSynthCfg
from crnn_ocr_tpu.data.synthetic import SyntheticTextlines as JSynth
from crnn_ocr_tpu.models import ModelConfig as JaxConfig
from crnn_ocr_tpu.ops import editdistance as jed
from crnn_ocr_tpu.train import loop as jloop
from crnn_ocr_tpu.train import state as jstate
from crnn_ocr_tpu.train import step as jstep
from crnn_ocr_tpu.utils.metrics import _levenshtein_py

NARROW = dict(num_classes=10, width=64, stem_filters=8,
              block_filters=(8, 8, 12, 12), time_dense_size=16, n_units=16,
              rnn_layers=1, dropout_rate=0.0)
KEYS = ("x", "input_length", "the_labels", "label_length")


def _oracle(a, la, b, lb):
    return np.array([tmetrics.levenshtein_plain(list(a[i, :la[i]]),
                                                list(b[i, :lb[i]]))
                     for i in range(a.shape[0])])


def _port(a, la, b, lb):
    return ted.batched_levenshtein(*(torch.from_numpy(np.asarray(v))
                                     for v in (a, la, b, lb)))


@pytest.mark.parametrize(
    "seed,B,La,Lb,vocab",
    [(0, 32, 23, 17, 5), (1, 16, 8, 31, 2), (2, 8, 1, 1, 3),
     (3, 8, 0, 6, 2), (4, 8, 6, 0, 2), (5, 4, 0, 0, 2)])
def test_batched_levenshtein_fuzz_matches_jax_and_oracle(seed, B, La, Lb,
                                                         vocab):
    """JAX's fuzz cases (``tests/test_editdistance.py:28``), and empty
    label axes on either side."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, vocab, (B, La)).astype(np.int32)
    b = rng.integers(0, vocab, (B, Lb)).astype(np.int32)
    la = rng.integers(0, La + 1, B).astype(np.int32)
    lb = rng.integers(0, Lb + 1, B).astype(np.int32)
    got = _port(a, la, b, lb)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), _oracle(a, la, b, lb))
    if La and Lb:  # JAX's scan needs a label axis on both sides
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jed.batched_levenshtein(a, la, b, lb)))


def test_degenerate_lengths():
    a = np.array([[1, 2, 3]], np.int32)
    b = np.array([[1, 9, 3, 4]], np.int32)
    z = np.zeros(1, np.int32)
    for la, lb, want in ((z, z, 0), (np.array([3]), z, 3),
                         (z, np.array([4]), 4),
                         (np.array([1]), np.array([1]), 0)):
        assert int(_port(a, la, b, lb)[0]) == want
        assert int(jed.batched_levenshtein(a, la, b, lb)[0]) == want
    # garbage past the lengths does not matter
    a2 = a.copy()
    a2[0, 2] = 77
    two = np.array([2])
    assert int(_port(a2, two, b, two)[0]) == int(_port(a, two, b, two)[0])


def test_cer_sums_match_jax():
    """JAX's case (``tests/test_editdistance.py:58``): two device scalars."""
    dec = np.full((3, 6), -1, np.int32)
    dec[0, :3] = [1, 2, 3]
    dec[1, :2] = [1, 1]
    ref = np.array([[1, 2, 3], [2, 1, 0], [5, 0, 0]], np.int32)
    rl = np.array([3, 2, 1], np.int32)
    s, t = ted.cer_sums_on_device(*(torch.from_numpy(v)
                                    for v in (dec, ref, rl)))
    js, jt = jed.cer_sums_on_device(dec, ref, rl)
    assert s.dim() == 0 and t.dim() == 0
    assert (int(s), int(t)) == (int(js), int(jt)) == (2, 6)


def _pairs(kind, rng, n=40):
    for _ in range(n):
        na, nb = rng.integers(0, 20, 2)
        if kind == "str":
            yield ("".join(chr(97 + c) for c in rng.integers(0, 5, na)),
                   "".join(chr(0x4E00 + c) if c == 4 else chr(97 + c)
                           for c in rng.integers(0, 5, nb)))
        elif kind == "int":
            yield (list(rng.integers(0, 4, na)),
                   [int(v) for v in rng.integers(0, 4, nb)])
        else:
            words = ["the", "a", "cat", "sat", "mat"]
            yield ([words[c] for c in rng.integers(0, 5, na)],
                   [words[c] for c in rng.integers(0, 5, nb)])


@pytest.mark.parametrize("kind", ["str", "int", "tokens"])
def test_native_editdistance_matches_jax_and_oracle(kind):
    rng = np.random.default_rng({"str": 0, "int": 1, "tokens": 2}[kind])
    for a, b in _pairs(kind, rng):
        want = _levenshtein_py(a, b)
        assert tmetrics.levenshtein_plain(a, b) == want
        assert native.editdistance(a, b) == want, (a, b)
        assert tmetrics.levenshtein(a, b) == want
        assert jnative.editdistance(a, b) == want
    assert native.editdistance(["a", "b"], ["a", "c", "b"]) == 1
    assert tmetrics.wer(["a b", "c"], ["a c", "c"]) == 1 / 3


def test_native_editdistance_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "editdistance.cc"
    bad.write_text("int levenshtein_i32( {\n")
    monkeypatch.setitem(native.SOURCES, "editdistance", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed for .*editdistance.cc"):
        tmetrics.cer(["ab"], ["ac"])


@pytest.mark.parametrize("normalize", [True, False])
def test_native_preprocess_line_matches_jax_and_cv2(normalize):
    from crnn_ocr_tpu.ops.preprocess import preprocess_host  # cv2

    rng = np.random.default_rng(2)
    for h, w in [(48, 200), (32, 128), (64, 90), (20, 7), (32, 400)]:
        img = rng.integers(0, 255, (h, w)).astype(np.uint8)
        got, w_new = native.preprocess_line(img, 32, 128, normalize)
        want, jw = jnative.preprocess_line(img, 32, 128, normalize)
        assert w_new == jw and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            got, preprocess_host(img, 32, 128, normalize), atol=2e-2)


def test_evaluate_on_device_cer_matches_jax():
    """``evaluate(on_device_cer=True)`` against JAX's on the same weights
    and batches, and against the port's host CER (texts and a codec: the
    two are equal, as the codec maps labels to characters one to one);
    the codec-less call gives the same label-space CER."""
    synth = JSynth(JSynthCfg(alphabet="0123456789", min_len=2, max_len=5))
    cdc = synth.codec
    batches = [dict({k: np.asarray(b[k]) for k in KEYS}, texts=b["texts"])
               for b in jpipe.device_batches(jpipe.synthetic_batches(
                   batch_size=8, bucket=64, seed=9, steps=2, synth=synth),
                   prefetch=0)]
    jcfg = JaxConfig(**NARROW, use_pallas_rnn=True, use_fused_stem=False)
    js = jstate.create_train_state(jcfg, jax.random.key(3),
                                   pallas_interpret=True)
    tcfg = TorchConfig(**NARROW)
    ts = tstate.create_train_state(tcfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params),
        jax.tree_util.tree_map(np.asarray, js.batch_stats)), device="cpu")
    want = jloop.evaluate(
        js, jstep.make_eval_step(jcfg),
        iter([dict({k: jnp.asarray(b[k]) for k in KEYS}, texts=b["texts"])
              for b in batches]), cdc, on_device_cer=True)

    def run(**kw):
        return tloop.evaluate(
            ts, tstep.make_eval_step(tcfg),
            iter([dict({k: torch.from_numpy(b[k].copy()) for k in KEYS},
                       texts=b["texts"]) for b in batches]), **kw)

    dev = run(codec=cdc, on_device_cer=True)
    host = run(codec=cdc)
    nocodec = run(codec=None)
    assert want["cer"] > 0.0
    assert dev["cer"] == want["cer"] == host["cer"] == nocodec["cer"]
    for key in ("wer", "seq_acc"):
        assert dev[key] == want[key] == host[key], key
    np.testing.assert_allclose(dev["loss"], want["loss"], rtol=1e-4)
    assert np.isnan(nocodec["wer"])
