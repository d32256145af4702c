"""Port parity: evaluation and the fit loop with evaluation
(``crnn_ocr_torch/train/loop.py`` against ``crnn_ocr_tpu/train/loop.py``).

The same narrow CRNN weights and the same batches (made by the JAX
package's synthetic pipeline from a seed) go through both packages; JAX
runs its Pallas recurrence in interpret mode, the port its plain versions.
Tolerances:

* the label-space CER of batches without texts: equal within 1e-6 (the
  same integer edit distances over the same label count, unless a frame's
  two top logits tie within f32 noise); the mean eval loss rtol 1e-4;
* ``fit`` with evaluation on a narrow BiLSTM CRNN: the BatchNorm running
  statistics after the run atol 1e-4, every evaluation's loss rtol 1e-3
  (f32 sums in another order, carried through a few Adam steps).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.train import loop as tloop
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep
from crnn_ocr_tpu.data import pipeline as jpipe
from crnn_ocr_tpu.data.synthetic import SyntheticConfig as JSynthCfg
from crnn_ocr_tpu.data.synthetic import SyntheticTextlines as JSynth
from crnn_ocr_tpu.models import ModelConfig as JaxConfig
from crnn_ocr_tpu.train import loop as jloop
from crnn_ocr_tpu.train import state as jstate
from crnn_ocr_tpu.train import step as jstep

LR = 1e-3
ALPHABET = "0123456789"
NARROW = dict(num_classes=len(ALPHABET), width=64, stem_filters=8,
              block_filters=(8, 8, 12, 12), time_dense_size=16, n_units=32,
              rnn_layers=1, dropout_rate=0.0)
KEYS = ("x", "input_length", "the_labels", "label_length")


def _batches(n, seed, B=16):
    """``n`` device batches of the JAX pipeline as numpy arrays, with the
    lines' texts."""
    synth = JSynth(JSynthCfg(alphabet=ALPHABET, min_len=2, max_len=5))
    host = jpipe.synthetic_batches(batch_size=B, bucket=64, seed=seed,
                                   steps=n, synth=synth)
    out = []
    for b in jpipe.device_batches(host, prefetch=0):
        nb = {k: np.asarray(b[k]) for k in KEYS}
        nb["texts"] = list(b["texts"])
        out.append(nb)
    return out, synth.codec


def _jax_batch(b, texts: bool):
    out = {k: jnp.asarray(b[k]) for k in KEYS}
    if texts:
        out["texts"] = b["texts"]
    return out


def _torch_batch(b, texts: bool):
    out = {k: torch.from_numpy(np.array(b[k])) for k in KEYS}
    if texts:
        out["texts"] = b["texts"]
    return out


def _states(cell: str):
    jcfg = JaxConfig(**NARROW, dtype="float32", rnn_cell=cell,
                     use_pallas_rnn=True, use_fused_stem=False)
    js = jstate.create_train_state(jcfg, jax.random.key(3), learning_rate=LR,
                                   pallas_interpret=True)
    init = (jax.tree_util.tree_map(np.asarray, js.params),
            jax.tree_util.tree_map(np.asarray, js.batch_stats))
    tcfg = TorchConfig(**NARROW, rnn_cell=cell)
    ts = tstate.create_train_state(tcfg, params_from_jax(*init),
                                   device="cpu", learning_rate=LR)
    return jcfg, js, tcfg, ts


@pytest.mark.parametrize("texts,codec", [(False, True), (True, False)],
                         ids=["no-texts", "no-codec"])
def test_evaluate_label_space_cer_matches_jax(texts, codec):
    """Fault F1: without texts or without a codec, the CER is the
    label-space edit distance over the label count, as JAX computes it;
    WER and sequence accuracy are NaN in both."""
    batches, cdc = _batches(2, seed=7)
    jcfg, js, tcfg, ts = _states("gru")
    want = jloop.evaluate(js, jstep.make_eval_step(jcfg),
                          iter([_jax_batch(b, texts) for b in batches]),
                          cdc if codec else None)
    got = tloop.evaluate(ts, tstep.make_eval_step(tcfg),
                         iter([_torch_batch(b, texts) for b in batches]),
                         cdc if codec else None)
    assert np.isfinite(want["cer"]) and want["cer"] > 0.0
    assert abs(got["cer"] - want["cer"]) <= 1e-6, (got["cer"], want["cer"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for key in ("wer", "seq_acc"):
        assert np.isnan(got[key]) and np.isnan(want[key]), key


def test_evaluate_text_cer_and_nan_without_labels():
    """With texts and a codec the CER is the text CER (JAX's host path);
    with neither texts nor labels every metric but the loss is NaN."""
    batches, cdc = _batches(1, seed=8)
    jcfg, js, tcfg, ts = _states("gru")
    want = jloop.evaluate(js, jstep.make_eval_step(jcfg),
                          iter([_jax_batch(batches[0], True)]), cdc)
    got = tloop.evaluate(ts, tstep.make_eval_step(tcfg),
                         iter([_torch_batch(batches[0], True)]), cdc)
    for key in ("cer", "wer", "seq_acc"):
        assert abs(got[key] - want[key]) <= 1e-6, key

    unlabelled = _Unlabelled(_torch_batch(batches[0], False))
    ev = tloop.evaluate(ts, tstep.make_eval_step(tcfg), iter([unlabelled]),
                        None)
    assert np.isfinite(ev["loss"])
    assert all(np.isnan(ev[k]) for k in ("cer", "wer", "seq_acc"))


class _Unlabelled(dict):
    """A batch the eval step reads in full, but whose labels ``evaluate``
    does not see (``"the_labels" in batch`` is False)."""

    def __contains__(self, key):
        return key != "the_labels" and dict.__contains__(self, key)


def _fit_records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_lstm_fit_with_evaluation_matches_jax(tmp_path):
    """Fault F2, settled: a narrow BiLSTM CRNN through both packages' ``fit``
    for 6 steps, evaluating every 3 on text-less batches. The BatchNorm
    running statistics after the run and each evaluation's loss agree, so
    the slow drift of ``rnn_bn``'s statistics (momentum 0.99) that keeps a
    fine-tuned model's eval loss far above its train loss is the reference's
    own behaviour, not the port's."""
    train, _ = _batches(6, seed=11)
    evals, _ = _batches(1, seed=12)
    jcfg, js, tcfg, ts = _states("lstm")
    fit_kw = dict(steps=6, eval_every=3, eval_batches=1, log_every=3)
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    js = jloop.fit(js, jcfg, iter([_jax_batch(b, False) for b in train]),
                   lambda: iter([_jax_batch(b, False) for b in evals]), None,
                   jloop.FitConfig(metrics_path=str(jpath), **fit_kw))
    tloop.fit(ts, tcfg, iter([_torch_batch(b, False) for b in train]),
              lambda: iter([_torch_batch(b, False) for b in evals]), None,
              tloop.FitConfig(metrics_path=str(tpath), **fit_kw))
    assert int(js.step) == ts.step == 6
    want = [r for r in _fit_records(jpath) if r["kind"] == "eval"]
    got = [r for r in _fit_records(tpath) if r["kind"] == "eval"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3, 6]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-3)
        assert np.isfinite(g["cer"]) and abs(g["cer"] - w["cer"]) <= 1e-6
    stats = params_from_jax(
        jax.tree_util.tree_map(np.asarray, js.params),
        jax.tree_util.tree_map(np.asarray, js.batch_stats))
    port = ts.model.state_dict()
    names = [k for k in stats if k.startswith("rnn_bn") and "running" in k]
    assert names
    for k in names:
        np.testing.assert_allclose(port[k].numpy(), stats[k].numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)
