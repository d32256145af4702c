"""Port parity: the host beam decoders (``crnn_ocr_torch/ops/
ctc_beam_exact.py``'s numpy oracle and its C++ twin, ``native/
ctc_beam_tf.cc``) against the JAX package's, bit for bit, and the device
beam against the port's own oracle on the degenerate-tie contract.
"""

import numpy as np
import pytest
import torch

from crnn_ocr_torch import native
from crnn_ocr_torch.ops import ctc_beam_exact as texact
from crnn_ocr_torch.ops.ctc_beam_device import ctc_beam_search_decode_tf
from crnn_ocr_tpu import native as jax_native
from crnn_ocr_tpu.ops import ctc_beam_exact as jexact


def _fuzz(seed: int, n: int):
    """``tools/fuzz_beam_oracle.py``'s distribution: (probs, lengths, W,
    top_paths) per config."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        B, T, C = (int(rng.integers(1, 4)), int(rng.integers(2, 24)),
                   int(rng.integers(3, 30)))
        bw = int(rng.integers(1, 12))
        tp = int(rng.integers(1, bw + 1))
        probs = rng.random((B, T, C)).astype(np.float32)
        if rng.random() < 0.5:
            probs = np.exp(rng.uniform(1, 7) * probs)
        probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
        yield probs, rng.integers(1, T + 1, (B,)).astype(np.int32), bw, tp


def _golden_cases(goldens):
    d = goldens("ctc_beam.npz")
    return [(d[f"b{i}_probs"], d[f"b{i}_input_len"],
             int(d[f"b{i}_beam_width"]), int(d[f"b{i}_top_paths"]))
            for i in range(int(d["n_cases"]))]


@pytest.mark.parametrize("source", ["goldens", "fuzz"])
def test_numpy_oracle_matches_jax_oracle_bit_for_bit(goldens, source):
    cases = (_golden_cases(goldens) if source == "goldens"
             else list(_fuzz(1, 60)))
    for probs, il, bw, tp in cases:
        logits = np.log(probs + texact.KERAS_EPSILON)
        for merge in (True, False):
            for b in range(probs.shape[0]):
                args = (logits[b], int(il[b]), bw, tp, merge)
                assert texact._decode_one(*args) == jexact._decode_one(*args)


@pytest.mark.parametrize("source", ["goldens", "fuzz"])
def test_cpp_decoder_matches_jax_bit_for_bit(goldens, source):
    """The C++ copy against the JAX package's C++ decoder (paths, lengths
    and scores bit for bit) and, through ``ctc_beam_search_decode_exact``,
    against JAX's dense layout; labels against the numpy oracle."""
    cases = (_golden_cases(goldens) if source == "goldens"
             else list(_fuzz(2, 60)))
    for probs, il, bw, tp in cases:
        for merge in (True, False):
            got = native.ctc_beam_decode_tf(probs, il, bw, tp, merge)
            want = jax_native.ctc_beam_decode_tf(probs, il, bw, tp, merge)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            dec, sc = texact.ctc_beam_search_decode_exact(
                probs, il, beam_width=bw, top_paths=tp, merge_repeated=merge)
            wdec, wsc = jexact.ctc_beam_search_decode_exact(
                probs, il, beam_width=bw, top_paths=tp, merge_repeated=merge)
            np.testing.assert_array_equal(sc, wsc)
            for g, w in zip(dec, wdec):
                np.testing.assert_array_equal(g, w)
            logits = np.log(probs + texact.KERAS_EPSILON)
            for b in range(probs.shape[0]):
                paths, _ = texact._decode_one(logits[b], int(il[b]), bw, tp,
                                              merge)
                assert [list(got[0][b, p, :got[1][b, p]])
                        for p in range(tp)] == paths


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setitem(native.SOURCES, "ctc_beam_tf", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ failed for .*broken.cc.*error:"):
        native.ctc_beam_decode_tf(np.full((1, 2, 3), 1 / 3, np.float32),
                                  np.array([2]))


def test_device_beam_degenerate_tie_scope_contract():
    """``tests/test_ctc_decode.py::test_device_beam_degenerate_tie_scope_
    contract`` for the port, held against the port's own oracle:
    resolvable near-uniform inputs (1e-2 jitter) decode identically;
    degenerate ones (1e-6 jitter, ties below f32 resolution) may pick
    another of the tied labels, but >= 90 % of samples end with
    oracle-equal top-1 scores and none diverges grossly."""
    rng = np.random.default_rng(41)
    B, T, C, bw = 48, 10, 8, 6
    il = rng.integers(4, T + 1, (B,)).astype(np.int32)

    def run(jitter):
        probs = (1.0 + jitter * rng.random((B, T, C))).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        dec_h, logp_h = texact.ctc_beam_search_decode_exact(
            probs, il, beam_width=bw)
        dec_d, logp_d = ctc_beam_search_decode_tf(
            torch.from_numpy(probs), torch.from_numpy(il), beam_width=bw)
        width = dec_h[0].shape[1]
        return (dec_h[0], logp_h, dec_d[0].numpy(), logp_d.numpy(), width)

    dec_h, logp_h, dec_d, logp_d, width = run(1e-2)
    np.testing.assert_array_equal(dec_d[:, :width], dec_h)
    assert (dec_d[:, width:] == -1).all()
    np.testing.assert_allclose(logp_d, logp_h, rtol=5e-4, atol=5e-4)

    _, logp_h, _, logp_d, _ = run(1e-6)
    d_score = np.abs(logp_d[:, 0] - logp_h[:, 0])
    assert float(np.mean(d_score <= 2e-3)) >= 0.9
    assert float(d_score.max()) < 1.0
