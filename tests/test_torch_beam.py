"""Port parity: the device beam search (``crnn_ocr_torch/ops/
ctc_beam_device.py``) and the decode entry points against the JAX package's,
on the CPU.

Labels must be equal; scores are held to rtol 1e-5 (atol 1e-6: a score is
a sum of up to T log-probabilities, and XLA's and PyTorch's ``log`` and
``exp`` differ by ulps). The fuzz draws come from
``tools/fuzz_beam_oracle.py``'s distributions (B, T, C, W, top_paths,
uniform or peaked posteriors), grouped by (C, W, top_paths) and stacked
along the batch (samples decode independently; frames past a sample's
length are frozen), so each group is one JAX compile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.infer.predictor import decode_predict_ctc
from crnn_ocr_torch.ops import ctc as tctc
from crnn_ocr_torch.ops import ctc_beam_device as tdev
from crnn_ocr_torch.ops.ctc_beam_exact import _decode_one
from crnn_ocr_tpu.data.codec import LabelCodec as JaxCodec
from crnn_ocr_tpu.infer.predictor import decode_predict_ctc as jax_dpc
from crnn_ocr_tpu.ops import ctc as jctc
from crnn_ocr_tpu.ops import ctc_beam_device as jdev

RTOL, ATOL = 1e-5, 1e-6


def _port(probs, il, **kw):
    dec, sc = tdev.ctc_beam_search_decode_tf(
        torch.from_numpy(probs), torch.from_numpy(np.asarray(il)), **kw)
    return dec.numpy(), sc.numpy()


def _jax(probs, il, **kw):
    dec, sc = jdev.ctc_beam_search_decode_tf(jnp.asarray(probs),
                                             jnp.asarray(il), **kw)
    return np.asarray(dec), np.asarray(sc)


def _assert_same(got, want):
    (gd, gs), (wd, ws) = got, want
    np.testing.assert_array_equal(gd, wd)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gs[~fin], ws[~fin])
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def beam_cases(goldens):
    return goldens("ctc_beam.npz")


@pytest.mark.parametrize("i", range(10))
def test_device_beam_matches_jax_on_goldens(beam_cases, i):
    d = beam_cases
    probs, il = d[f"b{i}_probs"], d[f"b{i}_input_len"]
    kw = dict(beam_width=int(d[f"b{i}_beam_width"]),
              top_paths=int(d[f"b{i}_top_paths"]))
    _assert_same(_port(probs, il, **kw), _jax(probs, il, **kw))


# (C, W, top_paths, merge_repeated): 6 groups of 10 configs
FUZZ_GROUPS = [(5, 3, 1, True), (8, 10, 3, False), (12, 1, 1, True),
               (17, 6, 2, True), (29, 10, 1, False), (29, 4, 4, True)]
FUZZ_T = 24


def _fuzz_batch(seed: int, C: int, n: int = 10):
    """``n`` configs of ``tools/fuzz_beam_oracle.py``'s draws at ``C``
    classes: B in [1, 3], T in [2, 23], uniform or peaked (exp(k * u), k in
    [1, 7]), lengths in [1, T]; each padded to ``FUZZ_T`` frames past its
    lengths and stacked."""
    rng = np.random.default_rng(seed)
    probs, il = [], []
    for _ in range(n):
        B, T = int(rng.integers(1, 4)), int(rng.integers(2, FUZZ_T))
        p = rng.random((B, FUZZ_T, C)).astype(np.float32)
        if rng.random() < 0.5:
            p = np.exp(rng.uniform(1, 7) * p)
        probs.append((p / p.sum(-1, keepdims=True)).astype(np.float32))
        il.append(rng.integers(1, T + 1, (B,)))
    return np.concatenate(probs), np.concatenate(il).astype(np.int32)


@pytest.mark.parametrize("group", range(len(FUZZ_GROUPS)))
def test_device_beam_matches_jax_on_fuzz(group):
    C, W, tp, merge = FUZZ_GROUPS[group]
    probs, il = _fuzz_batch(100 + group, C)
    kw = dict(beam_width=W, top_paths=tp, merge_repeated=merge)
    _assert_same(_port(probs, il, **kw), _jax(probs, il, **kw))


def test_freeze_past_input_length_and_collapsed_beam():
    """Frames past a sample's length change nothing (the decode equals the
    one of the cut input); a beam with fewer leaves than ``top_paths``
    pads with empty paths scored -inf, as JAX and the oracle."""
    rng = np.random.default_rng(5)
    B, T, C = 4, 9, 2  # one label: length-1 inputs have two leaves
    probs = rng.random((B, T, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    il = np.array([1, 3, 9, 1], np.int32)
    kw = dict(beam_width=5, top_paths=4)
    got = _port(probs, il, **kw)
    _assert_same(got, _jax(probs, il, **kw))
    assert np.isneginf(got[1][0, 2:]).all() and (got[0][2:, 0] == -1).all()
    cut = _port(np.ascontiguousarray(probs[:, :3]), np.minimum(il, 3), **kw)
    for b in (0, 1, 3):
        np.testing.assert_array_equal(got[1][b], cut[1][b])
        for p in range(4):
            np.testing.assert_array_equal(got[0][p, b, :3], cut[0][p, b])
    assert _paths(got[0]) == _oracle_paths(probs, il, 5, 4)


def _oracle_paths(probs, il, W, tp, merge=True):
    lg = np.log(probs + 1e-7)
    return [_decode_one(lg[b], int(il[b]), W, tp, merge)[0]
            for b in range(probs.shape[0])]


def _paths(dec):
    return [[[int(v) for v in dec[p, b] if v != -1]
             for p in range(dec.shape[0])] for b in range(dec.shape[1])]


def test_exact_ties_match_jax_and_oracle():
    """Exact value ties, fed on purpose. Quantized logits tie labels within
    a frame (the best path held to JAX and the oracle, as the JAX package's
    own test holds it: its runners-up can tie through sums that round
    differently where XLA's and PyTorch's ``log`` differ by an ulp). Frames
    with three equal labels tie whole paths by symmetry, bit for bit in
    every implementation: all five paths, in the stable sorts' order."""
    rng = np.random.default_rng(29)
    B, T, C, W = 8, 12, 30, 10
    logits = np.round(rng.normal(size=(B, T, C)).astype(np.float32) * 2) / 2
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    il = rng.integers(2, T + 1, (B,)).astype(np.int32)
    got = _port(probs, il, beam_width=W)
    _assert_same(got, _jax(probs, il, beam_width=W))
    assert [p[:1] for p in _paths(got[0])] == _oracle_paths(probs, il, W, 1)

    sym = np.tile(np.array([0.3, 0.3, 0.3, 0.1], np.float32), (2, 3, 1))
    il = np.array([3, 2], np.int32)
    for merge in (True, False):
        kw = dict(beam_width=5, top_paths=5, merge_repeated=merge)
        got = _port(sym, il, **kw)
        _assert_same(got, _jax(sym, il, **kw))
        assert _paths(got[0]) == _oracle_paths(sym, il, 5, 5, merge)
    assert _paths(got[0])[1][:3] == [[0], [1], [2]]  # ties label-ascending


def _checked_dispatch(monkeypatch, seen):
    """Wrap the tier ladder: on every frame, each sample that the cheap
    proof or the eviction bound admits must get the exact tier's answer
    from the fast path."""
    orig = tdev._tier_dispatch

    def dispatch(p, W, C):
        counts = tdev._evict_counts(p, W, C)
        slow_v, slow_i = tdev._slow_path(p, counts, W, C)
        fast_v, fast_i = p["topv1"][:, :W], p["topi1"][:, :W]
        same = (fast_v == slow_v).all(1) & (fast_i == slow_i).all(1)
        bound = tdev._bound_safe(p, counts, W, C)
        assert bool(same[p["cheap_s"]].all()), "cheap tier disagrees"
        assert bool(same[bound].all()), "bound tier disagrees"
        seen["cheap"] += int(p["cheap_s"].sum())
        seen["bound"] += int((bound & ~p["cheap_s"]).sum())
        seen["exact"] += int((~bound).sum())
        seen["exact_differs"] += int((~same).sum())
        return orig(p, W, C)

    monkeypatch.setattr(tdev, "_tier_dispatch", dispatch)


def test_each_tier_answers_as_the_exact_tier(monkeypatch):
    """Near-flat posteriors (the prefilter's saturation case) and peaked
    ones (where samples leave the cheap tier); every admitted sample's fast
    answer equals the exact gating's, and the decode still equals JAX's."""
    seen = dict(cheap=0, bound=0, exact=0, exact_differs=0)
    _checked_dispatch(monkeypatch, seen)
    rng = np.random.default_rng(23)
    B, T, C = 16, 10, 24
    flat = (1.0 + 0.05 * rng.random((B, T, C))).astype(np.float32)
    peaked = np.exp(6 * rng.random((B, T, C))).astype(np.float32)
    probs = np.concatenate([flat, peaked])
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    il = rng.integers(3, T + 1, (2 * B,)).astype(np.int32)
    for W in (4, 10):
        kw = dict(beam_width=W, top_paths=2)
        _assert_same(_port(probs, il, **kw), _jax(probs, il, **kw))
    assert seen["cheap"] and seen["bound"] and seen["exact"], seen
    assert seen["exact_differs"], seen  # the exact tier is not idle


def test_tier_stats_match_jax():
    rng = np.random.default_rng(0)
    B, T, C, W = 6, 8, 10, 4
    probs = np.exp(4 * rng.random((B, T, C))).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    il = rng.integers(3, T + 1, (B,)).astype(np.int32)
    got = tdev.ctc_beam_tier_stats(torch.from_numpy(probs),
                                   torch.from_numpy(il), beam_width=W)
    want = jdev.ctc_beam_tier_stats(probs, il, beam_width=W)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[0].all()) and not bool(got[1].all())  # all tiers


def test_merge_repeated_both_modes():
    """Peaked frames [a, blank, a]: the prefix is (a, a) in both modes; the
    TF-V1 merge collapses it on output, standard CTC keeps it; scores are
    the same."""
    frames = np.full((3, 4), 1e-3, np.float32)
    frames[0, 0] = frames[1, 3] = frames[2, 0] = 1.0
    probs = (frames / frames.sum(-1, keepdims=True))[None]
    il = np.array([3], np.int32)
    out = {}
    for merge in (True, False):
        out[merge] = _port(probs, il, beam_width=4, merge_repeated=merge)
        _assert_same(out[merge], _jax(probs, il, beam_width=4,
                                      merge_repeated=merge))
    assert list(out[False][0][0, 0, :2]) == [0, 0]
    assert list(out[True][0][0, 0, :2]) == [0, -1]
    np.testing.assert_array_equal(out[True][1], out[False][1])


def test_top_paths_guard():
    probs = torch.full((1, 4, 3), 1 / 3)
    il = torch.tensor([4])
    for fn in (tdev.ctc_beam_search_decode_tf, tctc.ctc_beam_search_decode):
        with pytest.raises(ValueError):
            fn(probs, il, beam_width=2, top_paths=3)
    with pytest.raises(ValueError):
        tctc.ctc_decode(probs, il, greedy=False, beam_width=2, top_paths=3)


def test_legacy_admissible_beam_matches_jax():
    rng = np.random.default_rng(11)
    B, T, C = 2, 12, 8
    probs = np.exp(3 * rng.random((B, T, C))).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    il = np.array([12, 7], np.int32)
    dec, sc = tctc.ctc_beam_search_decode(
        torch.from_numpy(probs), torch.from_numpy(il), beam_width=5,
        top_paths=3)
    wdec, wsc = jctc.ctc_beam_search_decode(probs, il, beam_width=5,
                                            top_paths=3)
    _assert_same((dec.numpy(), sc.numpy()), (np.asarray(wdec),
                                            np.asarray(wsc)))


def test_ctc_decode_and_decode_predict_ctc_match_jax():
    rng = np.random.default_rng(13)
    B, T, C = 5, 15, 7
    probs = np.exp(4 * rng.random((B, T, C))).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    il = rng.integers(1, T + 1, (B,)).astype(np.int32)
    tp_, tl = torch.from_numpy(probs), torch.from_numpy(il)
    for greedy in (True, False):
        got = tctc.ctc_decode(tp_, tl, greedy=greedy, beam_width=6,
                              top_paths=1 if greedy else 2,
                              merge_repeated=False)
        want = jctc.ctc_decode(probs, il, greedy=greedy, beam_width=6,
                               top_paths=1 if greedy else 2,
                               merge_repeated=False)
        assert len(got[0]) == len(want[0])
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=RTOL, atol=ATOL)
    from crnn_ocr_torch.data.codec import LabelCodec

    alphabet = "abcdef"
    for codec in (None, alphabet):
        got = decode_predict_ctc(
            probs, il, top_paths=2, beam_width=6, device="cpu",
            codec=codec and LabelCodec.from_alphabet(codec))
        want = jax_dpc(probs, il, top_paths=2, beam_width=6,
                       codec=codec and JaxCodec.from_alphabet(codec))
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    got = decode_predict_ctc(probs, device="cpu")  # every frame valid
    want = jax_dpc(probs)
    assert got[0] == want[0]


def test_beam_runs_on_the_probabilities_device_only():
    """The decode runs where its input lies, and the free entry point asks
    for CUDA unless the caller passes the CPU."""
    probs = torch.full((1, 4, 3), 1 / 3)
    dec, sc = tdev.ctc_beam_search_decode_tf(probs, torch.tensor([4]))
    assert dec.device.type == sc.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            decode_predict_ctc(probs.numpy())
