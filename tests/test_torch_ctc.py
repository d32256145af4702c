"""Port parity: crnn_ocr_torch.ops.ctc greedy decoding.

Decoded labels must equal the tf_keras goldens and the JAX package bit for
bit. Scores (``neg_sum_logits``) are held to the goldens as the JAX test
holds them (rtol/atol 1e-4), and to JAX at rtol 1e-6: the same f32 log and
max per frame, summed over at most T frames in another order.
"""

import numpy as np
import pytest
import torch

from crnn_ocr_torch.ops import ctc as tctc
from crnn_ocr_tpu.ops import ctc as jctc

N_GOLDEN_CASES = 8  # tests/goldens/ctc_greedy.npz holds g0..g7


def _trim_cols(d):
    d = np.asarray(d)
    keep = (d != -1).any(axis=0)
    return d[:, keep] if keep.any() else d[:, :0]


@pytest.mark.parametrize("i", range(N_GOLDEN_CASES))
def test_greedy_matches_keras_goldens(goldens, i):
    data = goldens("ctc_greedy.npz")
    assert int(data["n_cases"]) == N_GOLDEN_CASES
    dec, logp = tctc.ctc_greedy_decode(
        torch.from_numpy(data[f"g{i}_probs"]),
        torch.from_numpy(data[f"g{i}_input_len"]))
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(_trim_cols(dec.numpy()),
                                  _trim_cols(data[f"g{i}_decoded"]))
    np.testing.assert_allclose(logp.numpy(), data[f"g{i}_logp"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("merge_repeated", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_matches_jax(seed, merge_repeated):
    rng = np.random.default_rng(seed)
    B, T, C = 6, 30, 7
    # peaky posteriors with repeats, blanks and exact ties between classes
    logits = rng.normal(size=(B, T, C)).astype(np.float32) * 3
    logits[:, ::5, 1] = logits[:, ::5, 2]
    probs = np.exp(logits)
    probs /= probs.sum(-1, keepdims=True)
    probs[0, 3:6] = probs[0, 2]  # a run of equal frames
    in_len = rng.integers(1, T + 1, size=B).astype(np.int32)
    want_d, want_s = jctc.ctc_greedy_decode(probs, in_len,
                                            merge_repeated=merge_repeated)
    got_d, got_s = tctc.ctc_greedy_decode(torch.from_numpy(probs),
                                          torch.from_numpy(in_len),
                                          merge_repeated=merge_repeated)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    assert tctc.trim_dense(got_d) == jctc.trim_dense(want_d)


def test_greedy_hand_case():
    """Collapse repeats then drop blanks (blank = C-1); input_length cuts."""
    probs = np.full((2, 6, 3), 0.1, np.float32)
    for t, c in enumerate([0, 0, 2, 1, 1, 2]):
        probs[:, t, c] = 0.8
    dec, _ = tctc.ctc_greedy_decode(torch.from_numpy(probs),
                                    torch.tensor([6, 2]))
    assert tctc.trim_dense(dec) == [[0, 1], [0]]
