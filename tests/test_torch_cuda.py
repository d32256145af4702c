"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips on a machine without CUDA.
This file imports neither JAX nor ``crnn_ocr_tpu``, so it also runs where
JAX is not installed; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the stem in f32 to atol 1e-5 (f32 sums of 9 products in another
order) and in bf16 to one bf16 ulp of the output plus 1e-6 (values the
sums' order puts on either side of the ReLU); the BiGRU in f32 to 1e-5 over
6 steps and in bf16 to 2^-7, two ulps of outputs in (-1, 1). TF32 is off.
"""

import os

import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_torch.kernels import fused_stem as tfs

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GOLDENS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "crnn_ocr_torch", "testdata",
    "greedy_goldens.npz")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (runs on the GPU machine)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stem(rng, B, H, W, C, dtype, device):
    img = torch.from_numpy(rng.normal(size=(B, H, W, 1)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                         .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=C) * 0.2).astype(np.float32))
    args = [t.to(device) for t in (img.to(dtype), w, scale, bias)]
    return tfs.fused_stem_serve(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 32, 48, 8), (3, 32, 256, 64),
                                   (2, 32, 66, 12), (1, 6, 10, 64)])
def test_stem_kernel_matches_plain(card, dtype, shape):
    dt = DTYPES[dtype]
    before = tfs.launches
    got = _stem(np.random.default_rng(3), *shape, dt, card)
    torch.cuda.synchronize()
    assert tfs.launches == before + 1
    want = _stem(np.random.default_rng(3), *shape, dt, "cpu")  # plain
    got, want = got.float().cpu().numpy(), want.float().numpy()
    if dt == torch.bfloat16:
        assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-6).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H", [(8, 128), (13, 256), (5, 96), (3, 1024),
                                 (4, 40)])  # bf16 pads 40 units to 48
def test_bigru_kernel_matches_plain(card, dtype, B, H):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    xw = torch.from_numpy(rng.normal(size=(6, 2, B, 3 * H))
                          .astype(np.float32)).to(dt)
    u = torch.from_numpy((rng.normal(size=(2, H, 3 * H)) / np.sqrt(H))
                         .astype(np.float32)).to(dt)
    b = torch.from_numpy((rng.normal(size=(2, 3 * H)) * 0.1)
                         .astype(np.float32))
    before = tbg.launches
    got = tbg.bigru(xw.to(card), u.to(card), b.to(card))
    torch.cuda.synchronize()
    assert tbg.launches == before + 1
    want = tbg.bigru_plain(xw, u, b)
    atol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name,key", [("fonts-small", "small"),
                                      ("fonts-hard", "hard")])
def test_predictor_on_card_reads_golden_texts(card, name, key):
    """f32 on the card: the JAX predictor's texts on the committed lines."""
    from crnn_ocr_torch import load_pretrained

    g = np.load(GOLDENS)
    c, hs, ws = g[f"{key}_canvas"], g[f"{key}_heights"], g[f"{key}_widths"]
    lines = [c[i, :h, :w] for i, (h, w) in enumerate(zip(hs, ws))]
    pred = load_pretrained(name, device=card, dtype="float32")
    n_stem, n_gru = tfs.launches, tbg.launches
    out = pred.predict(lines)
    assert tfs.launches == n_stem + 1 and tbg.launches == n_gru + 2
    assert [o.text for o in out] == [str(t) for t in g[f"{key}_texts_f32"]]
    np.testing.assert_allclose([o.score for o in out],
                               g[f"{key}_scores_f32"], rtol=1e-4, atol=1e-5)
