"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips on a machine without CUDA.
This file imports neither JAX nor ``crnn_ocr_tpu``, so it also runs where
JAX is not installed; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the stem in f32 to atol 1e-5 (f32 sums of 9 products in another
order) and in bf16 to one bf16 ulp of the output plus 1e-6 (values the
sums' order puts on either side of the ReLU); the BiGRU (K2, and K3's hs and
gates) in f32 to 1e-5 over 6 steps and in bf16 to 2^-7, two ulps of outputs
in (-1, 1); the CTC recursions (K6, K7) to 1e-4 + 1e-5 * |value| where a
path exists (f32 log-sum-exps with CUDA's expf/logf, over up to 61
dependent frames) and exactly NEG where none does; the CTC gradient to
rtol 1e-4 / atol 1e-5, as the CPU tests hold it to JAX. TF32 is off.
"""

import os

import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_torch.kernels import ctc_loss as tcl
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H", [(8, 128), (13, 256), (128, 256), (3, 1024),
                                 (4, 40)])  # bf16 pads 40 units to 48
def test_bigru_train_kernel_matches_plain(card, dtype, B, H):
    """K3: hs and the gate stash, against bigru_train_plain."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    xw = torch.from_numpy(rng.normal(size=(6, 2, B, 3 * H))
                          .astype(np.float32)).to(dt)
    u = torch.from_numpy((rng.normal(size=(2, H, 3 * H)) / np.sqrt(H))
                         .astype(np.float32)).to(dt)
    b = torch.from_numpy((rng.normal(size=(2, 3 * H)) * 0.1)
                         .astype(np.float32))
    n2, n3 = tbg.launches, tbg.train_launches
    hs, gates = tbg.bigru_train(xw.to(card), u.to(card), b.to(card))
    torch.cuda.synchronize()
    assert (tbg.launches, tbg.train_launches) == (n2, n3 + 1)
    want_hs, want_g = tbg.bigru_train_plain(xw, u, b)
    atol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(hs.float().cpu().numpy(),
                               want_hs.float().numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(gates.cpu().numpy(), want_g.numpy(), rtol=0,
                               atol=atol)


def _ctc_case(seed, B, T, C, L):
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, T, C)).astype(np.float32)), -1)
    labels = torch.from_numpy(rng.integers(0, C - 1, (B, L)))
    il = torch.from_numpy(rng.integers(min(L, T - 1), T + 1, (B,))
                          .astype(np.int32))
    ll = torch.from_numpy(rng.integers(0, L + 1, (B,)).astype(np.int32))
    il[0], ll[0] = 2, L  # infeasible
    return lp, labels, il, ll


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,L", [(128, 12, 9, 4), (128, 62, 63, 32),
                                     (5, 30, 12, 511)])
def test_ctc_kernels_match_plain(card, B, T, C, L):
    """K6 and K7 against their plain versions (S = 2L + 1 up to 1023)."""
    emits, flags, lens, _, _ = tcl.prepare(*_ctc_case(8, B, T, C, L))
    na, nb = tcl.alpha_launches, tcl.beta_launches
    got = [tcl.ctc_alphas(emits.to(card), flags.to(card), lens.to(card)),
           tcl.ctc_betas(emits.to(card), flags.to(card), lens.to(card))]
    torch.cuda.synchronize()
    assert (tcl.alpha_launches, tcl.beta_launches) == (na + 1, nb + 1)
    want = [tcl.ctc_alphas_plain(emits, flags, lens),
            tcl.ctc_betas_plain(emits, flags, lens)]
    for g, w in zip(got, want):
        g = g.cpu()
        live = w > tcl.NEG / 2
        assert torch.equal(g[~live], w[~live])
        assert bool(((g[live] - w[live]).abs()
                     <= 1e-4 + 1e-5 * w[live].abs()).all())


@pytest.mark.cuda
def test_ctc_loss_gradient_on_card_matches_cpu(card):
    lp, labels, il, ll = _ctc_case(9, 64, 40, 20, 10)
    grads, losses = [], []
    for dev in ("cpu", card):
        x = lp.clone().to(dev).requires_grad_(True)
        loss = tcl.ctc_loss(x, labels.to(dev), il.to(dev), ll.to(dev))
        torch.clamp(loss, max=1e4).mean().backward()
        grads.append(x.grad.cpu())
        losses.append(loss.detach().cpu())
    np.testing.assert_allclose(losses[1].numpy(), losses[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=1e-4,
                               atol=1e-5)
    assert torch.all(grads[1][0] == 0)  # the infeasible line


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_birnn_on_card_uses_current_weights_after_a_step(card, dtype):
    """Regression: after optimizer.step() the card's K3 (training) and K2
    (eval) read the new recurrent weights, as the plain version does."""
    from crnn_ocr_torch.models.rnn import BiRNN

    dt = DTYPES[dtype]
    torch.manual_seed(0)
    rnn = BiRNN(16, 48, dtype=dt).to(card)
    with torch.no_grad():
        for p in rnn.parameters():
            p.normal_(0.0, 0.2)
    opt = torch.optim.Adam(rnn.parameters(), lr=0.05)
    x = torch.randn(8, 7, 16, device=card)
    rnn(x).float().pow(2).sum().backward()
    opt.step()
    ref = BiRNN(16, 48, dtype=dt)  # the plain versions on the CPU
    ref.load_state_dict({k: v.cpu() for k, v in rnn.state_dict().items()})
    atol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    n3, n2 = tbg.train_launches, tbg.launches
    got = rnn(x)  # training mode, grad enabled: K3
    assert tbg.train_launches == n3 + 1
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               ref(x.cpu()).detach().float().numpy(), rtol=0,
                               atol=atol)
    rnn.eval()
    ref.eval()
    with torch.no_grad():
        got = rnn(x)  # K2 on the rebuilt cached operand
        want = ref(x.cpu())
    assert tbg.launches == n2 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=0, atol=atol)


@pytest.mark.cuda
def test_train_step_on_card_matches_plain_and_jax_golden(card):
    """One f32 fonts-hard train step through the kernels against the same
    step through the plain versions on the card and against the JAX
    package's step (``chip_smoke.py`` phase 7, with its tolerances)."""
    import chip_smoke

    chip_smoke.phase_train_parity(np.load(GOLDENS))
