"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips on a machine without CUDA.
This file imports neither JAX nor ``crnn_ocr_tpu``, so it also runs where
JAX is not installed; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the stem in f32 to atol 1e-5 (f32 sums of 9 products in another
order) and in bf16 to one bf16 ulp of the output plus 1e-6 (values the
sums' order puts on either side of the ReLU); the BiGRU (K2, and K3's hs and
gates) and the BiLSTM (K4, and K5's hs) in f32 to 1e-5 over 6 steps and in
bf16 to 2^-7, two ulps of outputs in (-1, 1), and K5's stash to the same
plus as much times its value in bf16 (c is not bounded by 1); the BiLSTM's
autograd Function on the card against the CPU to rtol 1e-4 / atol 1e-5 of
the largest gradient in f32 and 1e-2 in bf16 (h's bf16 roundings differ
between the two and reach every gradient); the CTC recursions (K6, K7), on
both designs, to 1e-4 + 1e-5 * |value| where a path exists (f32
log-sum-exps with the MUFU's ex2/lg2, or CUDA's expf/logf for "block",
over up to T dependent frames) and exactly NEG where none does; the CTC gradient to
rtol 1e-4 / atol 1e-5, as the CPU tests hold it to JAX; the bilinear
sampler (K11) and its dx, dy (K12) to 1e-6 + 1e-6 * |value| (the same f32
operations in the same order, each rounded on its own; K12's designs bit for
bit to each other), and K12's d_img to 1e-5 + 1e-5 * |value| (shared-memory
atomics add a pixel's terms in no fixed order); the training stem's sums (K8, K9, K10) to 1e-5 of the sum of their
terms' magnitudes plus 1e-6 (f32 sums of up to B * H * W terms in other
orders), and its autograd Function on the card against the CPU as
``tests/test_torch_stem_train.py`` holds the CPU to JAX; the beam search
(plain PyTorch, no kernel) on the card against the CPU: labels equal,
scores rtol 1e-5 / atol 1e-6 (f32 ``log``/``exp`` ulps), and greedy and
forced alignment to rtol 1e-6. TF32 is off.
"""

import collections
import os

import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_torch.kernels import ctc_loss as tcl
from crnn_ocr_torch.kernels import fused_stem as tfs
from crnn_ocr_torch.kernels import fused_stem_train as tfst
from crnn_ocr_torch.kernels import grid_sample as tgs

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


def _stem(rng, B, H, W, C, dtype, device, design=None):
    img = torch.from_numpy(rng.normal(size=(B, H, W, 1)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                         .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=C) * 0.2).astype(np.float32))
    args = [t.to(device) for t in (img.to(dtype), w, scale, bias)]
    if design is None:
        return tfs.fused_stem_serve(*args)
    return tfs._forward(*args, design)


# K1's shapes: C not a multiple of 8 (12), odd pooled widths (33, 5),
# fewer than 8 pooled rows (3), and three 64-channel chunks, the last of 2
# channels (130)
STEM_SHAPES = [(4, 32, 48, 8), (3, 32, 256, 64), (2, 32, 66, 12),
               (1, 6, 10, 64), (2, 32, 66, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_matches_plain(card, dtype, shape):
    """K1 on the design its dtype selects (bf16 ``"mma"``, f32
    ``"conv9"``) against the plain version."""
    dt = DTYPES[dtype]
    before, ran = tfs.launches, dict(tfs.design_launches)
    got = _stem(np.random.default_rng(3), *shape, dt, card)
    torch.cuda.synchronize()
    assert tfs.launches == before + 1
    design = "mma" if dt == torch.bfloat16 else "conv9"
    assert tfs.design_launches - collections.Counter(ran) == {design: 1}
    want = _stem(np.random.default_rng(3), *shape, dt, "cpu")  # plain
    got, want = got.float().cpu().numpy(), want.float().numpy()
    if dt == torch.bfloat16:
        assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-6).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_mma_design_within_one_ulp_of_conv9(card, shape):
    """K1's two designs on the same bf16 inputs: the tensor cores' z and
    conv9's differ only in the 9-term sum's rounding, so the outputs are
    within one bf16 ulp (plus 1e-6) of each other."""
    mma = _stem(np.random.default_rng(3), *shape, torch.bfloat16, card,
                "mma").float()
    conv9 = _stem(np.random.default_rng(3), *shape, torch.bfloat16, card,
                  "conv9").float()
    assert bool(((mma - conv9).abs() <= conv9.abs() * 2.0 ** -7 + 1e-6)
                .all()), float((mma - conv9).abs().max())


def _design_name(dtype, H):
    """The design the card tests expect: the resident one for K2-K5 up to
    256 units, in bf16 and in f32 (its 3xTF32 instance; the f32 LSTM past
    128 units on the 32-unit tile in clusters of up to 8); beyond, the
    streamed one in bf16 and U read from L2 by the CUDA cores in f32."""
    if H <= 256:
        return "resident"
    return "f32" if dtype == "float32" else "streamed"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H", [(8, 128), (13, 256), (5, 96), (3, 1024),
                                 (4, 40),  # pads 40 units to 48
                                 (256, 256),  # fonts-hard's serving batch
                                 (3, 128),
                                 (256, 128),  # fonts-small's serving batch
                                 (128, 128)])
def test_bigru_kernel_matches_plain(card, dtype, B, H):
    """K2 against bigru_plain, on the design its shape selects."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    xw = torch.from_numpy(rng.normal(size=(6, 2, B, 3 * H))
                          .astype(np.float32)).to(dt)
    u = torch.from_numpy((rng.normal(size=(2, H, 3 * H)) / np.sqrt(H))
                         .astype(np.float32)).to(dt)
    b = torch.from_numpy((rng.normal(size=(2, 3 * H)) * 0.1)
                         .astype(np.float32))
    design = tbg.design_for("gru", False, H, B, dt)
    assert design.name == _design_name(dtype, H)
    before, ran = tbg.launches, dict(tbg.design_launches)
    got = tbg.bigru(xw.to(card), u.to(card), b.to(card))
    torch.cuda.synchronize()
    assert tbg.launches == before + 1
    assert tbg.design_launches - collections.Counter(ran) == {design: 1}
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
                                 (4, 40),  # pads 40 units to 48
                                 (128, 128),  # fonts-small's training batch
                                 (256, 128), (5, 96)])
def test_bigru_train_kernel_matches_plain(card, dtype, B, H):
    """K3: hs and the gate stash, against bigru_train_plain, on the design
    its shape selects."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    xw = torch.from_numpy(rng.normal(size=(6, 2, B, 3 * H))
                          .astype(np.float32)).to(dt)
    u = torch.from_numpy((rng.normal(size=(2, H, 3 * H)) / np.sqrt(H))
                         .astype(np.float32)).to(dt)
    b = torch.from_numpy((rng.normal(size=(2, 3 * H)) * 0.1)
                         .astype(np.float32))
    design = tbg.design_for("gru", True, H, B, dt)
    assert design.name == _design_name(dtype, H)
    n2, n3 = tbg.launches, tbg.train_launches
    ran = dict(tbg.design_launches)
    hs, gates = tbg.bigru_train(xw.to(card), u.to(card), b.to(card))
    torch.cuda.synchronize()
    assert (tbg.launches, tbg.train_launches) == (n2, n3 + 1)
    assert tbg.design_launches - collections.Counter(ran) == {design: 1}
    want_hs, want_g = tbg.bigru_train_plain(xw, u, b)
    atol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(hs.float().cpu().numpy(),
                               want_hs.float().numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(gates.cpu().numpy(), want_g.numpy(), rtol=0,
                               atol=atol)


def _lstm_case(seed, B, H, dtype):
    rng = np.random.default_rng(seed)
    dt = DTYPES[dtype]
    xw = torch.from_numpy(rng.normal(size=(6, 2, B, 4 * H))
                          .astype(np.float32)).to(dt)
    u = torch.from_numpy((rng.normal(size=(2, H, 4 * H)) / np.sqrt(H))
                         .astype(np.float32)).to(dt)
    return xw, u, (2.0 ** -7 if dt == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H", [(8, 128), (13, 256), (256, 256), (3, 1024),
                                 (4, 40),  # pads 40 units to 48
                                 (128, 256), (5, 144)])
def test_bilstm_kernel_matches_plain(card, dtype, B, H):
    """K4 against bilstm_plain (fonts-hard-lstm's serving batch among the
    shapes), on the design its shape selects. In f32, 48 padded units take
    the 64-unit tile in one CTA (one of its four M-tiles idle), 128 two
    CTAs of 64; 144 takes the 32-unit tile in 6 CTAs of 24 (the second
    M-tile of each CTA a half one), 256 in 8 CTAs of 32."""
    xw, u, atol = _lstm_case(15, B, H, dtype)
    design = tbg.design_for("lstm", False, H, B, DTYPES[dtype])
    assert design.name == _design_name(dtype, H)
    n4, n5 = tbg.lstm_launches, tbg.lstm_train_launches
    ran = dict(tbg.design_launches)
    got = tbg.bilstm(xw.to(card), u.to(card))
    torch.cuda.synchronize()
    assert (tbg.lstm_launches, tbg.lstm_train_launches) == (n4 + 1, n5)
    assert tbg.design_launches - collections.Counter(ran) == {design: 1}
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               tbg.bilstm_plain(xw, u).float().numpy(),
                               rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H", [(8, 128), (13, 256),
                                 (128, 256),  # fonts-hard-lstm's training
                                 (3, 1024), (4, 40), (3, 128), (256, 256),
                                 (5, 144)])
def test_bilstm_train_kernel_matches_plain(card, dtype, B, H):
    """K5: hs and the stash [i | f | g | o | c], against
    bilstm_train_plain, on the design its shape selects."""
    xw, u, atol = _lstm_case(16, B, H, dtype)
    design = tbg.design_for("lstm", True, H, B, DTYPES[dtype])
    assert design.name == _design_name(dtype, H)
    n4, n5 = tbg.lstm_launches, tbg.lstm_train_launches
    ran = dict(tbg.design_launches)
    hs, st = tbg.bilstm_train(xw.to(card), u.to(card))
    torch.cuda.synchronize()
    assert (tbg.lstm_launches, tbg.lstm_train_launches) == (n4, n5 + 1)
    assert tbg.design_launches - collections.Counter(ran) == {design: 1}
    want_hs, want_st = tbg.bilstm_train_plain(xw, u)
    assert st.shape == want_st.shape and st.dtype == torch.float32
    np.testing.assert_allclose(hs.float().cpu().numpy(),
                               want_hs.float().numpy(), rtol=0, atol=atol)
    rtol = atol if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(st.cpu().numpy(), want_st.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_k3_and_k4_run_the_resident_design_equal_to_the_streamed(card):
    """K3 (the GRU with its stash) at fonts-hard's training shape and K4
    (the LSTM without one) at its serving shape launch the resident design
    that design_for names, K4's B 256 grid within one wave of the clusters
    the card holds; their hs, and K3's stash, equal the streamed design's
    bit for bit, and match their plain versions."""
    xw, u, atol = _lstm_case(19, 256, 256, "bfloat16")
    rng = np.random.default_rng(20)
    gxw = torch.from_numpy(rng.normal(size=(6, 2, 128, 768))
                           .astype(np.float32)).bfloat16()
    gu = torch.from_numpy((rng.normal(size=(2, 256, 768)) / 16.0)
                          .astype(np.float32)).bfloat16()
    gb = torch.from_numpy((rng.normal(size=(2, 768)) * 0.1)
                          .astype(np.float32))
    d4 = tbg.design_for("lstm", False, 256, 256, torch.bfloat16)
    d3 = tbg.design_for("gru", True, 256, 128, torch.bfloat16)
    assert d4.name == d3.name == "resident"
    from chip_smoke import resident_resources

    for cell, stash, B, d in (("lstm", False, 256, d4),
                              ("gru", True, 128, d3)):
        # the table never claims more CTAs than the card reports holding
        held = resident_resources(cell, stash, 256, d)["max_active_clusters"]
        wave = tbg.WAVE_CTAS[(torch.bfloat16, cell, stash, 256, d.rows)]
        assert -(-B // d.rows) * 2 * d.cluster <= wave <= held * d.cluster
    xw, u, gxw, gu, gb_c = (t.to(card) for t in (xw, u, gxw, gu, gb))
    before = dict(tbg.design_launches)
    hs4 = tbg.bilstm_infer(xw, u)
    hs3, g3 = tbg.bigru_train(gxw, gu, gb_c)
    torch.cuda.synchronize()
    assert (tbg.design_launches - collections.Counter(before)
            == collections.Counter({d4: 1, d3: 1}))
    streamed = tbg.Design("streamed", 0, 16)
    s4, _ = tbg._launch("lstm", xw, u, None, None, False, streamed)
    s3, sg3 = tbg._launch("gru", gxw, gu, gb_c, None, True, streamed)
    assert torch.equal(hs4, s4)
    assert torch.equal(hs3, s3) and torch.equal(g3, sg3)
    np.testing.assert_allclose(hs4.float().cpu().numpy(),
                               tbg.bilstm_plain(xw.cpu(), u.cpu()).float()
                               .numpy(), rtol=0, atol=atol)
    want_hs, want_g = tbg.bigru_train_plain(gxw.cpu(), gu.cpu(), gb)
    np.testing.assert_allclose(hs3.float().cpu().numpy(),
                               want_hs.float().numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(g3.cpu().numpy(), want_g.numpy(), rtol=0,
                               atol=atol)


@pytest.mark.cuda
def test_f32_lstm_runs_the_resident_design_within_the_card_capacity(card):
    """K5 f32 at fonts-hard-lstm's training shape (B 128, H 256) and K4 f32
    at its serving shape (B 256) launch the resident design that
    design_for names (clusters of 8 CTAs of 32 units); no WAVE_CTAS entry
    of the instance claims more CTAs than the card reports holding; K5's
    grid fits one wave (32 rows), and K4's fits none on any rows, so it
    takes 16."""
    from chip_smoke import resident_resources

    for stash, B in ((True, 128), (False, 256)):
        d = tbg.design_for("lstm", stash, 256, B, torch.float32)
        assert d.name == "resident" and d.cluster == 8
        fits = []
        for rows in tbg.resident_rows(torch.float32, "lstm"):
            held = resident_resources("lstm", stash, 256, d._replace(
                rows=rows), "float32")["max_active_clusters"]
            wave = tbg.WAVE_CTAS[(torch.float32, "lstm", stash, 256, rows)]
            assert wave <= held * d.cluster
            if -(-B // rows) * 2 * d.cluster <= wave:
                fits.append(rows)
        assert d.rows == (fits[0] if fits else 16)
        assert bool(fits) == stash
        xw, u, atol = _lstm_case(21, B, 256, "float32")
        before = dict(tbg.design_launches)
        out = (tbg.bilstm_train if stash else tbg.bilstm_infer)(
            xw.to(card), u.to(card))
        torch.cuda.synchronize()
        assert (tbg.design_launches - collections.Counter(before)
                == collections.Counter({d: 1}))
        want = (tbg.bilstm_train_plain if stash else tbg.bilstm_plain)(xw, u)
        for a, b in zip(out if stash else (out,), want if stash else (want,)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bilstm_autograd_on_card_matches_cpu(card, dtype):
    """The BiLSTM's autograd Function (K5 forward, the plain analytic
    backward) on the card against the CPU: hs and the gradients of xw and
    u; the card's K5 on the resident design in both dtypes."""
    xw, u, atol = _lstm_case(17, 16, 256, dtype)
    g = torch.from_numpy(np.random.default_rng(18).normal(
        size=(6, 2, 16, 256)).astype(np.float32))
    outs, grads = [], []
    for dev in ("cpu", card):
        ts = [t.clone().to(dev).requires_grad_(True) for t in (xw, u)]
        ran = dict(tbg.design_launches)
        hs = tbg.bilstm(*ts)
        new = tbg.design_launches - collections.Counter(ran)
        assert [d.name for d in new] == (["resident"] if dev != "cpu"
                                         else [])
        assert type(hs.grad_fn).__name__ == "_BiLSTMTrainBackward"
        (hs.float() * g.to(dev)).sum().backward()
        outs.append(hs.detach().float().cpu())
        grads.append([t.grad.float().cpu() for t in ts])
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=0,
                               atol=atol)
    tol = 1e-4 if dtype == "float32" else 1e-2
    for a, b in zip(grads[1], grads[0]):
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=tol,
            atol=(1e-5 if dtype == "float32" else tol) * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_birnn_lstm_on_card_uses_current_weights_after_a_step(card, dtype):
    """As the GRU's test: after optimizer.step() the card's K5 (training)
    and K4 (eval) read the new recurrent weights, as the plain version
    does."""
    from crnn_ocr_torch.models.rnn import BiRNN

    dt = DTYPES[dtype]
    torch.manual_seed(1)
    rnn = BiRNN(16, 48, cell="lstm", dtype=dt).to(card)
    with torch.no_grad():
        for p in rnn.parameters():
            p.normal_(0.0, 0.2)
    opt = torch.optim.Adam(rnn.parameters(), lr=0.05)
    x = torch.randn(8, 7, 16, device=card)
    rnn(x).float().pow(2).sum().backward()
    opt.step()
    ref = BiRNN(16, 48, cell="lstm", dtype=dt)  # the plain versions
    ref.load_state_dict({k: v.cpu() for k, v in rnn.state_dict().items()})
    atol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    n5, n4 = tbg.lstm_train_launches, tbg.lstm_launches
    got = rnn(x)  # training mode, grad enabled: K5
    assert tbg.lstm_train_launches == n5 + 1
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               ref(x.cpu()).detach().float().numpy(), rtol=0,
                               atol=atol)
    rnn.eval()
    ref.eval()
    with torch.no_grad():
        got = rnn(x)  # K4 on the rebuilt cached operand
        want = ref(x.cpu())
    assert tbg.lstm_launches == n4 + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=0, atol=atol)


@pytest.mark.cuda
def test_lstm_predictor_on_card_matches_golden_probs(card):
    """fonts-hard-lstm in f32 on the card: 1 K1 and 2 K4 launches, no K2,
    and the JAX predictor's probabilities on lstm_goldens.npz's lines
    (rtol 1e-4 / atol 2e-5)."""
    from crnn_ocr_torch import load_pretrained

    g = np.load(GOLDENS)
    gold = np.load(os.path.join(os.path.dirname(GOLDENS), "lstm_goldens.npz"))
    n = len(gold["lstm_probs_f32"])
    c, hs, ws = g["hard_canvas"], g["hard_heights"], g["hard_widths"]
    lines = [c[i, :h, :w] for i, (h, w) in enumerate(zip(hs[:n], ws[:n]))]
    pred = load_pretrained("fonts-hard-lstm", device=card, dtype="float32")
    counts = (tfs.launches, tbg.launches, tbg.lstm_launches)
    probs, _ = pred.predict_probs(lines, bucket=256)
    assert (tfs.launches, tbg.launches, tbg.lstm_launches) == (
        counts[0] + 1, counts[1], counts[2] + 2)
    np.testing.assert_allclose(probs.cpu().numpy(), gold["lstm_probs_f32"],
                               rtol=1e-4, atol=2e-5)


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


def _ctc_operands(seed, B, T, C, L):
    """K6's and K7's operands for ``_ctc_case``, with input lengths of 1
    and past T; for L = 0 (S = 1, which ``prepare`` does not take: its skip
    mask, like the JAX package's, is 2 wide there) the blank's emissions
    and the one state's flags (valid, init, end) directly."""
    lp, labels, il, ll = _ctc_case(seed, B, T, C, L)
    il[1 % B] = 1
    il[2 % B] = T + 3
    if L == 0:
        flags = torch.full((B, 1), tcl.VALID | tcl.INIT | tcl.END,
                           dtype=torch.int32)
        return lp[:, :, -1:].contiguous(), flags, il
    emits, flags, lens, _, _ = tcl.prepare(lp, labels, il, ll)
    return emits, flags, lens


# (B, T, C, L): the training shape (S 65); S 1023 at T 30 and T 126; S 1
# (empty labels); T 1; B not a multiple of anything (5, 129)
CTC_SHAPES = [(128, 12, 9, 4), (128, 62, 63, 32), (5, 30, 12, 511),
              (5, 126, 40, 511), (7, 20, 9, 0), (6, 1, 9, 3),
              (129, 17, 9, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["pipelined", "block"])
@pytest.mark.parametrize("B,T,C,L", CTC_SHAPES)
def test_ctc_kernels_match_plain(card, B, T, C, L, design):
    """K6 and K7 on both designs against their plain versions (S = 2L + 1
    up to 1023), input lengths of 1 and past T included, each launch
    counted on its design."""
    emits, flags, lens = _ctc_operands(8, B, T, C, L)
    na, nb = tcl.alpha_launches, tcl.beta_launches
    before = collections.Counter(tcl.design_launches)
    got = [tcl.ctc_alphas(emits.to(card), flags.to(card), lens.to(card),
                          design),
           tcl.ctc_betas(emits.to(card), flags.to(card), lens.to(card),
                         design)]
    torch.cuda.synchronize()
    assert (tcl.alpha_launches, tcl.beta_launches) == (na + 1, nb + 1)
    assert tcl.design_launches - before == {("alpha", design): 1,
                                            ("beta", design): 1}
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


def _sampler_case(seed, B, H, W, N, dtype):
    """An image, pixel coordinates that overshoot every border (the clamp)
    and an upstream gradient."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(size=(B, H, W)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-3, W + 2, (B, N)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-3, H + 2, (B, N)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    return img.to(DTYPES[dtype]), x, y, g


def _assert_near(got, want, tol):
    got, want = got.float().cpu(), want.float()
    err = (got - want).abs()
    assert bool((err <= tol + tol * want.abs()).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,W,N", [(256, 32, 256, 8192), (3, 16, 24, 384),
                                     (2, 5, 7, 1000), (1, 1, 1, 3),
                                     (3, 16, 24, 383), (2, 128, 512, 65536)])
def test_grid_sample_kernels_match_plain(card, dtype, B, H, W, N):
    """K11's samples and K12's d_img, dx and dy (on the path's design,
    ``"cluster"``) against the plain versions, on the image's own dtype
    (bf16 is read as f32 by both); N % 4 != 0, and 128 x 512 (past the
    first design's 58,112 pixels; in f32 the image is read through L1)."""
    img, x, y, g = _sampler_case(10, B, H, W, N, dtype)
    n11, n12 = tgs.launches, tgs.bwd_launches
    by_design = collections.Counter(tgs.design_launches)
    got = tgs.sample_pix(img.to(card), x.to(card), y.to(card))
    got_b = tgs.sample_pix_bwd(img.to(card), x.to(card), y.to(card),
                               g.to(card))
    torch.cuda.synchronize()
    assert (tgs.launches, tgs.bwd_launches) == (n11 + 1, n12 + 1)
    assert tgs.design_launches - by_design == {"cluster": 1}
    _assert_near(got, tgs.sample_pix_plain(img, x, y), 1e-6)
    want_b = tgs.sample_pix_bwd_plain(img, x, y, g)
    _assert_near(got_b[0], want_b[0], 1e-5)
    for a, b in zip(got_b[1:], want_b[1:]):
        _assert_near(a, b, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,W,N", [(128, 32, 256, 8192), (3, 16, 24, 384),
                                     (2, 5, 7, 1001), (1, 1, 1, 3)])
def test_grid_sample_bwd_designs_agree(card, dtype, B, H, W, N):
    """K12 on every cluster design and cluster size against the first
    design (``"image"``) on the same inputs: dx and dy bit for bit, d_img
    to 1e-5 + 1e-5 * |image| (atomics in another order), each within the
    plain version's tolerance; each launch counted under its design."""
    img, x, y, g = (t.to(card) for t in _sampler_case(11, B, H, W, N, dtype))
    first = tgs.sample_pix_bwd(img, x, y, g, "image")
    want = tgs.sample_pix_bwd_plain(img, x, y, g)
    for design in tgs.DESIGNS:
        for cluster in ((1,) if design == "image" else (1, 2, 4, 8)):
            by_design = collections.Counter(tgs.design_launches)
            got = tgs.sample_pix_bwd(img, x, y, g, design, cluster)
            torch.cuda.synchronize()
            assert tgs.design_launches - by_design == {design: 1}
            assert torch.equal(got[1], first[1]), (design, cluster)
            assert torch.equal(got[2], first[2]), (design, cluster)
            _assert_near(got[0], first[0].cpu(), 1e-5)
            _assert_near(got[0], want[0].cpu(), 1e-5)


@pytest.mark.cuda
def test_grid_sample_bwd_refuses_past_its_gate(card):
    """A shape past the gate raises on a CUDA tensor (no plain fallback):
    the first design past 58,112 pixels, the cluster past its slices."""
    img, x, y, g = (t.to(card) for t in _sampler_case(
        12, 1, 128, 512, 64, "float32"))
    n12 = tgs.bwd_launches
    with pytest.raises(ValueError, match="shared memory"):
        tgs.sample_pix_bwd(img, x, y, g, "image")
    wide = torch.zeros(1, 1, tgs.MAX_CLUSTER * (tgs.SMEM_MAX
                                                 - tgs.RING_BYTES) // 4 + 4,
                       device=card)
    with pytest.raises(ValueError, match="shared memory"):
        tgs.sample_pix_bwd(wide, x, y, g)
    assert tgs.bwd_launches == n12


@pytest.mark.cuda
def test_grid_sample_autograd_on_card_matches_cpu(card):
    """The warp of an STN, on the card (K11 forward, K12 backward) against
    the CPU (plain versions): samples and the gradients with respect to the
    image and to theta."""
    from crnn_ocr_torch.ops.grid_sample import grid_sample_affine

    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.normal(size=(4, 32, 256, 1)).astype(np.float32))
    theta = torch.from_numpy((rng.normal(size=(4, 6)) * 0.1
                              + [1, 0, 0, 0, 1, 0]).astype(np.float32))
    outs, grads = [], []
    for dev in ("cpu", card):
        i = img.clone().to(dev).requires_grad_(True)
        t = theta.clone().to(dev).requires_grad_(True)
        out = grid_sample_affine(i, t)
        torch.sin(out * 3.0).sum().backward()
        outs.append(out.detach().cpu())
        grads.append((i.grad.cpu(), t.grad.cpu()))
    _assert_near(outs[1], outs[0], 1e-6)
    _assert_near(grads[1][0], grads[0][0], 1e-5)
    np.testing.assert_allclose(grads[1][1].numpy(), grads[0][1].numpy(),
                               rtol=1e-4, atol=1e-4)


def _stem_train_case(seed, B, H, W, C, dtype, ties=False):
    """An image, weights and a pooled gradient in ``dtype``, and the
    per-channel vectors of K9 and K10 as the autograd Function derives
    them. With ``ties`` the image takes values k/8 and the weights j/16, so
    every z is exact in f32 whatever the sum order (and ties between a
    window's positions are exact in every pass), and the right quarter of
    each line is white (1.0), as a bucketed line is padded."""
    rng = np.random.default_rng(seed)
    dt = DTYPES[dtype]
    img = torch.from_numpy(rng.normal(size=(B, H, W, 1)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                         .astype(np.float32))
    if ties:
        img = torch.from_numpy(rng.integers(0, 9, size=(B, H, W, 1))
                               .astype(np.float32) / 8)
        img[:, :, W - W // 4:] = 1.0
        w = torch.from_numpy(rng.integers(-16, 17, size=(3, 3, 1, C))
                             .astype(np.float32) / 16)
    g = torch.from_numpy(rng.normal(size=(B, H // 2, W // 2, C))
                         .astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    beta = torch.from_numpy((rng.normal(size=C) * 0.3).astype(np.float32))
    img, g = img.to(dt), g.to(dt)
    n = float(B * H * W)
    st = tfst.stem_stats_plain(img, w)
    mean = st[0] / n
    var = st[1] / n - mean * mean
    vecs9 = (mean, *tfst.bwd_affine(gamma, beta, mean, var))
    p = tfst.stem_bwd_partials_plain(img, w, g, *vecs9)
    return img, w, g, vecs9, vecs9 + (vecs9[2], p[0] / n, p[1] / n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(128, 32, 128, 64), (4, 32, 48, 8),
                                   (3, 6, 10, 12), (2, 32, 66, 64),
                                   (1, 4, 4, 1000), (2, 10, 520, 20),
                                   (3, 6, 14, 18), (16, 32, 256, 64, "ties"),
                                   (5, 26, 262, 70, "ties")])
def test_stem_train_kernels_match_plain(card, dtype, shape):
    """K8, K9 and K10 against their plain versions: fonts-small's training
    shape, narrow and odd widths, 1000 channels (16 channel chunks of K9's
    and K10's tiles); pooled rows not a multiple of the tiles' 8 (H 10, 6,
    14, 26: 13 pooled rows in tiles of 8 and 5), pooled columns over the
    column cap of 128 (W 520 and 262: three and two column tiles), channels
    not a multiple of the 64-channel chunk (C 20, 70), of K8's 8 a product
    (C 12, 18, 20, 70) or of K9's and K10's 4 a thread (C 18); and exact
    ties with white padding (``_stem_train_case``'s ``ties``). A second
    run gives the same bits."""
    import chip_smoke

    ties = shape[-1] == "ties"
    img, w, g, v9, v10 = _stem_train_case(13, *shape[:4], dtype, ties)

    def on(*ts):
        return [t.to(card) for t in ts]

    before = (tfst.stats_launches, tfst.partials_launches,
              tfst.final_launches)
    got = [tfst.stem_stats(*on(img, w)),
           tfst.stem_bwd_partials(*on(img, w, g, *v9)),
           tfst.stem_bwd_final(*on(img, w, g, *v10))]
    torch.cuda.synchronize()
    assert (tfst.stats_launches, tfst.partials_launches,
            tfst.final_launches) == tuple(n + 1 for n in before)
    want = [tfst.stem_stats_plain(img, w),
            tfst.stem_bwd_partials_plain(img, w, g, *v9),
            tfst.stem_bwd_final_plain(img, w, g, *v10)]
    again = [tfst.stem_stats(*on(img, w)),
             tfst.stem_bwd_partials(*on(img, w, g, *v9)),
             tfst.stem_bwd_final(*on(img, w, g, *v10))]
    # no atomics: a second run gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # K9 and K10 read the weights through their strides: the model's HWIO
    # view of its OIHW weights gives the same bits as a contiguous copy
    w_view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    assert not w_view.is_contiguous()
    assert torch.equal(tfst.stem_bwd_partials(*on(img, w_view, g, *v9)),
                       got[1])
    assert torch.equal(tfst.stem_bwd_final(*on(img, w_view, g, *v10)), got[2])
    scales = chip_smoke.stem_train_scales(img, w, g, *v10)
    for a, b, sc in zip(got, want, scales):
        assert a.shape == b.shape and a.dtype == torch.float32
        err = (a.cpu() - b).abs()
        assert bool((err <= 1e-5 * sc + 1e-6).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_stem_train_on_card_matches_cpu(card, dtype):
    """The autograd Function (K8 + K1 forward, K9 + K10 backward) on the
    card against the plain versions on the CPU: pooled output, batch
    statistics and the gradients of the weights, gamma and beta; K1 on the
    ``"conv9"`` design in both dtypes."""
    rng = np.random.default_rng(14)
    dt = DTYPES[dtype]
    img = torch.from_numpy(rng.normal(size=(8, 32, 64, 1))
                           .astype(np.float32)).to(dt)
    leaves = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(3, 3, 1, 16)) * 0.4, rng.uniform(0.5, 1.5, 16),
        rng.normal(size=16) * 0.3)]
    u = torch.from_numpy(rng.normal(size=(8, 16, 32, 16)).astype(np.float32))
    outs, grads = [], []
    for dev in ("cpu", card):
        ps = [t.clone().to(dev).requires_grad_(True) for t in leaves]
        n1, n8 = tfs.launches, tfst.stats_launches
        n9, n10 = tfst.partials_launches, tfst.final_launches
        ran = dict(tfs.design_launches)
        p, m, v = tfst.fused_stem_train(img.to(dev), *ps)
        (torch.sin(p.float() * 1.7) * u.to(dev)).sum().backward()
        on_card = int(dev != "cpu")
        assert (tfs.launches, tfst.stats_launches, tfst.partials_launches,
                tfst.final_launches) == (n1 + on_card, n8 + on_card,
                                         n9 + on_card, n10 + on_card)
        # the training forward's K1 runs conv9, whose z K9 and K10 recompute
        assert tfs.design_launches - collections.Counter(ran) == (
            {"conv9": 1} if on_card else {})
        outs.append([t.detach().float().cpu() for t in (p, m, v)])
        grads.append([t.grad.cpu() for t in ps])
    (p0, m0, v0), (p1, m1, v1) = outs
    if dt == torch.bfloat16:
        assert bool(((p1 - p0).abs() <= p0.abs() * 2.0 ** -7 + 1e-6).all())
    else:
        np.testing.assert_allclose(p1.numpy(), p0.numpy(), rtol=0, atol=1e-5)
    for a, b in ((m1, m0), (v1, v0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    tol = 1e-4 if dt == torch.float32 else 1e-2
    for a, b in zip(grads[1], grads[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                   atol=tol * float(b.abs().max()))


def _beam_batch(kind: str, rng):
    B, T, C = 32, 40, 63
    if kind == "ties":  # quantized logits: exact ties across labels
        logits = np.round(rng.normal(size=(B, T, C)) * 2) / 2
    elif kind == "flat":  # near-uniform: the bound and exact tiers
        logits = np.log1p(0.05 * rng.random((B, T, C)))
    else:  # peaked, as a trained model's frames
        logits = 8 * rng.random((B, T, C))
    p = np.exp(logits - logits.max(-1, keepdims=True)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    return (torch.from_numpy(p.astype(np.float32)),
            torch.from_numpy(rng.integers(1, T + 1, (B,))))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["peaked", "flat", "ties"])
@pytest.mark.parametrize("merge", [True, False])
def test_beam_on_card_matches_cpu(card, kind, merge):
    """The TF-exact beam on CUDA against the same beam on the CPU: labels
    equal (CUDA's stable sorts break ties as the CPU's), scores within
    rtol 1e-5 (f32 log and exp differ by ulps between the two)."""
    from crnn_ocr_torch.ops.ctc_beam_device import ctc_beam_search_decode_tf

    probs, il = _beam_batch(kind, np.random.default_rng(15))
    out = [ctc_beam_search_decode_tf(probs.to(dev), il.to(dev), beam_width=10,
                                     top_paths=3, merge_repeated=merge)
           for dev in ("cpu", card)]
    assert out[1][0].device.type == torch.device(card).type
    np.testing.assert_array_equal(out[1][0].cpu().numpy(), out[0][0].numpy())
    np.testing.assert_allclose(out[1][1].cpu().numpy(), out[0][1].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_alignment_on_card_matches_cpu(card):
    from crnn_ocr_torch.ops import ctc as tctc

    probs, il = _beam_batch("peaked", np.random.default_rng(16))
    dec, _ = tctc.ctc_greedy_decode(probs, il)
    labels, ll = dec.clamp(min=0), (dec >= 0).sum(1)
    for fn, args in ((tctc.ctc_greedy_alignment, (probs, il)),
                     (tctc.ctc_forced_alignment, (probs, il, labels, ll))):
        want = fn(*args)
        got = fn(*(a.to(card) for a in args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-6,
                                       atol=0)


SERVE_GOLDENS = os.path.join(os.path.dirname(GOLDENS), "serve_goldens.npz")


def _post_npy(url: str, img) -> dict:
    import io
    import json
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, img)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return json.loads(r.read())


@pytest.mark.cuda
def test_daemon_f32_matches_serve_goldens(card):
    """``fonts-hard`` in f32 behind the HTTP daemon on the card, the 64
    golden lines posted from 16 threads at once (batches of mixed sizes and
    buckets, each line at its own bucket): each reply's text equals JAX's
    for its line on the canvas its batch gave it (``serve_goldens.npz``'s
    ``cond_*``, ``chip_smoke.canvas_variants``), scores within rtol 1e-4
    (atol 1e-5); ``predict_many`` equals JAX's ``predict_many``."""
    from concurrent.futures import ThreadPoolExecutor

    from chip_smoke import PaddingLog, variant_of
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.serve import OCRServer

    g, sg = np.load(GOLDENS), np.load(SERVE_GOLDENS)
    lines = [g["hard_canvas"][i, :h, :w] for i, (h, w) in
             enumerate(zip(g["hard_heights"], g["hard_widths"]))]
    pred = load_pretrained("fonts-hard", device=card, dtype="float32")
    assert [pred.bucket_for(im) for im in lines] == sg["bucket"].tolist()
    log = PaddingLog(pred)
    srv = OCRServer(pred, host="127.0.0.1", port=0, max_batch=32,
                    max_wait_ms=20).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/predict"
        with ThreadPoolExecutor(16) as ex:
            replies = list(ex.map(lambda im: _post_npy(url, im), lines))
    finally:
        srv.stop()
    ks = variant_of(sg, log, lines)
    assert [r["text"] for r in replies] == [
        str(t) for t in sg["cond_greedy_texts_f32"][ks]]
    np.testing.assert_allclose([r["score"] for r in replies],
                               sg["cond_greedy_scores_f32"][ks], rtol=1e-4,
                               atol=1e-5)
    many = pred.predict_many(lines, batch_size=64)
    assert [p.text for p in many] == [str(t) for t in sg["greedy_texts_f32"]]
    np.testing.assert_allclose([p.score for p in many],
                               sg["greedy_scores_f32"], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["autonamed", "autonamed_stn"])
def test_migration_forward_on_card(card, variant):
    """A reference artifact directory loaded by ``init_predictor`` on the
    card: the forward pass on ``io.npz``'s input equals Keras's output at
    rtol 1e-4 / atol 2e-5 (``tests/test_keras_parity.py:160``), through K1
    (``"conv9"``), K2 and, for the STN variant, K11."""
    from crnn_ocr_torch.infer import init_predictor

    mig = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                       f"migration_{variant}")
    data = np.load(os.path.join(mig, "io.npz"))
    pred = init_predictor(mig, device=card)
    assert pred.default_merge_repeated
    n1, n2, n11 = tfs.launches, tbg.launches, tgs.launches
    with torch.inference_mode():
        y = torch.softmax(pred.model(torch.from_numpy(data["x"][..., 0])
                                     .to(card)), -1)
    torch.cuda.synchronize()
    assert (tfs.launches - n1, tbg.launches - n2, tgs.launches - n11) == (
        1, 1, int(variant.endswith("stn")))
    np.testing.assert_allclose(y.cpu().numpy(), data["y"], rtol=1e-4,
                               atol=2e-5)


def _small_lstm_setup(device, seed=0):
    """A narrow BiLSTM CRNN (dropout 0.2) on ``device`` and a function of
    its synthetic batch stream (``skip`` batches in)."""
    from crnn_ocr_torch.config import ModelConfig
    from crnn_ocr_torch.data import pipeline
    from crnn_ocr_torch.data.synthetic import (
        SyntheticConfig,
        SyntheticTextlines,
    )
    from crnn_ocr_torch.train import create_train_state

    synth = SyntheticTextlines(SyntheticConfig(alphabet="0123456789",
                                               min_len=2, max_len=4))
    cfg = ModelConfig(num_classes=10, width=64, stem_filters=8,
                      block_filters=(8, 8, 12, 12), time_dense_size=16,
                      n_units=32, rnn_layers=1, rnn_cell="lstm",
                      dropout_rate=0.2)

    def state():
        return create_train_state(cfg, seed=seed, device=device,
                                  learning_rate=3e-3)

    def stream(skip=0):
        return pipeline.device_batches(pipeline.synthetic_batches(
            batch_size=16, bucket=64, seed=4, synth=synth, skip=skip),
            device, cfg, prefetch=0)

    return cfg, state, stream


def _state_tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for i, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer/{i}/{k}": v for k, v in slots.items()})
    return out


@pytest.mark.cuda
def test_checkpoint_from_card_restores_bitwise(card, tmp_path):
    """A checkpoint written on the card restores bit for bit into a state
    on the card and into one on the CPU: parameters, BatchNorm statistics,
    Adam's slots and step counts, and the step."""
    from crnn_ocr_torch.train import CheckpointManager, FitConfig, fit

    cfg, state, stream = _small_lstm_setup("cuda")
    s = fit(state(), cfg, stream(), cfg=FitConfig(steps=3, log_every=100))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(s.step, s)
    want = {k: v.cpu() for k, v in _state_tensors(s).items()}
    _, cpu_state, _ = _small_lstm_setup("cpu", seed=1)
    for fresh in (state(), cpu_state()):
        got = mgr.restore(fresh)
        assert got.step == 3
        tensors = _state_tensors(got)
        assert tensors.keys() == want.keys()
        for k, v in tensors.items():
            assert v.device.type == fresh.device.type or k.endswith("step")
            assert torch.equal(v.cpu(), want[k]), k


@pytest.mark.cuda
def test_resume_on_card_matches_straight(card, tmp_path):
    """2 steps, a checkpoint, a restore into a fresh state and 2 more
    against 4 straight, on the card with dropout 0.2 (each step's masks
    from the run's seed and the step): the parameters and slots at
    ``chip_smoke.py`` phase 27 (c)'s tolerance, rtol 2e-4 / atol 2e-5 (the
    card's convolution backward may sum in another order between runs)."""
    from crnn_ocr_torch.train import CheckpointManager, FitConfig, fit

    cfg, state, stream = _small_lstm_setup("cuda")
    straight = fit(state(), cfg, stream(), cfg=FitConfig(steps=4,
                                                         log_every=100))
    ck = str(tmp_path / "ck")
    fit(state(), cfg, stream(), cfg=FitConfig(steps=2, log_every=100,
                                              checkpoint_dir=ck))
    resumed = CheckpointManager(ck).restore(state())
    resumed = fit(resumed, cfg, stream(skip=2),
                  cfg=FitConfig(steps=4, log_every=100))
    assert resumed.step == straight.step == 4
    want, got = _state_tensors(straight), _state_tensors(resumed)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].float().cpu().numpy(),
                                   want[k].float().cpu().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
