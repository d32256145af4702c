"""Port parity for the BiLSTM: the LSTM half of crnn_ocr_torch.kernels.bigru
(K4, K5 and the analytic backward), ``BiRNN(cell="lstm")``, its init, the
seeded recurrent layers and the ``fonts-hard-lstm`` variant.

On the CPU every wrapper runs its kernel's plain version (inside the same
autograd Function the card runs), held here to the JAX package's Pallas
kernels in interpret mode and to its ``lax.scan`` reference on the same
inputs. Tolerances:

* hs, f32: atol 1e-5 over 6 steps (f32 sums of 128 products in another
  order, carried through the recurrence); bf16: the output is bf16 of
  values in (-1, 1), where one ulp is at most 2^-8, so atol 2^-7 (two
  ulps), as ``tests/test_torch_kernels.py`` holds the BiGRU;
* the stash [i | f | g | o | c], f32: rtol 1e-4 / atol 1e-5; bf16: the
  same h rounding differences reach the f32 gates, 2^-7 + 2^-7 * |value|
  (c is not bounded by 1);
* gradients in ``xw`` and ``u``, f32: rtol 1e-4 / atol 1e-5 of the
  largest (f32 sums in another order through a reverse recurrence); bf16:
  the dtypes, and the values within rtol 0.1 / atol 0.05 of the JAX kernel
  path, as ``tests/test_torch_train.py`` holds the BiGRU's;
* whole models in f32: softmax outputs at rtol 1e-4 / atol 2e-5, the
  tolerance ``tests/test_keras_parity.py`` holds the JAX package to.

The CUDA kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer import pretrained as tpre
from crnn_ocr_torch.infer import weights as tw
from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_torch.models import CRNN as TorchCRNN
from crnn_ocr_torch.models.rnn import BiRNN
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_tpu.kernels.bigru import (_bilstm_scan_ref, bilstm_fused,
                                        bilstm_pallas_train)
from crnn_ocr_tpu.models import ModelConfig as JaxConfig
from crnn_ocr_tpu.models.rnn import BiRNN as JaxBiRNN

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "crnn_ocr_torch", "testdata")


def _lstm_inputs(seed, T=6, B=8, H=128):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, 2, B, 4 * H)).astype(np.float32),
            (rng.normal(size=(2, H, 4 * H)) / np.sqrt(H)).astype(np.float32))


def _counts():
    return (tbg.launches, tbg.train_launches, tbg.lstm_launches,
            tbg.lstm_train_launches)


@pytest.mark.parametrize("ref", ["pallas_interpret", "scan"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bilstm_plain_matches_jax(dtype, ref):
    """K4's plain version against ``bilstm_fused`` (the Pallas kernel in
    interpret mode) and ``_bilstm_scan_ref``, at H = 128, where JAX's
    Pallas gate ``bigru_supported`` is on."""
    tdt, jdt = DTYPES[dtype]
    xw, u = _lstm_inputs(1)
    jx, ju = jnp.asarray(xw).astype(jdt), jnp.asarray(u).astype(jdt)
    want = (bilstm_fused(jx, ju, True) if ref == "pallas_interpret"
            else _bilstm_scan_ref(jx, ju))
    before = _counts()
    got = tbg.bilstm(torch.from_numpy(xw).to(tdt),
                     torch.from_numpy(u).to(tdt))
    assert _counts() == before  # the CPU path launches no kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    atol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bilstm_train_stash_matches_pallas_train(dtype):
    """K5's plain version: hs and the stash [i | f | g | o | c] against
    ``bilstm_pallas_train`` in interpret mode."""
    tdt, jdt = DTYPES[dtype]
    xw, u = _lstm_inputs(2)
    want_hs, want_st = bilstm_pallas_train(jnp.asarray(xw).astype(jdt),
                                           jnp.asarray(u).astype(jdt),
                                           interpret=True)
    before = _counts()
    hs, st = tbg.bilstm_train(torch.from_numpy(xw).to(tdt),
                              torch.from_numpy(u).to(tdt))
    assert _counts() == before
    assert st.dtype == torch.float32 and st.shape == want_st.shape
    assert hs.dtype == tdt
    if dtype == "bfloat16":
        hs_tol, atol, rtol = 2.0 ** -7, 2.0 ** -7, 2.0 ** -7
    else:
        hs_tol, atol, rtol = 1e-5, 1e-5, 1e-4
    np.testing.assert_allclose(hs.float().numpy(),
                               np.asarray(want_hs, np.float32), rtol=0,
                               atol=hs_tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), rtol=rtol,
                               atol=atol)


def _grads_torch(xw, u, dtype):
    ts = [torch.from_numpy(xw).to(dtype).requires_grad_(True),
          torch.from_numpy(u).to(dtype).requires_grad_(True)]
    hs = tbg.bilstm(*ts)
    assert type(hs.grad_fn).__name__ == "_BiLSTMTrainBackward"
    torch.tanh(hs.float()).sum().backward()
    return [t.grad for t in ts]


def _grads_jax(xw, u, dtype):
    return jax.grad(
        lambda xw, u: jnp.sum(jnp.tanh(
            bilstm_fused(xw, u, True).astype(jnp.float32))),
        argnums=(0, 1),
    )(jnp.asarray(xw).astype(dtype), jnp.asarray(u).astype(dtype))


def test_bilstm_gradients_match_jax_f32():
    """The analytic backward (through the autograd Function) against
    ``jax.grad`` of ``bilstm_fused``'s custom VJP."""
    xw, u = _lstm_inputs(3, T=5)
    got = _grads_torch(xw, u, torch.float32)
    want = _grads_jax(xw, u, jnp.float32)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


def test_bilstm_bf16_gradients_dtypes_and_values():
    xw, u = _lstm_inputs(4, T=3)
    got = _grads_torch(xw, u, torch.bfloat16)
    want = _grads_jax(xw, u, jnp.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=0.1,
                                   atol=0.05)


def test_bilstm_without_grad_runs_inference_path():
    xw, u = _lstm_inputs(5)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (xw, u)]
    with torch.no_grad():
        hs = tbg.bilstm(*ts)
    assert hs.grad_fn is None
    np.testing.assert_array_equal(hs.numpy(),
                                  tbg.bilstm_plain(*ts).detach().numpy())


def test_padded_units_stay_zero():
    """The bf16 kernel runs H padded to a multiple of 16 with zero inputs
    and weights: a padded unit's i = f = o = 1/2 and g = 0 keep c and h at
    0, so the real units compute what they compute unpadded (checked in
    f32 through the plain version, which runs any width)."""
    H, hp = 40, 48
    xw, u = _lstm_inputs(6, H=H)
    xw, u = torch.from_numpy(xw), torch.from_numpy(u)
    up = torch.nn.functional.pad(tbg._pad_gates(u, H, hp), (0, 0, 0, hp - H))
    hs, st = tbg.bilstm_train_plain(tbg._pad_gates(xw, H, hp), up)
    want_hs, want_st = tbg.bilstm_train_plain(xw, u)
    assert torch.equal(hs[..., H:], torch.zeros_like(hs[..., H:]))
    torch.testing.assert_close(hs[..., :H], want_hs, rtol=1e-6, atol=1e-6)
    st = st.reshape(*st.shape[:-1], 5, hp)
    torch.testing.assert_close(st[..., :H].reshape(want_st.shape), want_st,
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(st[..., 4, H:], torch.zeros_like(st[..., 4, H:]))
    # the kernel operand: 4 gates of 48 units, transposed for the mma
    uk = tbg.kernel_weights(u.to(torch.bfloat16))
    assert tuple(uk.shape) == (2, 4 * hp, hp)
    assert torch.equal(uk, tbg.mma_operand(up.to(torch.bfloat16)))


def test_bilstm_wrappers_check_shapes_and_devices():
    with pytest.raises(ValueError, match="4H"):
        tbg.bilstm(torch.zeros(2, 2, 1, 6), torch.zeros(2, 2, 6))
    with pytest.raises(ValueError, match="u must be"):
        tbg.bilstm(torch.zeros(2, 2, 1, 8), torch.zeros(2, 2, 6))
    with pytest.raises(TypeError, match="dtype"):
        tbg.bilstm_train(torch.zeros(2, 2, 1, 8),
                         torch.zeros(2, 2, 8, dtype=torch.bfloat16))
    # no fallback: a tensor on a device without a kernel raises
    meta = torch.device("meta")
    for fn in (tbg.bilstm, tbg.bilstm_train):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(torch.zeros(2, 2, 1, 8, device=meta),
               torch.zeros(2, 2, 8, device=meta))


def test_birnn_lstm_matches_jax_birnn_f32():
    """``BiRNN(cell="lstm")`` against the JAX package's ``BiRNN`` on its
    Pallas path (interpret mode) at equal random weights: the outputs, and
    the gradients of the kernel, the recurrent kernel and the bias (whose
    gradient flows through the projection, as JAX's through its einsum)."""
    B, T, F, H = 8, 5, 16, 128
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    params = {"kernel": rng.normal(size=(2, F, 4 * H)) * 0.2,
              "recurrent_kernel": rng.normal(size=(2, H, 4 * H)) / np.sqrt(H),
              "bias": rng.normal(size=(2, 4 * H)) * 0.3}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jm = JaxBiRNN(units=H, cell="lstm", use_pallas=True,
                  pallas_interpret=True)

    def loss(p):
        return jnp.sum(jnp.tanh(jm.apply({"params": p}, x)) * 0.5)

    want = np.asarray(jm.apply({"params": params}, x))
    want_g = jax.grad(loss)(params)
    rnn = BiRNN(F, H, cell="lstm")
    rnn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    before = _counts()
    out = rnn(torch.from_numpy(x))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    (torch.tanh(out) * 0.5).sum().backward()
    for name, p in rnn.named_parameters():
        w = np.asarray(want_g[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_birnn_lstm_rebuilds_kernel_weights_on_load(dtype):
    """The LSTM's cached kernel operand: 4 gates, rebuilt on load, not
    saved; the bias is (2, 4H). In both dtypes the resident design's
    operand, 40 units padded to 48: (2, 4 x 48, 48)."""
    tdt = DTYPES[dtype][0]
    H = 40  # padded to 48
    rnn = BiRNN(8, H, cell="lstm", dtype=tdt)
    shapes = {k: tuple(v.shape) for k, v in rnn.state_dict().items()}
    assert shapes == {"kernel": (2, 8, 4 * H), "bias": (2, 4 * H),
                      "recurrent_kernel": (2, H, 4 * H)}
    sd = {k: torch.from_numpy(np.random.default_rng(5).normal(
        size=v).astype(np.float32)) for k, v in shapes.items()}
    rnn.load_state_dict(sd)
    assert torch.equal(rnn.u_kernel,
                       tbg.kernel_weights(sd["recurrent_kernel"].to(tdt)))
    assert tuple(rnn.u_kernel.shape) == (2, 4 * 48, 48)
    with pytest.raises(ValueError, match="rnn_cell"):
        BiRNN(8, H, cell="rnn")


def test_init_weights_gives_the_lstm_a_unit_forget_bias():
    cfg = TorchConfig(num_classes=9, width=64, stem_filters=8,
                      block_filters=(12, 16, 16, 24), time_dense_size=12,
                      n_units=8, rnn_layers=2, rnn_cell="lstm")
    model = TorchCRNN(cfg)
    tstate.init_weights(model, seed=3)
    H = cfg.n_units
    for i in range(cfg.rnn_layers):
        rnn = getattr(model, f"birnn{i}")
        want = torch.zeros(2, 4 * H)
        want[:, H:2 * H] = 1.0
        assert torch.equal(rnn.bias.detach(), want)
        assert float(rnn.kernel.detach().abs().max()) > 0
        # flax's orthogonal init over the (2H, 4H) rows: orthonormal rows
        u = rnn.recurrent_kernel.detach().reshape(2 * H, 4 * H)
        torch.testing.assert_close(u @ u.T, torch.eye(2 * H), atol=1e-5,
                                   rtol=0)


def test_seeded_rnn_params_are_reproducible():
    """Bit-identical on two calls, of the layout and init the LSTM takes,
    the bits ``lstm_goldens.npz`` was written from, and only for an LSTM."""
    cfg = tpre.model_weights("fonts-hard-lstm")[0]
    a, b = tw.seeded_rnn_params(cfg, 0), tw.seeded_rnn_params(cfg, 0)
    assert sorted(a) == ["birnn0", "birnn1"]
    H, G = 256, 1024
    for layer, feat in (("birnn0", 128), ("birnn1", 512)):
        for k, shape in (("kernel", (2, feat, G)),
                         ("recurrent_kernel", (2, H, G)), ("bias", (2, G))):
            assert a[layer][k].shape == shape and a[layer][k].dtype == \
                np.float32
            np.testing.assert_array_equal(a[layer][k], b[layer][k])
        assert np.all(a[layer]["bias"][:, H:2 * H] == 1.0)
        assert np.all(np.delete(a[layer]["bias"], np.s_[H:2 * H], 1) == 0.0)
        assert np.abs(a[layer]["recurrent_kernel"]).max() < 1 / np.sqrt(H)
    assert tw.rnn_params_digest(a) != tw.rnn_params_digest(
        tw.seeded_rnn_params(cfg, 1))
    gold = np.load(os.path.join(TESTDATA, "lstm_goldens.npz"))
    assert tw.rnn_params_digest(a) == str(gold["lstm_weights_sha256"])
    with pytest.raises(ValueError, match="BiLSTM"):
        tw.seeded_rnn_params(dataclasses.replace(cfg, rnn_cell="gru"))


def _golden_lines(n):
    g = np.load(os.path.join(TESTDATA, "greedy_goldens.npz"))
    c, hs, ws = g["hard_canvas"], g["hard_heights"], g["hard_widths"]
    return [c[i, :h, :w] for i, (h, w) in enumerate(zip(hs[:n], ws[:n]))]


def test_fonts_hard_lstm_matches_jax_f32():
    """``fonts-hard-lstm`` (fonts-hard with the seeded BiLSTM) on the CPU in
    f32, at bucket 256: its probabilities against the JAX predictor's with
    the same weights on 4 golden lines, and against ``lstm_goldens.npz``'s
    (the JAX predictor's, written by ``tools/gen_torch_goldens.py --lstm``)
    on 8, at rtol 1e-4 / atol 2e-5."""
    from crnn_ocr_tpu.infer.predictor import Predictor as JaxPredictor

    cfg, params, stats, codec = tpre.model_weights("fonts-hard-lstm",
                                                   "float32")
    assert cfg.rnn_cell == "lstm" and cfg.n_units == 256
    jcfg = JaxConfig(**dataclasses.asdict(cfg), use_pallas_rnn=False,
                     use_fused_stem=False)
    gold = np.load(os.path.join(TESTDATA, "lstm_goldens.npz"))
    lines = _golden_lines(len(gold["lstm_probs_f32"]))
    want, want_len = JaxPredictor(jcfg, params, stats, codec).predict_probs(
        lines[:4], bucket=256)
    pred = tpre.load_pretrained("fonts-hard-lstm", device="cpu",
                                dtype="float32")
    got, got_len = pred.predict_probs(lines, bucket=256)
    np.testing.assert_array_equal(got_len.numpy()[:4], np.asarray(want_len))
    for ref, n in ((np.asarray(want), 4), (gold["lstm_probs_f32"], 8)):
        np.testing.assert_allclose(got.numpy()[:n], ref, rtol=1e-4,
                                   atol=2e-5)


def test_import_keras_h5_reads_an_lstm():
    """The port's ``.h5`` import of the Keras LSTM golden equals the JAX
    package's, the biases stacked to (2, 4H)."""
    from crnn_ocr_tpu.infer.h5_import import import_keras_h5

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens", "keras_small_lstm_weights.h5")
    cfg = TorchConfig(num_classes=9, width=64, stem_filters=8,
                      block_filters=(12, 16, 16, 24), time_dense_size=12,
                      n_units=8, rnn_layers=2, rnn_cell="lstm")
    got_p, got_s = tw.import_keras_h5(path, cfg)
    want_p, want_s = import_keras_h5(path, cfg)
    assert got_p["birnn0"]["bias"].shape == (2, 32)
    for got, want in ((got_p, want_p), (got_s, want_s)):
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_g) == len(flat_w)
        for path_, leaf in flat_g:
            np.testing.assert_array_equal(leaf, np.asarray(flat_w[path_]))
