"""Port parity: crnn_ocr_torch.models.CRNN against crnn_ocr_tpu's CRNN.

Equal weights (the Keras parity goldens' .h5, imported by the JAX package
and carried over by ``params_from_jax``; against the tf_keras outputs, by
the port's own import) and equal inputs go through both forward passes. Softmax outputs are held to rtol 1e-4 / atol 2e-5, the
tolerance ``tests/test_keras_parity.py`` holds the JAX package to against
tf_keras; both are f32 on both sides. The bf16 case compares decoded text,
since bf16 rounds at other places in the two frameworks.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer import weights as tw
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.models import CRNN as TorchCRNN
from crnn_ocr_torch.ops import ctc as tctc
from crnn_ocr_tpu.infer.h5_import import import_keras_h5
from crnn_ocr_tpu.models import CRNN, ModelConfig

GOLDENS = pathlib.Path(__file__).parent / "goldens"
# the GRU and LSTM cases of tests/test_keras_parity.py
CASES = {
    "small_gru": dict(
        num_classes=12, width=64, stem_filters=8,
        block_filters=(16, 16, 24, 24), time_dense_size=16,
        n_units=12, rnn_layers=1, rnn_cell="gru", dropout_rate=0.0,
    ),
    "small_lstm": dict(
        num_classes=9, width=64, stem_filters=8,
        block_filters=(12, 16, 16, 24), time_dense_size=12,
        n_units=8, rnn_layers=2, rnn_cell="lstm", dropout_rate=0.0,
    ),
    "mid_gru": dict(
        num_classes=40, width=128, stem_filters=16,
        block_filters=(32, 48, 48, 64), time_dense_size=32,
        n_units=48, rnn_layers=2, rnn_cell="gru", dropout_rate=0.0,
    ),
}


def _both(name, dtype="float32", port_import=False):
    """The JAX config and variables, and the port's model in eval mode, with
    the golden's weights read by the JAX package's ``.h5`` import (or, with
    ``port_import``, by the port's own)."""
    kw = dict(CASES[name], dtype=dtype)
    jcfg = ModelConfig(**kw)
    h5 = str(GOLDENS / f"keras_{name}_weights.h5")
    params, stats = (tw.import_keras_h5(h5, TorchConfig(**kw)) if port_import
                     else import_keras_h5(h5, jcfg))
    model = TorchCRNN(TorchConfig(**kw))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats)))
    model.eval()
    return jcfg, {"params": params, "batch_stats": stats}, model


def _torch_probs(model, x):
    with torch.inference_mode():
        logits = model(torch.from_numpy(x[..., 0]))
    assert logits.dtype == torch.float32
    return torch.softmax(logits, -1).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_crnn_matches_jax_apply(name):
    jcfg, variables, model = _both(name)
    x = np.load(GOLDENS / f"keras_{name}_io.npz")["x"]
    want = np.asarray(jax.nn.softmax(
        CRNN(cfg=jcfg).apply(variables, x, train=False), axis=-1))
    np.testing.assert_allclose(_torch_probs(model, x), want, rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_crnn_matches_keras_goldens(name):
    _, _, model = _both(name, port_import=True)
    data = np.load(GOLDENS / f"keras_{name}_io.npz")
    np.testing.assert_allclose(_torch_probs(model, data["x"]), data["y"],
                               rtol=1e-4, atol=2e-5)


def test_crnn_bf16_decodes_like_jax():
    """bf16 on both sides, through the JAX package's Pallas kernels in
    interpret mode (the semantics the port's kernels copy); mid_gru's
    weights at n_units 128 are not available, so the bf16 model is the
    mid_gru trunk with the JAX package's own random init at H = 128."""
    kw = dict(CASES["mid_gru"], n_units=128, dtype="bfloat16")
    jcfg = ModelConfig(**kw, use_pallas_rnn=True, use_fused_stem=True)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 32, 128, 1)).astype(np.float32)
    jmodel = CRNN(cfg=jcfg, pallas_interpret=True)
    variables = jmodel.init(
        {"params": jax.random.key(2), "dropout": jax.random.key(3)},
        jnp.asarray(x), train=False)
    # non-trivial BatchNorm statistics, so the folding is exercised
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, a.shape)
        .astype(np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    want = np.array(jax.nn.softmax(
        jmodel.apply(variables, x, train=False), -1))
    model = TorchCRNN(TorchConfig(**kw))
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), stats))
    got = _torch_probs(model.eval(), x)
    T = got.shape[1]
    in_len = torch.full((8,), T - 2)
    dec_got, _ = tctc.ctc_greedy_decode(torch.from_numpy(got[:, 2:]), in_len)
    dec_want, _ = tctc.ctc_greedy_decode(torch.from_numpy(want[:, 2:]), in_len)
    assert tctc.trim_dense(dec_got) == tctc.trim_dense(dec_want)
    # bf16 noise on probabilities, not a different function
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


@pytest.mark.parametrize("use_stn", [False, True])
def test_lstm_crnn_builds_with_the_jax_shapes(use_stn):
    """An LSTM CRNN, with and without the STN front end, builds with the
    JAX package's parameter shapes (kernel (2, F, 4H), recurrent kernel
    (2, H, 4H), one bias (2, 4H) per layer) and runs on the CPU."""
    kw = dict(CASES["small_lstm"], use_stn=use_stn)
    model = TorchCRNN(TorchConfig(**kw))
    assert (model.stn is not None) == use_stn
    x = np.zeros((2, 32, 64, 1), np.float32)
    jv = CRNN(cfg=ModelConfig(**kw)).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
        train=False)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jv["params"]),
                         jax.tree_util.tree_map(np.asarray,
                                                jv["batch_stats"]))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    H, F = kw["n_units"], kw["time_dense_size"]
    assert got["birnn0.kernel"] == (2, F, 4 * H)
    assert got["birnn1.recurrent_kernel"] == (2, H, 4 * H)
    assert got["birnn1.bias"] == (2, 4 * H)
    model.load_state_dict(sd)
    with torch.inference_mode():
        logits = model.eval()(torch.from_numpy(x[..., 0]))
    assert logits.shape == (2, 16, kw["num_classes"] + 1)
    assert bool(torch.isfinite(logits).all())
