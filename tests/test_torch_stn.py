"""Port parity: the STN front end (crnn_ocr_torch.models.stn and the
``use_stn`` CRNN) against crnn_ocr_tpu's, on the CPU.

On the CPU the sampler runs K11's and K12's plain versions inside the
autograd Function the card runs; the JAX side runs its XLA sampler (its CPU
default) or, for the bf16 golden, its Pallas kernels in interpret mode.
Tolerances:

* the STN module with random non-zero weights: theta rtol 1e-5 / atol
  1e-6 (f32 convolutions and dense layers summed in other orders move it
  by an ulp or two), the warped image atol 2e-4 (those ulps move each
  sample's coordinates by ~1e-5 px, and a bilinear sample is continuous
  in them), and the warp at JAX's own theta bit for bit;
* a ``use_stn`` CRNN in eval, and the Keras golden: softmax outputs rtol
  1e-4 / atol 2e-5, as ``tests/test_keras_parity.py``;
* one f32 train step: every gradient leaf, STN leaves included, rtol 1e-4 /
  atol 1e-4 of the leaf's largest (as ``tests/test_torch_train.py``); loss
  and grad_norm rtol 2e-5, updated parameters rtol 2e-4 / atol 2e-5 except
  where a gradient element is at the f32 noise of its sum (there 2 * lr,
  see ``tests/test_torch_train.py``);
* the bundled STN models on the golden lines
  (``crnn_ocr_torch/testdata/stn_goldens.npz``): f32 texts equal and scores
  rtol 1e-4 / atol 1e-5; ``fonts-warp-stn`` as shipped (bf16) at most 1 of
  64 lines off the JAX bf16 golden.
"""

import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crnn_ocr_torch
from crnn_ocr_torch import load_pretrained
from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer import weights as tw
from crnn_ocr_torch.models import CRNN as TorchCRNN
from crnn_ocr_torch.models.stn import IDENTITY, STN as TorchSTN
from crnn_ocr_torch.ops.grid_sample import grid_sample_affine
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep
from crnn_ocr_tpu.data import pipeline as jpipe
from crnn_ocr_tpu.data.synthetic import SyntheticConfig as JSynthCfg
from crnn_ocr_tpu.data.synthetic import SyntheticTextlines as JSynth
from crnn_ocr_tpu.infer import load_pretrained as jax_load_pretrained
from crnn_ocr_tpu.models import CRNN, ModelConfig
from crnn_ocr_tpu.models.stn import STN
from crnn_ocr_tpu.ops import grid_sample as jops
from crnn_ocr_tpu.train import state as jstate
from crnn_ocr_tpu.train.step import ctc_loss_vec, make_train_step

GOLDENS = pathlib.Path(__file__).parent / "goldens"
STN_GOLDENS = os.path.join(os.path.dirname(crnn_ocr_torch.__file__),
                           "testdata", "stn_goldens.npz")
LR = 1e-4
ALPHABET = "0123456789"
# the STN case of tests/test_keras_parity.py
SMALL_STN = dict(num_classes=12, width=64, stem_filters=8,
                 block_filters=(16, 16, 24, 24), time_dense_size=16,
                 n_units=12, rnn_layers=1, rnn_cell="gru", dropout_rate=0.0,
                 use_stn=True)
NARROW = dict(num_classes=len(ALPHABET), width=64, stem_filters=16,
              block_filters=(16, 24, 32, 32), time_dense_size=32,
              n_units=128, rnn_layers=2, dropout_rate=0.0, use_stn=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(params, rng, scale=0.05):
    """Every STN leaf moved off its init (theta's kernel off zero), so that
    the localization net's layout reaches the warp."""
    out = _np_tree(params)
    stn = out["stn"]
    for layer in stn.values():
        for k, v in layer.items():
            layer[k] = (v + rng.normal(size=v.shape) * scale).astype(
                np.float32)
    stn["Dense_1"]["kernel"] *= 0.1
    return out


def test_stn_module_matches_jax_with_random_weights():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 32, 64, 1)).astype(np.float32)
    jstn = STN()
    params = _perturb({"stn": jstn.init(jax.random.key(1), x)["params"]},
                      rng, 0.1)["stn"]
    want, inter = jstn.apply({"params": params}, x,
                             capture_intermediates=True)
    want_theta = np.asarray(inter["intermediates"]["Dense_1"]["__call__"][0])
    m = TorchSTN(32, 64)
    sd = {}  # as infer/weights.py::params_from_jax maps params["stn"]
    for i in range(2):
        c = params[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = np.transpose(c["kernel"], (3, 2, 0, 1))
        sd[f"convs.{i}.bias"] = c["bias"]
    for key, name in (("Dense_0", "dense"), ("Dense_1", "theta")):
        sd[f"{name}.weight"] = params[key]["kernel"].T
        sd[f"{name}.bias"] = params[key]["bias"]
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()})
    xt = torch.from_numpy(x[..., 0])
    with torch.no_grad():
        theta = m.localize(xt)
        got = m(xt)
    # a far-from-identity warp, or the check would see little
    assert np.abs(want_theta - np.float32(IDENTITY)).max() > 0.05
    np.testing.assert_allclose(theta.numpy(), want_theta, rtol=1e-5,
                               atol=1e-6)
    # theta's ulps move a coordinate by ~1e-5 px, and a sample by that
    # times the image's slope (up to ~5 on N(0, 1) pixels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               rtol=0, atol=2e-4)
    # at JAX's own theta, the warp is JAX's to the bit
    warped = grid_sample_affine(torch.from_numpy(x),
                                torch.from_numpy(want_theta.copy()))
    np.testing.assert_array_equal(warped.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="built for 32x64"):
        m(torch.zeros(1, 32, 128))


def test_stn_crnn_matches_jax_apply_eval():
    rng = np.random.default_rng(1)
    jcfg = ModelConfig(**SMALL_STN)
    x = rng.normal(size=(4, 32, 64, 1)).astype(np.float32)
    variables = CRNN(cfg=jcfg).init(
        {"params": jax.random.key(2), "dropout": jax.random.key(3)},
        jnp.asarray(x), train=False)
    params = _perturb(variables["params"], rng)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, a.shape)
        .astype(np.float32), variables["batch_stats"])
    want = np.asarray(jax.nn.softmax(CRNN(cfg=jcfg).apply(
        {"params": params, "batch_stats": stats}, x, train=False), -1))
    model = TorchCRNN(TorchConfig(**SMALL_STN))
    model.load_state_dict(tw.params_from_jax(params, stats))
    with torch.inference_mode():
        got = torch.softmax(model.eval()(torch.from_numpy(x[..., 0])), -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_keras_stn_golden_through_the_ports_h5_reader():
    cfg = TorchConfig(**SMALL_STN)
    params, stats = tw.import_keras_h5(
        str(GOLDENS / "keras_small_stn_weights.h5"), cfg)
    assert sorted(params["stn"]) == ["Conv_0", "Conv_1", "Dense_0",
                                     "Dense_1"]
    model = TorchCRNN(cfg)
    model.load_state_dict(tw.params_from_jax(params, stats))
    data = np.load(GOLDENS / "keras_small_stn_io.npz")
    assert bool(data["cfg_use_stn"])
    with torch.inference_mode():
        got = torch.softmax(model.eval()(torch.from_numpy(data["x"][..., 0])),
                            -1)
    np.testing.assert_allclose(got.numpy(), data["y"], rtol=1e-4, atol=2e-5)


def test_init_weights_starts_at_the_identity_transform():
    state = tstate.create_train_state(TorchConfig(**NARROW), seed=3,
                                      device="cpu")
    stn = state.model.stn
    jparams = STN().init(jax.random.key(0),
                         jnp.zeros((1, 32, 64, 1)))["params"]
    # flax's STN init: zero conv biases, a zero theta kernel, the identity
    assert torch.all(stn.theta.weight == 0)
    bias = stn.theta.bias.detach().numpy()
    np.testing.assert_array_equal(bias, np.asarray(jparams["Dense_1"]["bias"]))
    np.testing.assert_array_equal(bias, np.float32(IDENTITY))
    for conv in stn.convs:
        assert torch.all(conv.bias == 0) and conv.weight.std() > 0
    assert torch.all(stn.dense.bias == 0) and stn.dense.weight.std() > 0
    x = np.random.default_rng(2).normal(size=(2, 32, 64)).astype(np.float32)
    with torch.no_grad():
        got = stn(torch.from_numpy(x)).numpy()
    # the identity warp is JAX's to the bit, and the image itself up to
    # the grid's ulps at pixel positions near 63 (times the image's slope)
    want = jops.grid_sample_affine(
        jnp.asarray(x[..., None]), jnp.tile(jnp.float32(IDENTITY), (2, 1)))
    np.testing.assert_array_equal(got, np.asarray(want)[..., 0])
    np.testing.assert_allclose(got, x, rtol=0, atol=1e-4)


# ---- one f32 train step against JAX ----


def _batches(n, B=32):
    synth = JSynth(JSynthCfg(alphabet=ALPHABET, min_len=2, max_len=4))
    host = jpipe.synthetic_batches(batch_size=B, bucket=64, seed=6, steps=n,
                                   synth=synth)
    return [{k: np.asarray(b[k]) for k in (
        "x", "input_length", "the_labels", "label_length")}
        for b in jpipe.device_batches(host, prefetch=0)]


@pytest.fixture(scope="module")
def stn_step():
    jcfg = ModelConfig(**NARROW, use_pallas_rnn=True, use_fused_stem=False)
    state = jstate.create_train_state(jcfg, jax.random.key(4),
                                      learning_rate=LR, pallas_interpret=True)
    params = _perturb(state.params, np.random.default_rng(7), 0.02)
    stats = _np_tree(state.batch_stats)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    batch = _batches(1)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits, _ = CRNN(cfg=jcfg, pallas_interpret=True).apply(
            {"params": p, "batch_stats": stats}, jb["x"][..., None],
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        vec = ctc_loss_vec(logits, jb["the_labels"], jb["input_length"],
                           jb["label_length"], jcfg.ctc_time_slice,
                           use_pallas=True, pallas_interpret=True)
        return jnp.mean(jnp.minimum(vec, 1e4))

    want_grads = tw.params_from_jax(_np_tree(jax.jit(jax.grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))), stats)
    step = make_train_step(jcfg, donate=False, use_pallas_ctc=True,
                           pallas_interpret=True)
    jstate_1, jm = step(state, jb, jax.random.key(0))
    want_sd = tw.params_from_jax(_np_tree(jstate_1.params),
                                 _np_tree(jstate_1.batch_stats))

    cfg = TorchConfig(**NARROW)
    tst = tstate.create_train_state(cfg, tw.params_from_jax(params, stats),
                                    device="cpu", learning_rate=LR)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _ = tstep.loss_fn(tst.model, tb, cfg)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in tst.model.named_parameters()}
    tst.optimizer.zero_grad(set_to_none=True)
    tst.model.load_state_dict(tw.params_from_jax(params, stats))
    tm = tstep.make_train_step(cfg)(tst, tb)
    return dict(grads=grads, want_grads=want_grads, jm=jm, tm=tm,
                sd=tst.model.state_dict(), want_sd=want_sd)


def test_stn_train_step_gradients_match_jax(stn_step):
    got, want = stn_step["grads"], stn_step["want_grads"]
    stn_leaves = [k for k in got if k.startswith("stn.")]
    assert len(stn_leaves) == 8
    for name, g in got.items():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name  # every leaf, STN included, learns
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_stn_train_step_matches_jax(stn_step):
    jm, tm = stn_step["jm"], stn_step["tm"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-5,
                                   err_msg=key)
    grads, got = stn_step["grads"], stn_step["sd"]
    for name, w in stn_step["want_sd"].items():
        g, w = got[name].numpy(), w.numpy()
        if name not in grads:  # BatchNorm running statistics
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
            continue
        gr = np.abs(grads[name])
        noise = gr <= 1e-5 * gr.max()
        off = np.abs(g - w) > 2e-5 + 2e-4 * np.abs(w)
        assert not np.any(off & ~noise), (name, np.abs(g - w)[off].max())
        assert off.mean() <= 1e-3, name
        assert np.all(np.abs(g - w)[off] <= 2 * LR), name


# ---- the bundled STN models ----


@pytest.fixture(scope="module")
def golden():
    return np.load(STN_GOLDENS)


def _lines(g, key, n=None):
    c, hs, ws = g[f"{key}_canvas"], g[f"{key}_heights"], g[f"{key}_widths"]
    n = n or len(hs)
    return [c[i, :hs[i], :ws[i]] for i in range(n)]


@pytest.mark.parametrize("name,key", [("fonts-stn", "stn"),
                                      ("fonts-warp-stn", "warp")])
def test_pretrained_stn_reads_golden_lines_as_jax(golden, name, key):
    """f32, 8 golden lines: the JAX predictor's texts and scores, live and
    as the golden file holds them; served at bucket 256 only."""
    from crnn_ocr_tpu.infer.predictor import Predictor as JaxPredictor

    lines = _lines(golden, key, 8)
    pred = load_pretrained(name, device="cpu", dtype="float32")
    assert pred.buckets == (256,) and pred.cfg.use_stn
    assert pred.resolve_bucket([np.zeros((32, 40), np.uint8)]) == 256
    got = pred.predict(lines)
    ref = jax_load_pretrained(name)
    ref = JaxPredictor(dataclasses.replace(ref.cfg, dtype="float32"),
                       ref._vars["params"], ref._vars["batch_stats"],
                       ref.codec)
    want = ref.predict(lines)
    assert [p.text for p in got] == [p.text for p in want]
    assert [p.text for p in got] == [str(t) for t in
                                     golden[f"{key}_texts_f32"][:8]]
    np.testing.assert_allclose([p.score for p in got],
                               [p.score for p in want], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([p.score for p in got],
                               golden[f"{key}_scores_f32"][:8], rtol=1e-4,
                               atol=1e-5)


def test_fonts_warp_stn_bf16_reads_golden_lines(golden):
    """As shipped (bf16): at most 1 of the 64 lines may differ from the JAX
    package's bf16 texts (its sampler, stem and recurrence through their
    Pallas kernels in interpret mode)."""
    pred = load_pretrained("fonts-warp-stn", device="cpu")
    assert pred.model.dtype == torch.bfloat16
    got = [p.text for p in pred.predict(_lines(golden, "warp"))]
    want = [str(t) for t in golden["warp_texts_bf16"]]
    assert sum(a != b for a, b in zip(got, want)) <= 1
