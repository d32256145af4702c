"""Port parity: the training path (crnn_ocr_torch.kernels.bigru's training
forward and backward, models in training mode, train.*, data.pipeline).

On the CPU every wrapper runs its kernel's plain version inside the same
autograd Functions the card runs. The JAX side runs its Pallas kernels in
interpret mode. Tolerances:

* BiGRU training forward (hs and gates) and its three gradients in f32:
  rtol 1e-4 / atol 1e-5 (f32 sums in another order, carried through the
  recurrence); in bf16 the dtypes must match and the values track the JAX
  kernel path at rtol 0.1 / atol 0.05, as ``tests/test_kernels.py`` holds
  its own bf16 backward;
* the first step's gradients, leaf by leaf, against ``jax.grad`` of JAX's
  train-step loss at the same weights: rtol 1e-4, atol 1e-4 of the leaf's
  largest gradient (see the test). Adam's first update is about
  ``lr * sign(g)`` whatever the gradient's size, so the parameter checks
  below hold little more than each gradient's sign; this one holds their
  values;
* one f32 train step and three Adam steps against JAX's
  ``make_train_step(use_pallas_ctc=True, pallas_interpret=True)`` at equal
  weights and batches, learning rate 1e-4: loss and grad_norm rtol 2e-5,
  updated params and batch_stats rtol 2e-4 / atol 2e-5, as
  ``tests/test_parallel.py`` holds the JAX kernel path to its scan path.
  One exception, from Adam and not from the port: where a gradient element
  is at the f32 noise of its sum (at most 1e-5 of its tensor's largest;
  about 0.02 % of the GRU kernels' elements here), the two frameworks'
  sums in different orders disagree even in sign, and Adam's normalized
  update ``lr * m / (sqrt(v) + eps)`` turns that noise into a step of up to
  the learning rate. Such elements (counted: at most 0.1 % of a tensor)
  are held to ``2 * lr`` per step taken instead. At a rate of 1e-3 the
  drift they start moves the third step's loss by ~2e-5; at 1e-4 by 1e-6;
* the narrow CRNN with BiLSTM layers: its first step's gradients, and the
  one step, held as the GRU's above;
* one bf16 step, loosely: loss and grad_norm within 0.5 %, and every
  parameter within two Adam updates (``2 * lr``, plus 1e-6 for the f32
  rounding of the parameter) of JAX's, as far apart as two updates of the
  same normalized size land when a bf16 gradient element's sign differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.data import pipeline as tpipe
from crnn_ocr_torch.data.synthetic import SyntheticConfig as TSynthCfg
from crnn_ocr_torch.data.synthetic import SyntheticTextlines as TSynth
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_torch.models.crnn import dropout
from crnn_ocr_torch.models.rnn import BiRNN
from crnn_ocr_torch.train import loop as tloop
from crnn_ocr_torch.train import state as tstate
from crnn_ocr_torch.train import step as tstep
from crnn_ocr_tpu.data import pipeline as jpipe
from crnn_ocr_tpu.data.synthetic import SyntheticConfig as JSynthCfg
from crnn_ocr_tpu.data.synthetic import SyntheticTextlines as JSynth
from crnn_ocr_tpu.kernels.bigru import bigru_fused, bigru_pallas_train
from crnn_ocr_tpu.models import ModelConfig as JaxConfig
from crnn_ocr_tpu.train import state as jstate
from crnn_ocr_tpu.train.step import make_train_step

LR = 1e-4
ALPHABET = "0123456789"
NARROW = dict(num_classes=len(ALPHABET), width=64, stem_filters=16,
              block_filters=(16, 24, 32, 32), time_dense_size=32,
              n_units=128, rnn_layers=2, dropout_rate=0.0)


def _gru_inputs(seed, T=4, B=8, H=128):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, 2, B, 3 * H)).astype(np.float32),
            (rng.normal(size=(2, H, 3 * H)) * 0.1).astype(np.float32),
            (rng.normal(size=(2, 3 * H)) * 0.1).astype(np.float32))


def test_bigru_train_forward_matches_pallas_train():
    xw, u, b = _gru_inputs(0, T=6)
    want_hs, want_g = bigru_pallas_train(jnp.asarray(xw), jnp.asarray(u),
                                         jnp.asarray(b), interpret=True)
    n2, n3 = tbg.launches, tbg.train_launches
    hs, gates = tbg.bigru_train(*(torch.from_numpy(a) for a in (xw, u, b)))
    assert (tbg.launches, tbg.train_launches) == (n2, n3)  # CPU: no kernel
    assert gates.dtype == torch.float32 and gates.shape == want_g.shape
    np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-5)


def _bigru_grads_torch(xw, u, b, dtype):
    ts = [torch.from_numpy(xw).to(dtype), torch.from_numpy(u).to(dtype),
          torch.from_numpy(b)]
    for t in ts:
        t.requires_grad_(True)
    hs = tbg.bigru(*ts)
    assert type(hs.grad_fn).__name__ == "_BiGRUTrainBackward"
    torch.tanh(hs.float()).sum().backward()
    return [t.grad for t in ts]


def _bigru_grads_jax(xw, u, b, dtype):
    return jax.grad(
        lambda xw, u, b: jnp.sum(jnp.tanh(
            bigru_fused(xw, u, b, True).astype(jnp.float32))),
        argnums=(0, 1, 2),
    )(jnp.asarray(xw).astype(dtype), jnp.asarray(u).astype(dtype),
      jnp.asarray(b))


def test_bigru_gradients_match_jax_f32():
    xw, u, b = _gru_inputs(1)
    got = _bigru_grads_torch(xw, u, b, torch.float32)
    want = _bigru_grads_jax(xw, u, b, jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_bigru_bf16_gradients_dtypes_and_values():
    xw, u, b = _gru_inputs(9, T=3)
    got = _bigru_grads_torch(xw, u, b, torch.bfloat16)
    want = _bigru_grads_jax(xw, u, b, jnp.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=0.1,
                                   atol=0.05)


def test_bigru_without_grad_runs_inference_path():
    xw, u, b = _gru_inputs(2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (xw, u, b)]
    with torch.no_grad():
        hs = tbg.bigru(*ts)
    assert hs.grad_fn is None
    np.testing.assert_array_equal(hs.numpy(), tbg.bigru_plain(*ts).detach()
                                  .numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_birnn_kernel_operand_follows_optimizer_steps(dtype):
    """Regression: the card's kernel must read the current recurrent
    weights after an optimizer step, in training mode and after eval()."""
    torch.manual_seed(0)
    rnn = BiRNN(8, 32, dtype=dtype)
    with torch.no_grad():
        for p in rnn.parameters():
            p.normal_(0.0, 0.2)
    rnn.eval()
    before = rnn.kernel_operand().clone()
    rnn.train()
    opt = torch.optim.Adam(rnn.parameters(), lr=0.05)
    rnn(torch.randn(3, 5, 8)).float().pow(2).sum().backward()
    opt.step()
    want = tbg.kernel_weights(rnn.recurrent_kernel.detach().to(dtype))
    assert not torch.equal(want, before)
    assert torch.equal(rnn.kernel_operand(), want)  # training mode
    rnn.eval()
    assert torch.equal(rnn.u_kernel, want)  # the cached buffer, rebuilt
    assert torch.equal(rnn.kernel_operand(), want)


def test_dropout_keeps_and_scales_like_flax():
    x = torch.ones(200_000, dtype=torch.bfloat16)
    y = dropout(x, 0.2, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    # 1 / bf16(0.8), rounded to bf16, as flax divides a bf16 array by a
    # weak-typed scalar
    want = torch.tensor(1.0, dtype=torch.bfloat16) / torch.tensor(
        0.8, dtype=torch.bfloat16)
    assert torch.all(y[kept] == want)


# ---- one train step and three Adam steps against JAX ----


def _jax_cfg(dtype="float32", cell="gru"):
    return JaxConfig(**NARROW, dtype=dtype, rnn_cell=cell,
                     use_pallas_rnn=True, use_fused_stem=False)


def _host_batches(n, B=64):
    synth = JSynth(JSynthCfg(alphabet=ALPHABET, min_len=2, max_len=4))
    host = jpipe.synthetic_batches(batch_size=B, bucket=64, seed=4, steps=n,
                                   synth=synth)
    out = []
    for b in jpipe.device_batches(host, prefetch=0):
        out.append({k: np.asarray(b[k]) for k in (
            "x", "input_length", "the_labels", "label_length")})
    return out


def _run_jax(dtype, batches, cell="gru"):
    cfg = _jax_cfg(dtype, cell)
    state = jstate.create_train_state(cfg, jax.random.key(3),
                                      learning_rate=LR, pallas_interpret=True)
    init = (jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))
    step = make_train_step(cfg, donate=False, use_pallas_ctc=True,
                           pallas_interpret=True)
    rng = jax.random.key(0)
    metrics, snaps = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        rng)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(params_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats)))
    return init, metrics, snaps


def _run_torch(dtype, init, batches, cell="gru"):
    cfg = TorchConfig(**NARROW, dtype=dtype, rnn_cell=cell)
    state = tstate.create_train_state(cfg, params_from_jax(*init),
                                      device="cpu", learning_rate=LR)
    step = tstep.make_train_step(cfg)
    metrics, snaps, grads = [], [], []
    for b in batches:
        m = step(state, {k: torch.from_numpy(np.array(v))
                         for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append({k: v.detach().clone()
                      for k, v in state.model.state_dict().items()})
        # the step's (clipped) gradients, kept until the next step
        grads.append({k: p.grad.float().numpy().copy()
                      for k, p in state.model.named_parameters()})
    return metrics, snaps, grads


def _assert_params_close(got, want, grads, max_step):
    """``got``/``want``: state dicts after ``len(grads)`` steps; ``grads``:
    the port's gradients of each step. See the module docstring."""
    for name, w in want.items():
        g, w = got[name].float().numpy(), w.numpy()
        if name not in grads[0]:  # BatchNorm running statistics
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5,
                                       err_msg=name)
            continue
        noise = np.zeros(g.shape, bool)
        for gr in grads:
            noise |= np.abs(gr[name]) <= 1e-5 * np.abs(gr[name]).max()
        off = np.abs(g - w) > 2e-5 + 2e-4 * np.abs(w)
        assert not np.any(off & ~noise), (name, np.abs(g - w)[off].max())
        assert off.mean() <= 1e-3, name
        assert np.all(np.abs(g - w)[off] <= max_step * len(grads)), name


def _jax_step1_grads(init, batch, cell="gru"):
    """JAX's gradients of the train step's loss (``_train_step_fn``'s
    ``loss_fn``, dropout 0) at the initial weights, as a torch state dict's
    parameters."""
    from crnn_ocr_tpu.models import CRNN as JaxCRNN
    from crnn_ocr_tpu.train.step import ctc_loss_vec

    cfg = _jax_cfg(cell=cell)
    params, stats = jax.tree_util.tree_map(jnp.asarray, init)
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits, _ = JaxCRNN(cfg=cfg, pallas_interpret=True).apply(
            {"params": p, "batch_stats": stats}, b["x"][..., None],
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0)})
        loss_vec = ctc_loss_vec(logits, b["the_labels"], b["input_length"],
                                b["label_length"], cfg.ctc_time_slice,
                                use_pallas=True, pallas_interpret=True)
        return jnp.mean(jnp.minimum(loss_vec, 1e4))

    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(params)),
        init[1])


def _torch_step1_grads(init, batch, cell="gru"):
    """The port's gradients of the same loss at the same weights (before
    the step clips them)."""
    cfg = TorchConfig(**NARROW, rnn_cell=cell)
    state = tstate.create_train_state(cfg, params_from_jax(*init),
                                      device="cpu", learning_rate=LR)
    state.model.train()
    loss, _ = tstep.loss_fn(state.model, {
        k: torch.from_numpy(np.array(v)) for k, v in batch.items()}, cfg)
    loss.backward()
    return {k: p.grad.numpy() for k, p in state.model.named_parameters()}


@pytest.fixture(scope="module")
def f32_runs():
    batches = _host_batches(3)
    init, jm, js = _run_jax("float32", batches)
    tm, ts, tg = _run_torch("float32", init, batches)
    grads = (_torch_step1_grads(init, batches[0]),
             _jax_step1_grads(init, batches[0]))
    return jm, js, tm, ts, tg, grads


def test_train_step_gradients_match_jax_f32(f32_runs):
    """Step 1's gradient of every parameter, leaf by leaf, against
    ``jax.grad`` of JAX's train-step loss: rtol 1e-4, atol 1e-4 of the
    leaf's largest gradient. Both sides sum the batch in f32 in other
    orders, and the CTC gradient ``exp(alpha + beta - log p)`` takes the
    rounding of alphas near -100 (an ulp of ~1e-5) into every element: the
    largest difference seen is 5e-5 of the leaf's largest gradient, in the
    stem conv, and ~1e-5 in the other leaves."""
    got, want = f32_runs[-1]
    assert sorted(got) == sorted(k for k in want if k in got)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("k", [0, 2], ids=["step1", "step3"])
def test_train_steps_match_jax_f32(f32_runs, k):
    jm, js, tm, ts, tg, _ = f32_runs
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[k][key], jm[k][key], rtol=2e-5,
                                   err_msg=key)
    assert sorted(ts[k]) == sorted(js[k])
    _assert_params_close(ts[k], js[k], tg[:k + 1], 2 * LR)


@pytest.fixture(scope="module")
def lstm_runs():
    """One f32 step of the narrow CRNN with BiLSTM layers (H = 128, K5 and
    the analytic LSTM backward on the card) on both sides."""
    batches = _host_batches(1)
    init, jm, js = _run_jax("float32", batches, "lstm")
    tm, ts, tg = _run_torch("float32", init, batches, "lstm")
    grads = (_torch_step1_grads(init, batches[0], "lstm"),
             _jax_step1_grads(init, batches[0], "lstm"))
    return jm, js, tm, ts, tg, grads


def test_lstm_train_step_gradients_match_jax_f32(lstm_runs):
    """As ``test_train_step_gradients_match_jax_f32``, for the LSTM: every
    parameter's gradient, the LSTM's (2, 4H) biases included, leaf by
    leaf against ``jax.grad``."""
    got, want = lstm_runs[-1]
    assert got["birnn0.bias"].shape == (2, 4 * NARROW["n_units"])
    assert sorted(got) == sorted(k for k in want if k in got)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_lstm_train_step_matches_jax_f32(lstm_runs):
    jm, js, tm, ts, tg, _ = lstm_runs
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[0][key], jm[0][key], rtol=2e-5,
                                   err_msg=key)
    assert sorted(ts[0]) == sorted(js[0])
    _assert_params_close(ts[0], js[0], tg[:1], 2 * LR)


def test_train_step_bf16_tracks_jax():
    batches = _host_batches(1)
    init, jm, js = _run_jax("bfloat16", batches)
    tm, ts, _ = _run_torch("bfloat16", init, batches)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[0][key], jm[0][key], rtol=5e-3,
                                   err_msg=key)
    for name, want in js[0].items():
        np.testing.assert_allclose(ts[0][name].numpy(), want.numpy(),
                                   rtol=0, atol=2 * LR + 1e-6, err_msg=name)


# ---- data, schedules, the fit loop ----


@pytest.mark.parametrize("augment", [False, True])
def test_synthetic_stream_is_byte_identical(augment):
    kw = dict(batch_size=8, bucket=128, seed=3, augment=augment, steps=3,
              skip=1)
    got = list(tpipe.synthetic_batches(**kw))
    want = list(jpipe.synthetic_batches(**kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["texts"] == w["texts"] and g["bucket"] == w["bucket"]
        for k in ("the_input", "heights", "widths", "the_labels",
                  "label_length"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the device batch: frames as preprocess holds them to JAX (atol 1e-4),
    # input lengths equal
    b = want[0]
    jb = jpipe.produce_batch(dict(b))
    tb = tpipe.produce_batch(dict(b), "cpu", TorchConfig())
    np.testing.assert_allclose(tb["x"].numpy(), np.asarray(jb["x"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tb["input_length"].numpy(),
                                  np.asarray(jb["input_length"]))
    assert tb["input_length"].dtype == torch.int32


@pytest.mark.parametrize("name,warmup", [
    ("constant", 0), ("cosine", 0), ("cosine", 10), ("cyclic", 0),
    ("cyclic", 10)])
def test_schedules_match_optax(name, warmup):
    want = jstate.make_schedule(name, 1e-3, 1000, warmup)
    got = tstate.make_schedule(name, 1e-3, 1000, warmup)
    for c in (0, 1, 5, 10, 11, 60, 62, 500, 999, 1000, 2000):
        w = float(want(c)) if callable(want) else want
        # optax evaluates in f32: atol one millionth of the rate
        np.testing.assert_allclose(got(c), w, rtol=1e-6, atol=1e-9,
                                   err_msg=str(c))


def test_unported_options_raise():
    cfg = TorchConfig(**NARROW)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstate.create_train_state(cfg, device="cpu", optimizer="lamb")
    state = tstate.create_train_state(cfg, device="cpu")
    for kw, item in ((dict(device_corpus=object()), 9),
                     (dict(steps_per_call=4), 9),
                     (dict(on_device_cer=True), 12), (dict(mesh=object()), 13)):
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            tloop.fit(state, cfg, iter([]), cfg=tloop.FitConfig(**kw))
    if not torch.cuda.is_available():  # entry points default to cuda
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tstate.create_train_state(cfg)


def test_fit_on_synthetic_task_lowers_the_loss(tmp_path):
    synth = TSynth(TSynthCfg(alphabet=ALPHABET, min_len=2, max_len=4))
    cfg = TorchConfig(**dict(NARROW, stem_filters=8, block_filters=(8, 8, 12, 12),
                             time_dense_size=16, n_units=16, rnn_layers=1,
                             dropout_rate=0.1))
    state = tstate.create_train_state(cfg, seed=0, device="cpu",
                                      learning_rate=3e-3)

    def batches(seed, steps=None):
        return tpipe.device_batches(tpipe.synthetic_batches(
            batch_size=16, bucket=64, seed=seed, steps=steps, synth=synth),
            "cpu", cfg)

    path = tmp_path / "m.jsonl"
    tloop.fit(state, cfg, batches(1), lambda: batches(99, 1), synth.codec,
              tloop.FitConfig(steps=60, log_every=5, eval_every=30,
                              metrics_path=str(path)))
    import json

    recs = [json.loads(line) for line in path.read_text().splitlines()]
    train = [r["loss"] for r in recs if r["kind"] == "train"]
    evals = [r for r in recs if r["kind"] == "eval"]
    assert state.step == 60 and len(evals) == 2
    assert np.mean(train[-3:]) < 0.7 * train[0]
    assert all(0.0 <= e["cer"] <= 1.0 for e in evals)
