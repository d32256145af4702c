"""Port parity: the training stem (crnn_ocr_torch.kernels.fused_stem_train,
K8-K10 behind the autograd Function ``fused_stem_train``) and the CRNN's
training path through it.

On the CPU every wrapper runs its kernel's plain version, held here to the
JAX package's ``fused_stem_train`` in Pallas interpret mode on the same
inputs (made with numpy from a seed). Tolerances:

* mean, var, pooled output in f32: rtol 1e-5, atol 1e-6 (f32 sums over
  (B, H, W) and 9-term convs in other orders); in bf16 the conv operands
  are bf16 and everything after is f32, so mean and var as in f32 and the
  bf16 pooled output within one bf16 ulp (2^-7 of the value) plus 1e-6;
* d_w, d_gamma, d_beta in f32 against ``jax.grad``: rtol 1e-4, atol 1e-4
  of the leaf's largest value (the conv-weight gradient sums B * H * W
  products in another order: the band matmul against ``unfold``), 20x
  tighter than JAX's own check of its kernel against the XLA stem
  (rtol 2e-3, atol 5e-4, ``tests/test_kernels.py``); in bf16 the pooled
  output, and with it the upstream gradient, is bf16, so rtol 1e-2 with
  atol 1e-2 of the leaf's largest;
* the image of those checks holds exact ties (4x4-column blocks of equal
  pixels, whose adjacent conv outputs are bit-equal in both frameworks) and
  all-zero windows (rows of zeros, where channels with a negative folded
  bias give four ReLU zeros); both must route as JAX routes them;
* the narrow CRNN's train forward and backward against JAX's
  ``CRNN(use_fused_stem=True, pallas_interpret=True)``: loss rtol 1e-5,
  each gradient leaf rtol 1e-4 / atol 1e-4 of its largest, the running
  statistics rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer.weights import params_from_jax
from crnn_ocr_torch.kernels import fused_stem_train as fst
from crnn_ocr_torch.models import crnn as tcrnn
from crnn_ocr_torch.models.crnn import CRNN as TorchCRNN
from crnn_ocr_tpu.kernels.fused_stem_train import fused_stem_train as jax_fst
from crnn_ocr_tpu.models import CRNN as JaxCRNN
from crnn_ocr_tpu.models import ModelConfig as JaxConfig

EPS = 1e-3
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed=12, B=4, H=32, W=48, C=8):
    """An image with exact ties and all-zero windows, weights, BN affine."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W, 1)).astype(np.float32)
    img[:, :8] = 0.0  # pooled rows 0-2 see only zeros
    # rows 16-31: columns 1-4, 5-8, ... equal, so the conv outputs at
    # columns 2j and 2j + 1 are equal for odd j
    blocks = rng.normal(size=(B, 16, W // 4 + 1, 1)).astype(np.float32)
    img[:, 16:, 1:] = np.repeat(blocks, 4, axis=2)[:, :, :W - 1]
    return dict(
        img=img,
        conv_w=(rng.normal(size=(3, 3, 1, C)) * 0.3).astype(np.float32),
        gamma=rng.uniform(0.5, 1.5, C).astype(np.float32),
        beta=rng.normal(size=C).astype(np.float32),
    )


def _loss_weights(shape):
    return np.random.default_rng(5).normal(size=shape).astype(np.float32)


def _jax_run(a, jdt):
    """JAX's pooled, mean, var and the gradients of sum(sin(pooled * 1.7)
    * u) with respect to (conv_w, gamma, beta)."""
    img = jnp.asarray(a["img"]).astype(jdt)
    bf16 = jdt == jnp.bfloat16

    def f(cw, g, b):
        p, m, v = jax_fst(img, cw, g, b, EPS, bf16, True, None)
        u = _loss_weights(p.shape)
        loss = jnp.sum(jnp.sin(p.astype(jnp.float32) * 1.7) * u)
        return loss, (p, m, v)

    (_, (p, m, v)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(a["conv_w"]), jnp.asarray(a["gamma"]),
        jnp.asarray(a["beta"]))
    return [np.asarray(t, np.float32) for t in (p, m, v, *grads)]


def _torch_run(a, tdt):
    img = torch.from_numpy(a["img"]).to(tdt)
    ps = [torch.from_numpy(a[k]).requires_grad_(True)
          for k in ("conv_w", "gamma", "beta")]
    counts = (fst.stats_launches, fst.partials_launches, fst.final_launches)
    p, m, v = fst.fused_stem_train(img, *ps, EPS)
    assert p.dtype == tdt and m.dtype == v.dtype == torch.float32
    assert not m.requires_grad and not v.requires_grad
    u = torch.from_numpy(_loss_weights(tuple(p.shape)))
    (torch.sin(p.float() * 1.7) * u).sum().backward()
    # the CPU path launches no kernel
    assert counts == (fst.stats_launches, fst.partials_launches,
                      fst.final_launches)
    return [t.detach().float().numpy() for t in (p, m, v)] + [
        t.grad.numpy() for t in ps]


@pytest.fixture(scope="module", params=sorted(DTYPES))
def runs(request):
    tdt, jdt = DTYPES[request.param]
    a = _inputs()
    return request.param, a, _torch_run(a, tdt), _jax_run(a, jdt)


def test_stats_and_pooled_match_jax(runs):
    dtype, _, got, want = runs
    for name, g, w in zip(("pooled", "mean", "var"), got[:3], want[:3]):
        assert g.shape == w.shape, name
        if name == "pooled" and dtype == "bfloat16":
            assert (np.abs(g - w) <= np.abs(w) * 2.0 ** -7 + 1e-6).all()
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_gradients_match_jax(runs):
    dtype, _, got, want = runs
    tol = 1e-4 if dtype == "float32" else 1e-2
    for name, g, w in zip(("d_w", "d_gamma", "d_beta"), got[3:], want[3:]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=name)


def test_ties_and_zero_windows_are_present_and_routed(runs):
    """The checks above ran on an image with exact 2- and 4-way ties at a
    positive maximum and all-zero windows; here: they are there, and the
    plain routing gives the first maximum the gradient and an all-zero
    window nothing."""
    _, a, got, _ = runs
    img = torch.from_numpy(a["img"])
    w = torch.from_numpy(a["conv_w"])
    mean, var = torch.from_numpy(got[1]), torch.from_numpy(got[2])
    inv = torch.rsqrt(var + EPS)
    scale = torch.from_numpy(a["gamma"]) * inv
    bias = torch.from_numpy(a["beta"]) - mean * inv * torch.from_numpy(
        a["gamma"])
    z = fst._conv(img, w)
    act = torch.relu(z * scale[:, None, None] + bias[:, None, None])
    B, C, H, W = act.shape
    win = act.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5)
    win = win.reshape(B, C, H // 2, W // 2, 4)
    top = win.max(-1).values
    n_max = (win == top[..., None]).sum(-1)
    assert int(((n_max >= 2) & (top > 0)).sum()) > 100  # exact ties
    assert int((top == 0).sum()) > 100  # all-zero windows
    g = torch.ones((B, H // 2, W // 2, C))
    d = fst._routed(z, g, scale, bias)
    dwin = d.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5)
    dwin = dwin.reshape(B, C, H // 2, W // 2, 4)
    want = torch.nn.functional.one_hot(win.argmax(-1), 4).float()
    want = want * (top > 0)[..., None]
    assert torch.equal(dwin, want)
    # first of the tied positions, by hand on one window
    tied = ((n_max == 4) & (top > 0)).nonzero()[0].tolist()
    assert dwin[tuple(tied)].tolist() == [1.0, 0.0, 0.0, 0.0]


def test_batch_variance_is_not_clamped():
    """var = E[z^2] - mean^2 as the JAX kernel computes it: where z barely
    varies around a large mean the difference rounds below 0, and the
    running variance moves toward that value, not toward 0."""
    rng = np.random.default_rng(3)
    C = 16
    img = 300.0 + 1e-3 * rng.normal(size=(4, 8, 8, 1))
    conv_w = np.zeros((3, 3, 1, C), np.float32)
    conv_w[1, 1, 0] = rng.uniform(0.5, 2.0, C)  # z = w * x, padding aside
    img = torch.from_numpy(img.astype(np.float32))
    _, mean, var = fst.fused_stem_train(
        img, torch.from_numpy(conv_w), torch.ones(C), torch.zeros(C))
    s = fst.stem_stats(img, torch.from_numpy(conv_w))
    n = float(img.numel())
    m = s[0] / n
    assert torch.equal(var, s[1] / n - m * m)
    assert bool((var < 0).any())
    cfg = TorchConfig(num_classes=3, height=8, width=8, stem_filters=C,
                      block_filters=(8,), block_pools=((2, 2),),
                      time_dense_size=8, n_units=8, rnn_layers=1,
                      dropout_rate=0.0)
    model = TorchCRNN(cfg).train()
    with torch.no_grad():
        model.stem_conv.weight.copy_(torch.from_numpy(conv_w)
                                     .permute(3, 2, 0, 1))
    model.stem(img[..., 0])
    want = 0.99 * torch.ones(C) + (1.0 - 0.99) * var
    torch.testing.assert_close(model.stem_bn.running_var, want, rtol=0,
                               atol=1e-7)
    assert bool((model.stem_bn.running_var[var < 0] < 0.99).all())


def test_refuses_an_image_that_requires_grad_and_checks_operands():
    a = _inputs(B=1, W=8, C=4)
    img = torch.from_numpy(a["img"]).requires_grad_(True)
    args = [torch.from_numpy(a[k]) for k in ("conv_w", "gamma", "beta")]
    with pytest.raises(RuntimeError, match="no image gradient"):
        fst.fused_stem_train(img, *args)
    with pytest.raises(ValueError, match="even"):
        fst.stem_stats(torch.zeros(1, 5, 8, 1), args[0])
    with pytest.raises(ValueError, match="pooled gradient"):
        fst.stem_bwd_partials(img.detach(), args[0],
                              torch.zeros(1, 16, 4, 4, dtype=torch.bfloat16),
                              *([torch.zeros(4)] * 4))
    meta = torch.device("meta")  # no fallback: no kernel, no plain version
    with pytest.raises(RuntimeError, match="no kernel"):
        fst.stem_stats(torch.zeros(1, 4, 4, 1, device=meta),
                       torch.zeros(3, 3, 1, 2, device=meta))


# ---- the CRNN's training path ----

NARROW = dict(num_classes=11, width=48, stem_filters=8,
              block_filters=(16, 16, 24, 24), time_dense_size=16,
              n_units=16, rnn_layers=1, dropout_rate=0.0)


def test_stn_model_trains_through_the_plain_stem(monkeypatch):
    calls = []

    def counting(*args, **kw):
        calls.append(1)
        return fst.fused_stem_train(*args, **kw)

    monkeypatch.setattr(tcrnn, "fused_stem_train", counting)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 48)).astype(np.float32))
    plain = TorchCRNN(TorchConfig(**NARROW)).train()
    plain(x).sum().backward()
    assert len(calls) == 1
    stn = TorchCRNN(TorchConfig(**NARROW, use_stn=True)).train()
    stn(x).sum().backward()
    assert len(calls) == 1  # the STN model's stem: plain, image gradient
    assert stn.stn.theta.bias.grad is not None


def test_crnn_train_step_matches_jax_fused_stem():
    """Loss, every gradient leaf and the running statistics of one
    training forward and backward (loss = sum of squared logits) against
    the JAX CRNN on its fused train stem (interpret mode)."""
    cfg = JaxConfig(**NARROW, use_fused_stem=True)
    x = np.random.default_rng(13).normal(size=(4, 32, 48)).astype(np.float32)
    xj = jnp.asarray(x)[..., None]
    variables = JaxCRNN(cfg=dataclasses.replace(cfg, use_fused_stem=False)
                        ).init({"params": jax.random.key(0),
                                "dropout": jax.random.key(1)}, xj,
                               train=False)
    # non-trivial BatchNorm affines and running statistics
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda t: t + 0.1 * rng.normal(size=t.shape).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables))
    model = JaxCRNN(cfg=cfg, pallas_interpret=True)

    def loss_fn(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xj,
            train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(3)})
        return jnp.sum(jnp.square(out)), upd["batch_stats"]

    (loss_j, stats_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want_grads = params_from_jax(to_np(grads_j), to_np(stats_j))
    want_state = params_from_jax(to_np(variables["params"]), to_np(stats_j))

    tm = TorchCRNN(TorchConfig(**NARROW))
    tm.load_state_dict(params_from_jax(variables["params"],
                                       variables["batch_stats"]))
    tm.train()
    n8 = fst.stats_launches
    loss = tm(torch.from_numpy(x)).pow(2).sum()
    loss.backward()
    assert fst.stats_launches == n8  # CPU: plain versions
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name, t in tm.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want_state[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
