"""Port parity: the CTC loss (crnn_ocr_torch.kernels.ctc_loss, ops.ctc).

On the CPU the loss runs the plain versions of K6 and K7 inside the same
autograd Function the card runs, so these tests hold the whole loss and its
analytic gradient to the JAX package: to ``ctc_loss_pallas`` (interpret
mode) and to the ``lax.scan`` loss ``ctc_forward_log_loss`` under
``jax.grad``, in the cases of ``tests/test_kernels.py::TestCtcPallas``.

Tolerances: values rtol 1e-5 / atol 1e-5 (as the JAX test holds its kernel
to its scan: f32 log-sum-exps in another order), gradients rtol 1e-4 /
atol 1e-5; ``ctc_batch_cost`` against the tf_keras goldens at 1e-4, as
``tests/test_ctc_loss.py`` holds the JAX loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import ctc_loss as tcl
from crnn_ocr_torch.ops import ctc as tctc
from crnn_ocr_tpu.kernels.ctc_loss import ctc_loss_pallas
from crnn_ocr_tpu.ops import ctc as jctc


def _case(B=128, T=12, C=9, L=4, seed=0, varlen=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, C)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = rng.integers(0, C - 1, size=(B, L)).astype(np.int32)
    if varlen:
        il = rng.integers(2 * L + 1, T + 1, (B,)).astype(np.int32)
        ll = rng.integers(1, L + 1, (B,)).astype(np.int32)
    else:
        il = np.full((B,), T, np.int32)
        ll = np.full((B,), L, np.int32)
    return lp, labels, il, ll


def _jax_grads(lp, labels, il, ll, reduce=jnp.mean):
    """(pallas value, pallas grad, scan value, scan grad) of the reduced
    loss."""
    def loss_p(x):
        return reduce(ctc_loss_pallas(x, labels, il, ll, True))

    def loss_s(x):
        return reduce(jctc.ctc_forward_log_loss(x, labels, il, ll,
                                                blank=x.shape[-1] - 1))

    lp = jnp.asarray(lp)
    vp, gp = jax.value_and_grad(loss_p)(lp)
    vs, gs = jax.value_and_grad(loss_s)(lp)
    return [np.asarray(a) for a in (vp, gp, vs, gs)]


def _torch_loss(lp, labels, il, ll):
    x = torch.from_numpy(lp).requires_grad_(True)
    loss = tcl.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(il),
                        torch.from_numpy(ll))
    return x, loss


@pytest.mark.parametrize("seed,varlen", [(0, True), (3, True), (4, False)])
def test_values_and_gradients_match_jax(seed, varlen):
    lp, labels, il, ll = _case(seed=seed, varlen=varlen)
    want = np.asarray(ctc_loss_pallas(jnp.asarray(lp), labels, il, ll, True))
    want_scan = np.asarray(jctc.ctc_forward_log_loss(
        jnp.asarray(lp), labels, il, ll, blank=lp.shape[-1] - 1))
    a0, b0 = tcl.alpha_launches, tcl.beta_launches
    x, loss = _torch_loss(lp, labels, il, ll)
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.detach().numpy(), want_scan, rtol=1e-5,
                               atol=1e-5)
    loss.mean().backward()
    _, gp, _, gs = _jax_grads(lp, labels, il, ll)
    np.testing.assert_allclose(x.grad.numpy(), gp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), gs, rtol=1e-4, atol=1e-5)
    # the CPU path launches no kernel
    assert (tcl.alpha_launches, tcl.beta_launches) == (a0, b0)


def test_alphas_and_betas_match_pallas_kernels():
    """K6's and K7's plain versions against the TPU kernels' own outputs
    (``_run_fwd``/``_run_bwd`` in interpret mode, (T, S, B) layout)."""
    from crnn_ocr_tpu.kernels import ctc_loss as jcl

    lp, labels, il, ll = _case(seed=11)
    emits_t, skip, valid, lens, endm, _, _ = jcl._prep(
        jnp.asarray(lp), labels, il, ll)
    T = lp.shape[1]
    want_a = np.asarray(jcl._run_fwd(emits_t, skip, valid, lens, True))[:T]
    want_b = np.asarray(jcl._run_bwd(emits_t, skip, valid, lens, endm,
                                     True))[:T]
    emits, flags, tlens, _, _ = tcl.prepare(
        torch.from_numpy(lp), torch.from_numpy(labels),
        torch.from_numpy(il), torch.from_numpy(ll))
    np.testing.assert_array_equal(emits.permute(1, 2, 0).numpy(),
                                  np.asarray(emits_t)[:T])
    got_a = tcl.ctc_alphas(emits, flags, tlens).permute(1, 2, 0).numpy()
    got_b = tcl.ctc_betas(emits, flags, tlens).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got_a, want_a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_b, want_b, rtol=1e-5, atol=1e-5)


def test_infeasible_samples_get_zero_gradients():
    lp, labels, il, ll = _case(seed=7)
    L = labels.shape[1]
    # samples 0 and 1 need more frames than they have (L labels need L
    # frames, 2L - 1 with repeats)
    ll[0] = ll[1] = L
    labels[1, :] = labels[1, 0]
    il[0], il[1] = 2, L + 1
    x, loss = _torch_loss(lp, labels, il, ll)
    assert loss[0].item() > 1e29 and loss[1].item() > 1e29
    loss.sum().backward()
    g = x.grad.numpy()
    assert np.all(g[0] == 0.0) and np.all(g[1] == 0.0)
    assert not np.any(np.isnan(g))
    _, gp, _, gs = _jax_grads(lp, labels, il, ll, reduce=jnp.sum)
    np.testing.assert_array_equal(g[:2], gp[:2])
    np.testing.assert_allclose(g[2:], gs[2:], rtol=1e-4, atol=1e-5)


def test_empty_labels():
    """label_length = 0: the loss is minus the sum of the blank's log-probs
    over the valid frames, as in both JAX paths."""
    lp, labels, il, ll = _case(seed=8, B=6)
    ll[:] = [0, 0, 1, 0, 2, 0]
    x, loss = _torch_loss(lp, labels, il, ll)
    loss.sum().backward()
    vp, gp, vs, gs = _jax_grads(lp, labels, il, ll, reduce=jnp.sum)
    want = np.asarray(ctc_loss_pallas(jnp.asarray(lp), labels, il, ll, True))
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    blank = -np.array([lp[b, :il[b], -1].sum() for b in range(6)])
    empty = ll == 0
    np.testing.assert_allclose(loss.detach().numpy()[empty], blank[empty],
                               rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), gs, rtol=1e-4, atol=1e-5)


def test_gradients_through_log_softmax():
    lp, labels, il, ll = _case(seed=5, varlen=False)
    z = lp * 2.0  # arbitrary pre-activations

    def loss_s(z):
        return jnp.sum(jctc.ctc_forward_log_loss(
            jax.nn.log_softmax(z, -1), labels, il, ll, blank=z.shape[-1] - 1))

    want = np.asarray(jax.grad(loss_s)(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    tcl.ctc_loss(
        torch.log_softmax(zt, -1), torch.from_numpy(labels),
        torch.from_numpy(il), torch.from_numpy(ll)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-4, atol=1e-5)


def test_ctc_batch_cost_matches_keras_goldens(goldens):
    data = goldens("ctc_loss.npz")
    n = int(data["n_cases"])
    assert n >= 5
    for i in range(n):
        got = tctc.ctc_batch_cost(
            torch.from_numpy(data[f"case{i}_labels"]),
            torch.from_numpy(data[f"case{i}_probs"]),
            torch.from_numpy(data[f"case{i}_input_len"]),
            torch.from_numpy(data[f"case{i}_label_len"]))
        assert got.shape == (data[f"case{i}_probs"].shape[0], 1)
        np.testing.assert_allclose(got.numpy(), data[f"case{i}_loss"],
                                   rtol=1e-4, atol=1e-4, err_msg=str(i))


def test_wrappers_check_their_operands():
    lp, labels, il, ll = _case(B=2)
    args = [torch.from_numpy(a) for a in (lp, labels, il, ll)]
    emits, flags, lens, _, _ = tcl.prepare(*args)
    with pytest.raises(ValueError, match="flags"):
        tcl.ctc_alphas(emits, flags.long(), lens)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tcl.ctc_betas(emits.to(meta), flags.to(meta), lens.to(meta))


@pytest.mark.parametrize("exact_keras", [False, True])
def test_ctc_loss_vec_matches_jax_train_step_loss(exact_keras):
    """The train step's per-line loss from raw logits, after the 2-frame
    slice: values and gradients against ``crnn_ocr_tpu.train.step``'s."""
    from crnn_ocr_torch.train.step import ctc_loss_vec
    from crnn_ocr_tpu.train.step import ctc_loss_vec as jax_loss_vec

    lp, labels, il, ll = _case(seed=12, B=16, T=14)
    logits = lp * 3.0
    il = np.minimum(il, 12)  # frames after the slice

    def loss_j(z):
        return jnp.sum(jax_loss_vec(z, labels, il, ll, ctc_time_slice=2,
                                    exact_keras=exact_keras))

    want_v = np.asarray(jax_loss_vec(jnp.asarray(logits), labels, il, ll,
                                     ctc_time_slice=2,
                                     exact_keras=exact_keras))
    want_g = np.asarray(jax.grad(loss_j)(jnp.asarray(logits)))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss_vec(z, torch.from_numpy(labels), torch.from_numpy(il),
                       torch.from_numpy(ll), ctc_time_slice=2,
                       exact_keras=exact_keras)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want_v, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(z.grad.numpy(), want_g, rtol=1e-4, atol=1e-5)
