"""Port parity on the CPU for the computations behind the JAX package's
public names: ``ops.ctc.ctc_forward_log_loss`` at any blank,
``ctc_loss_from_log_probs``, ``ops.grid_sample.grid_sample_affine`` at
another output size and ``bilinear_sample`` over channels,
``models.build_model``, ``STN``'s localization widths and
``preprocess_batch(antialias=True)``.

Inputs come from a numpy seed. On the CPU the CTC loss runs K6's and K7's
plain versions and the sampler K11's and K12's, inside the autograd
Functions the card runs. Tolerances:

* the CTC loss and its gradient against the ``lax.scan`` loss under
  ``jax.grad``: rtol 1e-5 / atol 1e-5 (f32 log-sum-exps in another order);
* the sampler's value and its gradients with respect to the image and the
  coordinates against JAX's ``bilinear_sample`` (and the warp against
  JAX's ``grid_sample_affine``, its banded sampler on the CPU): atol 1e-5
  (the same bilinear weights, products associated in another order), and
  rtol 1e-5 too for the coordinates' gradient, whose terms reach ~30;
* ``build_model``'s logits against ``CRNN.apply``: rtol 1e-4 / atol 1e-5,
  the scores' gate of ``chip_smoke.py`` phase 3;
* the STN's theta rtol 1e-5 / atol 1e-6 and its warp atol 2e-4, as
  ``tests/test_torch_stn.py``;
* the antialiased resize weights atol 1e-7 and the frames atol 1e-4, as
  ``tests/test_torch_preprocess.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from crnn_ocr_torch.config import ModelConfig as TorchConfig
from crnn_ocr_torch.infer import weights as tw
from crnn_ocr_torch.models import STN as TorchSTN
from crnn_ocr_torch.models import build_model
from crnn_ocr_torch.ops import ctc as tctc
from crnn_ocr_torch.ops import grid_sample as tgs
from crnn_ocr_torch.ops import preprocess as tp
from crnn_ocr_tpu.models import CRNN, ModelConfig
from crnn_ocr_tpu.models.stn import STN
from crnn_ocr_tpu.ops import ctc as jctc
from crnn_ocr_tpu.ops import grid_sample as jgs
from crnn_ocr_tpu.ops import preprocess as jp

B, T, C, L = 4, 24, 12, 6


def _ctc_case(blank: int, seed: int = 0):
    """Log-probs (B, T, C), labels that avoid ``blank`` and are padded with
    it past their lengths (one row with a repeat), lengths."""
    rng = np.random.default_rng(seed)
    lp = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.normal(size=(B, T, C)).astype(np.float32)), -1))
    classes = np.array([c for c in range(C) if c != blank])
    ll = np.array([L, 3, 5, 1], np.int32)
    labels = np.full((B, L), blank, np.int32)
    for b in range(B):
        labels[b, :ll[b]] = rng.choice(classes, ll[b])
    labels[0, 1] = labels[0, 0]  # a repeated label needs a blank between
    il = np.array([T, T - 5, 2 * L + 1, 7], np.int32)
    return lp, labels, il, ll


def _jax_loss_grad(lp, labels, il, ll, blank):
    w = jnp.arange(1, B + 1, dtype=jnp.float32)  # a cotangent per sample

    def f(x):
        loss = jctc.ctc_forward_log_loss(x, labels, il, ll, blank=blank)
        return jnp.sum(loss * w), loss

    (_, loss), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(lp))
    return np.asarray(loss), np.asarray(grad)


def _torch_loss_grad(fn, lp, labels, il, ll, *args):
    x = torch.from_numpy(lp).requires_grad_(True)
    loss = fn(x, torch.from_numpy(labels), torch.from_numpy(il),
              torch.from_numpy(ll), *args)
    (loss * torch.arange(1, B + 1, dtype=torch.float32)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("blank", [0, C // 2, C - 1])
def test_ctc_forward_log_loss_matches_jax_at_any_blank(blank):
    lp, labels, il, ll = _ctc_case(blank)
    want_loss, want_grad = _jax_loss_grad(lp, labels, il, ll, blank)
    loss, grad = _torch_loss_grad(tctc.ctc_forward_log_loss, lp, labels, il,
                                  ll, blank)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-5)
    # the blank column takes gradient: the permutation came back in place
    assert np.abs(grad[..., blank]).max() > 0.1


def test_ctc_padding_past_the_length_is_ignored():
    lp, labels, il, ll = _ctc_case(0, seed=1)
    other = labels.copy()
    for b in range(B):
        other[b, ll[b]:] = np.arange(L - ll[b]) % C  # any values, -1 too
    other[1, -1] = -1
    for lab in (labels, other):
        loss, grad = _torch_loss_grad(tctc.ctc_forward_log_loss, lp, lab, il,
                                      ll, 0)
        want_loss, want_grad = _jax_loss_grad(lp, lab, il, ll, 0)
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-5)
    a = _torch_loss_grad(tctc.ctc_forward_log_loss, lp, labels, il, ll, 0)
    b = _torch_loss_grad(tctc.ctc_forward_log_loss, lp, other, il, ll, 0)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_ctc_loss_from_log_probs_matches_jax():
    lp, labels, il, ll = _ctc_case(C - 1, seed=2)
    want = np.asarray(jctc.ctc_loss_from_log_probs(jnp.asarray(lp), labels,
                                                   il, ll))
    want_loss, want_grad = _jax_loss_grad(lp, labels, il, ll, C - 1)
    np.testing.assert_array_equal(want, want_loss)
    loss, grad = _torch_loss_grad(tctc.ctc_loss_from_log_probs, lp, labels,
                                  il, ll)
    np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="blank"):
        tctc.ctc_forward_log_loss(torch.from_numpy(lp), labels, il, ll, C)


def _warp_case(seed: int, channels: int, H: int = 16, W: int = 64):
    """Images (2, H, W, channels) in [0, 1] and a theta per image near the
    identity, reaching past the borders."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(2, H, W, channels)).astype(np.float32)
    theta = (np.float32([1, 0, 0, 0, 1, 0])
             + rng.normal(scale=0.15, size=(2, 6))).astype(np.float32)
    return img, theta


def _sample_grads(sample, img, coords, g):
    """(out, d_img, d_coords) of ``sum(sample(img, coords) * g)``."""
    if isinstance(img, np.ndarray):
        out, vjp = jax.vjp(jax.jit(sample), jnp.asarray(img),
                           jnp.asarray(coords))
        return [np.asarray(a) for a in (out, *vjp(jnp.asarray(g)))]
    img = img.clone().requires_grad_(True)
    coords = coords.clone().requires_grad_(True)
    out = sample(img, coords)
    (out * torch.from_numpy(g)).sum().backward()
    return [a.detach().numpy() for a in (out, img.grad, coords.grad)]


@pytest.mark.parametrize("channels,size", [
    (1, (24, 96)),  # up: N = Ho * Wo above H * W
    (1, (8, 32)),  # down
    (3, (12, 48)),  # channels folded into the batch
], ids=["up", "down", "c3"])
def test_bilinear_sample_and_warp_match_jax(channels, size):
    img, theta = _warp_case(channels, channels)
    Ho, Wo = size
    coords = np.asarray(jgs.affine_grid(jnp.asarray(theta), Ho, Wo))
    got_coords = tgs.affine_grid(torch.from_numpy(theta), Ho, Wo)
    np.testing.assert_array_equal(got_coords.numpy(), coords)
    g = np.random.default_rng(9).normal(
        size=(2, Ho, Wo, channels)).astype(np.float32)
    want = _sample_grads(jgs.bilinear_sample, img, coords, g)
    got = _sample_grads(tgs.bilinear_sample, torch.from_numpy(img),
                        got_coords, g)
    # d_coords is in normalized units, (W - 1) / 2 pixels each: its terms
    # reach |g| * (W - 1) / 2 ~ 30, and JAX sums the channels' terms
    # before the x-blend's difference, the port after (rtol 1e-5 too)
    for name, a, b, rtol in zip(("out", "d_img", "d_coords"), got, want,
                                (0, 0, 1e-5)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5, err_msg=name)
    warped = tgs.grid_sample_affine(torch.from_numpy(img),
                                    torch.from_numpy(theta), Ho, Wo)
    want_warp = jgs.grid_sample_affine(jnp.asarray(img), jnp.asarray(theta),
                                       Ho, Wo)
    np.testing.assert_allclose(warped.numpy(), np.asarray(want_warp), rtol=0,
                               atol=1e-5)


def test_bilinear_sample_folds_channels_as_single_images():
    """Channel c of a C-channel sample is the one-channel sample of that
    plane, bit for bit, in the value and both gradients."""
    img, theta = _warp_case(4, 3)
    coords = tgs.affine_grid(torch.from_numpy(theta), 12, 48)
    g = np.random.default_rng(5).normal(size=(2, 12, 48, 3)).astype(
        np.float32)
    out, d_img, d_coords = _sample_grads(tgs.bilinear_sample,
                                         torch.from_numpy(img), coords, g)
    sum_dc = 0
    for c in range(3):
        o, di, dc = _sample_grads(
            tgs.bilinear_sample, torch.from_numpy(img[..., c:c + 1].copy()),
            coords, np.ascontiguousarray(g[..., c:c + 1]))
        np.testing.assert_array_equal(out[..., c:c + 1], o)
        np.testing.assert_array_equal(d_img[..., c:c + 1], di)
        sum_dc = sum_dc + dc
    # autograd sums the channels' terms (up to ~30) in its own order
    np.testing.assert_allclose(d_coords, sum_dc, rtol=1e-6, atol=1e-5)
    assert tgs.grid_sample_affine(torch.from_numpy(img),
                                  torch.from_numpy(theta)).shape == img.shape


NARROW = dict(num_classes=10, width=64, stem_filters=16,
              block_filters=(16, 24, 32, 32), time_dense_size=32, n_units=32,
              rnn_layers=2, rnn_cell="gru", dropout_rate=0.0)


def test_build_model_matches_jax_apply():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 32, 64, 1)).astype(np.float32)
    jcfg = ModelConfig(**NARROW)
    v = jax.jit(lambda a: CRNN(cfg=jcfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, a,
        train=False))(x)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, a.shape)
        .astype(np.float32), v["batch_stats"])
    want = np.asarray(jax.jit(lambda v, a: CRNN(cfg=jcfg).apply(
        v, a, train=False))({"params": params, "batch_stats": stats}, x))
    model = build_model(TorchConfig(**NARROW), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    model.load_state_dict(tw.params_from_jax(params, stats))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x[..., 0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _stn_state_dict(params):
    sd = {}
    i = 0
    while f"Conv_{i}" in params:
        c = params[f"Conv_{i}"]
        sd[f"convs.{i}.weight"] = np.transpose(c["kernel"], (3, 2, 0, 1))
        sd[f"convs.{i}.bias"] = c["bias"]
        i += 1
    for key, name in (("Dense_0", "dense"), ("Dense_1", "theta")):
        sd[f"{name}.weight"] = params[key]["kernel"].T
        sd[f"{name}.bias"] = params[key]["bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def test_stn_localization_widths_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 32, 64, 1)).astype(np.float32)
    jstn = STN(loc_filters=(8, 16), loc_dense=20)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.05)
        .astype(np.float32), jstn.init(jax.random.key(2), x)["params"])
    want, inter = jstn.apply({"params": params}, x,
                             capture_intermediates=True)
    want_theta = np.asarray(inter["intermediates"]["Dense_1"]["__call__"][0])
    m = TorchSTN(32, 64, loc_filters=(8, 16), loc_dense=20)
    m.load_state_dict(_stn_state_dict(params))
    xt = torch.from_numpy(x[..., 0])
    with torch.no_grad():
        theta = m.localize(xt)
        got = m(xt)
    np.testing.assert_allclose(theta.numpy(), want_theta, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               rtol=0, atol=2e-4)
    # JAX's defaults build the modules and keys the bundled models load
    shapes = {k: tuple(v.shape) for k, v in TorchSTN(32, 256).state_dict()
              .items()}
    assert shapes == {
        "convs.0.weight": (16, 1, 5, 5), "convs.0.bias": (16,),
        "convs.1.weight": (32, 16, 5, 5), "convs.1.bias": (32,),
        "dense.weight": (50, 4 * 32 * 32), "dense.bias": (50,),
        "theta.weight": (6, 50), "theta.bias": (6,)}


@pytest.mark.parametrize("in_size,out_size,scale", [
    (48, 32, 32 / 45), (300, 64, 64 / 300), (40, 32, 32 / 17)])
def test_antialiased_weights_equal_jax(in_size, out_size, scale):
    s = np.float32(scale)
    want = jax_scale.compute_weight_mat(
        in_size, out_size, jnp.float32(s), jnp.float32(0.0),
        jax_scale._fill_triangle_kernel, True)
    got = tp._linear_weights(in_size, out_size,
                             torch.tensor([s], dtype=torch.float32), True)[0]
    np.testing.assert_allclose(got.numpy().T, np.asarray(want), rtol=0,
                               atol=1e-7)


def test_preprocess_batch_antialias_matches_jax():
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (int(rng.integers(40, 90)),
                                    int(rng.integers(60, 400))))
              .astype(np.uint8) for _ in range(4)]
    canvas, hs, ws = jp.pack_canvas(images)
    want_x, want_w = jp.preprocess_batch(canvas, hs, ws, out_h=32, out_w=128,
                                         antialias=True)
    got_x, got_w = tp.preprocess_batch(
        torch.from_numpy(canvas), torch.from_numpy(hs), torch.from_numpy(ws),
        out_h=32, out_w=128, antialias=True)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-4)
    plain, _ = tp.preprocess_batch(
        torch.from_numpy(canvas), torch.from_numpy(hs), torch.from_numpy(ws),
        out_h=32, out_w=128)
    assert not torch.allclose(plain, got_x, atol=1e-3)


def test_chip_phase_31_goldens_hold_on_the_cpu():
    """``chip_smoke.py`` phase 31's run at its full shapes (fonts-hard's
    CTC, B 256 warps) on the CPU's plain versions, against the committed
    JAX goldens at the phase's gates (``surface_against``): the goldens,
    the seeded inputs and the gates agree before the card sees them."""
    import chip_smoke as cs

    t = {k: torch.from_numpy(v) for k, v in cs.surface_inputs().items()}
    got = cs.surface_run(t)
    golden = np.load(cs.SURFACE_GOLDENS)
    errs = cs.surface_against(got, got, golden)
    assert {k for k in errs if k.endswith("/jax")} == {
        "ctc_b0/loss/jax", "ctc_b62/loss/jax", "ctc_b0/grad/jax",
        *(f"{n}/{k}/jax" for n in ("up", "down")
          for k in ("out", "d_img", "d_theta")),
        *(f"c3/{k}/jax" for k in ("out", "d_img", "d_coords"))}
