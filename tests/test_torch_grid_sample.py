"""Port parity: the STN's sampling path (crnn_ocr_torch.ops.grid_sample and
crnn_ocr_torch.kernels.grid_sample) against crnn_ocr_tpu's.

On the CPU the sampler's wrappers run the plain versions of K11 and K12
inside the same autograd Function the card runs; the JAX side runs its
Pallas kernels in interpret mode and its XLA gather sampler. Tolerances:

* ``affine_grid``: bit for bit (an ulp at an integer pixel position flips
  ``floor``, and with it the coordinate gradient);
* samples: 1e-5 absolute on N(0, 1) images (f32 sums of two products in
  another order: the TPU kernel's one-hot matrix product against the
  port's direct blend), as ``tests/test_kernels.py`` holds the Pallas
  sampler to the XLA one;
* gradients with respect to the image and to theta against ``jax.grad``
  through the Pallas custom VJP: rtol 1e-4, atol 1e-5 for the image and
  1e-4 for theta, as ``tests/test_kernels.py:339-372``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import grid_sample as tgs
from crnn_ocr_torch.ops import grid_sample as tops
from crnn_ocr_tpu.kernels.grid_sample import bilinear_sample_pallas
from crnn_ocr_tpu.ops import grid_sample as jops


def _theta(rng, B, spread=0.1):
    return ((rng.normal(size=(B, 6)) * spread)
            + [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]).astype(np.float32)


@pytest.mark.parametrize("H,W", [(32, 256), (32, 32), (32, 64), (16, 24),
                                 (1, 7), (5, 1)])
def test_affine_grid_is_bit_exact(H, W):
    rng = np.random.default_rng(H * 1000 + W)
    for theta in (_theta(rng, 3, 0.3),
                  np.tile(np.float32([1, 0, 0, 0, 1, 0]), (2, 1))):
        want = np.asarray(jops.affine_grid(jnp.asarray(theta), H, W))
        got = tops.affine_grid(torch.from_numpy(theta), H, W).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # (B, 2, 3) theta gives the same grid
    t = torch.from_numpy(theta)
    assert torch.equal(tops.affine_grid(t.reshape(-1, 2, 3), H, W),
                       tops.affine_grid(t, H, W))


def test_grid_first_built_while_serving_enters_training():
    """The base grid is made once per shape and device; one first made
    under inference mode (serving) must still enter a training graph, and
    give theta the gradient of the affine: sum(grid) over (H, W) is
    d/dtheta (sum gx, sum gy, H * W) per row."""
    H, W = 7, 9
    tops._base_grid.cache_clear()
    rng = np.random.default_rng(3)
    theta = torch.from_numpy(_theta(rng, 2, 0.2))
    with torch.inference_mode():
        served = tops.affine_grid(theta, H, W)
    t = theta.clone().requires_grad_(True)
    grid = tops.affine_grid(t, H, W)
    assert torch.equal(grid.detach(), served)
    grid.sum().backward()
    gx = tops._linspace(W).astype(np.float64).sum() * H
    gy = tops._linspace(H).astype(np.float64).sum() * W
    want = np.tile([gx, gy, H * W, gx, gy, H * W], (2, 1))
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("B,H,W,spread", [
    (3, 16, 24, 1.0),     # inside [-1, 1]
    (3, 16, 24, 1.3),     # past the border: the clamp
    (2, 32, 256, 1.3),    # the TPU kernel's multi-chunk shape
])
def test_sampler_matches_pallas_and_xla(B, H, W, spread):
    rng = np.random.default_rng(int(spread * 10) + W)
    img = rng.normal(size=(B, H, W, 1)).astype(np.float32)
    coords = rng.uniform(-spread, spread, (B, H, W, 2)).astype(np.float32)
    n = tgs.launches
    got = tgs.bilinear_sample(torch.from_numpy(img),
                              torch.from_numpy(coords)).numpy()
    assert tgs.launches == n  # the CPU runs the plain version
    pallas = np.asarray(bilinear_sample_pallas(
        jnp.asarray(img), jnp.asarray(coords), interpret=True))
    xla = np.asarray(jops.bilinear_sample(jnp.asarray(img),
                                          jnp.asarray(coords)))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)


def test_sampler_bf16_image():
    """bf16 image: read as f32, the f32 result cast to bf16, as the Pallas
    wrapper does; equal to within one bf16 rounding of the f32 result."""
    rng = np.random.default_rng(11)
    img = jnp.asarray(rng.normal(size=(2, 16, 24, 1)), jnp.bfloat16)
    coords = rng.uniform(-1.2, 1.2, (2, 16, 24, 2)).astype(np.float32)
    want = bilinear_sample_pallas(img, jnp.asarray(coords), interpret=True)
    got = tgs.bilinear_sample(
        torch.from_numpy(np.array(img.astype(jnp.float32)))
        .to(torch.bfloat16), torch.from_numpy(coords))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2.0 ** -8,
                               atol=1e-6)


def test_border_corners_carry_both_weights():
    """Past the border both corners clamp onto one pixel, which carries
    both weights: the sample is that pixel's value."""
    img = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    x = torch.tensor([[-5.0, 3.7, 10.0, 1.25]])
    y = torch.tensor([[1.0, 2.6, -0.5, 0.5]])
    got = tgs.sample_pix_plain(img, x, y)
    np.testing.assert_allclose(got.numpy(),
                               [[4.0, 11.0, 3.0, 1.25 + 0.5 * 4]],
                               rtol=0, atol=1e-6)


def _loss_jax(img, theta, H, W):
    coords = jops.affine_grid(theta, H, W)
    out = bilinear_sample_pallas(img, coords, interpret=True)
    return jnp.sum(jnp.sin(out * 3.0))


def _loss_torch(img, theta, H, W):
    out = tops.grid_sample_affine(img, theta)
    return torch.sin(out * 3.0).sum()


@pytest.mark.parametrize("B,H,W", [(2, 16, 24), (2, 32, 256)])
def test_gradients_match_pallas_vjp(B, H, W):
    """d/d image and d/d theta through K12's plain version against
    jax.grad through the Pallas custom VJP (interpret mode)."""
    rng = np.random.default_rng(5 + W)
    img = rng.normal(size=(B, H, W, 1)).astype(np.float32)
    theta = _theta(rng, B, 0.1)
    gi_want, gt_want = jax.grad(_loss_jax, argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(theta), H, W)
    ti = torch.from_numpy(img).requires_grad_(True)
    tt = torch.from_numpy(theta).requires_grad_(True)
    n = tgs.bwd_launches
    _loss_torch(ti, tt, H, W).backward()
    assert tgs.bwd_launches == n
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi_want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_want),
                               rtol=1e-4, atol=1e-4)


def test_backward_pieces_match_pallas_bwd():
    """K12's three outputs (d_img, dx, dy), through the plain version,
    against the Pallas backward kernel's for one cotangent."""
    from crnn_ocr_tpu.kernels.grid_sample import _sample_pix_bwd

    rng = np.random.default_rng(9)
    B, H, W, N = 2, 16, 24, 16 * 24
    img = rng.normal(size=(B, H, W)).astype(np.float32)
    x = rng.uniform(-3, W + 2, (B, N)).astype(np.float32)
    y = rng.uniform(-3, H + 2, (B, N)).astype(np.float32)
    g = rng.normal(size=(B, N)).astype(np.float32)
    want = _sample_pix_bwd(True, (jnp.asarray(img), jnp.asarray(x),
                                  jnp.asarray(y)), jnp.asarray(g))
    got = tgs.sample_pix_bwd(*(torch.from_numpy(a) for a in (img, x, y, g)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_wrappers_check_their_operands():
    img = torch.zeros(2, 4, 5)
    x = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="float32"):
        tgs.sample_pix(img, x.double(), x)
    with pytest.raises(ValueError, match="shape"):
        tgs.sample_pix(img, x, torch.zeros(2, 6))
    with pytest.raises(ValueError, match="B, H, W"):
        tgs.sample_pix(img.int(), x, x)
    with pytest.raises(ValueError, match="B, H, W, C"):
        tgs.bilinear_sample(img, torch.zeros(2, 4, 5, 2))
