"""Port parity: crnn_ocr_torch.ops.preprocess against crnn_ocr_tpu's.

Inputs come from a numpy seed and go through both packages as numpy
arrays. The resize weights must equal those of jax's
``compute_weight_mat`` (atol 1e-7, f32 rounding of the same formula).
The resized frames are held to the exact float64 product of those weights
at atol 1e-5 (in /255 units), and to the JAX package at atol 1e-4 after
standardization: XLA's CPU einsum itself strays from the exact product by
up to 3.6e-3 grey levels on these noise images (measured; the port by
1.5e-5), which standardization by a std of about 0.3 turns into ~5e-5.
``pack_canvas``, ``quantize_dim`` and the content widths are integer
results and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from crnn_ocr_torch.ops import preprocess as tp
from crnn_ocr_tpu.ops import preprocess as jp


def _ragged(rng, n, h_range, w_range, color=False):
    out = []
    for _ in range(n):
        h = int(rng.integers(*h_range))
        w = int(rng.integers(*w_range))
        shape = (h, w, 3) if color else (h, w)
        out.append(rng.integers(0, 256, shape).astype(np.uint8))
    return out


# (seed, n, heights, widths, bucket, quantize, normalize): widths that
# clamp to the bucket (w * 32 / h > bucket), upsampled and downsampled
# heights, and quantized canvases
CASES = [
    (0, 5, (20, 60), (30, 200), 128, False, True),
    (1, 6, (10, 40), (100, 400), 64, True, True),  # clamps to the bucket
    (2, 4, (32, 33), (50, 300), 256, True, False),  # identity height
    (3, 7, (40, 90), (20, 500), 192, True, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_preprocess_batch_matches_jax(case):
    seed, n, hr, wr, bucket, quantize, normalize = case
    rng = np.random.default_rng(seed)
    images = _ragged(rng, n, hr, wr)
    canvas, hs, ws = jp.pack_canvas(images, quantize=quantize)
    want_x, want_w = jp.preprocess_batch(
        canvas, hs, ws, out_h=32, out_w=bucket, normalize=normalize)
    got_x, got_w = tp.preprocess_batch(
        torch.from_numpy(canvas), torch.from_numpy(hs), torch.from_numpy(ws),
        out_h=32, out_w=bucket, normalize=normalize)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert got_x.dtype == torch.float32
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_resize_matches_float64_product(case):
    seed, n, hr, wr, bucket, quantize, _ = case
    rng = np.random.default_rng(seed)
    canvas, hs, ws = tp.pack_canvas(_ragged(rng, n, hr, wr), quantize)
    got, w_new = tp.preprocess_batch(
        torch.from_numpy(canvas), torch.from_numpy(hs), torch.from_numpy(ws),
        out_h=32, out_w=bucket, normalize=False)
    for i in range(n):
        wy = tp._linear_weights(canvas.shape[1], 32, 32 / torch.tensor(
            [hs[i]], dtype=torch.float32))[0].double().numpy()
        wx = tp._linear_weights(canvas.shape[2], bucket, w_new[i:i + 1].float()
                                / float(ws[i]))[0].double().numpy()
        want = wy @ canvas[i].astype(np.float64) @ wx.T / 255.0
        k = int(w_new[i])
        np.testing.assert_allclose(got[i, :, :k].numpy(), want[:, :k],
                                   rtol=0, atol=1e-5)
        assert (got[i, :, k:] == 1.0).all()  # white beyond the content


@pytest.mark.parametrize("in_size,out_size,scale", [
    (48, 32, 32 / 45), (40, 32, 32 / 17), (384, 256, 200 / 371),
    (300, 64, 64 / 300), (64, 128, 1.0),
])
def test_sampling_weights_equal_jax(in_size, out_size, scale):
    s = np.float32(scale)
    want = jax_scale.compute_weight_mat(
        in_size, out_size, jnp.float32(s), jnp.float32(0.0),
        jax_scale._fill_triangle_kernel, False)
    got = tp._linear_weights(in_size, out_size,
                             torch.tensor([s], dtype=torch.float32))[0]
    np.testing.assert_allclose(got.numpy().T, np.asarray(want), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("color", [False, True])
def test_pack_canvas_matches_jax(quantize, color):
    rng = np.random.default_rng(10 + 2 * quantize + color)
    images = _ragged(rng, 5, (8, 70), (8, 300), color=color)
    got = tp.pack_canvas(images, quantize=quantize)
    want = jp.pack_canvas(images, quantize=quantize)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_quantize_dim_matches_jax():
    for base in (8, 16):
        got = [tp.quantize_dim(n, base) for n in range(1, 3000)]
        want = [jp.quantize_dim(n, base) for n in range(1, 3000)]
        assert got == want


def test_content_width_rounds_half_to_even():
    """w * 32 / h landing on .5 rounds to even, as jnp.round does."""
    hs = np.array([64, 64, 64, 64], np.int32)
    ws = np.array([5, 7, 9, 11], np.int32)  # w/2 = 2.5, 3.5, 4.5, 5.5
    canvas = np.full((4, 64, 16), 255, np.uint8)
    _, got = tp.preprocess_batch(torch.from_numpy(canvas),
                                 torch.from_numpy(hs), torch.from_numpy(ws))
    _, want = jp.preprocess_batch(canvas, hs, ws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [2, 4, 4, 6]
