"""Batch preprocessing: resize to height, pad to the bucket, standardize.

Port of ``crnn_ocr_tpu/ops/preprocess.py`` (``preprocess_batch``,
``preprocess_resident``, ``preprocess_host``, ``quantize_dim``,
``pack_canvas``). The JAX
package resizes with
``jax.image.scale_and_translate(method="linear", antialias=False)`` and a
per-image scale; here each image gets its own sampling matrices
``Wy (out_h, Hmax)`` and ``Wx (out_w, Wmax)``, built with that function's
weights, and the resize is the batched product ``Wy @ img @ Wx^T``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

WHITE = 255.0
NORM_EPSILON = 1e-7
_F32_EPS = float(np.finfo(np.float32).eps)


def _linear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                    antialias: bool = False):
    """(B, out_size, in_size) sampling weights of one axis, as jax 0.9's
    ``jax/_src/image/scale.py::compute_weight_mat`` builds them for a
    triangle kernel and zero translation; with ``antialias`` a downscale
    widens the triangle by the inverse scale."""
    f32 = dict(dtype=torch.float32, device=scale.device)
    inv = (1.0 / scale)[:, None]  # (B, 1)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv - 0.5  # (B, out)
    x = (sample_f[:, :, None] - torch.arange(in_size, **f32)).abs()
    if antialias:
        x = x / torch.clamp(inv, min=1.0)[:, :, None]
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=2, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], w, torch.zeros_like(w))


def preprocess_batch(
    images: torch.Tensor,
    heights: torch.Tensor,
    widths: torch.Tensor,
    out_h: int = 32,
    out_w: int = 128,
    normalize: bool = True,
    antialias: bool = False,
):
    """Resize-to-height + pad-to-bucket + normalize a white-padded canvas.

    Args:
      images: (B, Hmax, Wmax) uint8 or float canvas, white beyond each
        image's true (h, w).
      heights, widths: (B,) true image sizes.
      antialias: antialiased resampling (cv2 parity wants False).

    Returns:
      (x, content_widths): (B, out_h, out_w) float32 frames and (B,) int32
      content widths ``min(round(w * out_h / h), out_w)``.
    """
    B, Hm, Wm = images.shape
    h = heights.to(device=images.device, dtype=torch.float32)
    w = widths.to(device=images.device, dtype=torch.float32)
    # round half to even, as jnp.round; wider images squash to the bucket
    w_new = torch.clamp(torch.round(w * out_h / h), max=float(out_w))
    wy = _linear_weights(Hm, out_h, out_h / h, antialias)  # (B, out_h, Hm)
    wx = _linear_weights(Wm, out_w, w_new / w, antialias)  # (B, out_w, Wm)
    scaled = wy @ images.float() @ wx.transpose(1, 2)
    cols = torch.arange(out_w, dtype=torch.float32, device=images.device)
    frames = torch.where(cols[None, None, :] < w_new[:, None, None], scaled,
                         torch.full_like(scaled, WHITE))
    x = frames / 255.0
    if normalize:
        mean = x.mean(dim=(1, 2), keepdim=True)
        std = x.std(dim=(1, 2), keepdim=True, correction=0)  # jnp.std
        x = (x - mean) / (std + NORM_EPSILON)
    return x, w_new.to(torch.int32)


def preprocess_resident(images: torch.Tensor, widths: torch.Tensor,
                        normalize: bool = True):
    """``preprocess_batch`` of rows that are already height-normalized and
    white-padded to the bucket (the device corpus's packed rows,
    ``data/device_cache.py``), where the resample is an identity: /255 and,
    with ``normalize``, the per-image standardization. Within a few ulps of
    ``preprocess_batch(rows, out_h, widths, out_h, bucket)``, whose identity
    resample still rounds in f32. Returns (x, content widths int32)."""
    x = images.float() / 255.0
    if normalize:
        mean = x.mean(dim=(1, 2), keepdim=True)
        std = x.std(dim=(1, 2), keepdim=True, correction=0)  # jnp.std
        x = (x - mean) / (std + NORM_EPSILON)
    return x, widths.to(torch.int32)


def preprocess_host(img: np.ndarray, out_h: int = 32, out_w: int = 128,
                    normalize: bool = True) -> np.ndarray:
    """One image on the host with cv2 (``crnn_ocr_tpu/ops/preprocess.py:
    123``, the reference's ``utils.py#norm`` and its padding): gray, resized
    to ``out_h`` with ``cv2.INTER_LINEAR`` keeping the aspect (width capped
    at ``out_w``), white-padded to ``out_w``, /255 and, with ``normalize``,
    standardized. Returns (out_h, out_w) float32; the oracle of tests."""
    import cv2

    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    h, w = img.shape
    w_new = min(max(1, int(round(w * out_h / h))), out_w)
    resized = cv2.resize(img, (w_new, out_h), interpolation=cv2.INTER_LINEAR)
    canvas = np.full((out_h, out_w), WHITE, np.float32)
    canvas[:, :w_new] = resized
    x = canvas / 255.0
    if normalize:
        x = (x - x.mean()) / (x.std() + NORM_EPSILON)
    return x


def quantize_dim(n: int, base: int = 16) -> int:
    """Snap ``n`` up the ladder {base, 1.5*base, 2*base, 3*base, 4*base,
    ...}: powers of two of ``base`` and their 1.5x midpoints."""
    q = base
    while q < n:
        q = q * 3 // 2 if (q & (q - 1)) == 0 else q * 4 // 3
    return q


def pack_canvas(images: "List[np.ndarray]", quantize: bool = False) -> tuple:
    """Stack variable-size grayscale images into a white-padded uint8 canvas.

    Accepts (H, W) grayscale or (H, W, 3/4) colour arrays (converted with
    the luma weights in cv2's BGR order). ``quantize`` snaps the canvas dims
    up the ``quantize_dim`` ladder.

    Returns (canvas (B, Hmax, Wmax) uint8, heights (B,), widths (B,)).
    """
    if not images:
        raise ValueError("pack_canvas: empty image list")
    grays = []
    for im in images:
        im = np.asarray(im)
        if im.ndim == 3:
            rgb = im[..., :3].astype(np.float32)
            im = (
                0.114 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.299 * rgb[..., 2]
            ).round()
        if im.ndim != 2:
            raise ValueError(f"expected 2D/3D image, got shape {im.shape}")
        grays.append(np.clip(im, 0, 255).astype(np.uint8))
    heights = np.array([im.shape[0] for im in grays], np.int32)
    widths = np.array([im.shape[1] for im in grays], np.int32)
    Hm, Wm = int(heights.max()), int(widths.max())
    if quantize:
        Hm, Wm = quantize_dim(Hm), quantize_dim(Wm)
    canvas = np.full((len(grays), Hm, Wm), 255, np.uint8)
    for i, im in enumerate(grays):
        canvas[i, : im.shape[0], : im.shape[1]] = im
    return canvas, heights, widths
