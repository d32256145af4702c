"""Affine grid and warp: the STN's sampling path (``crnn_ocr_tpu/ops/
grid_sample.py``).

Normalized coordinates in [-1, 1] map to the pixel centres [0, size - 1]
(torch's ``align_corners=True``); samples outside clamp to the border. The
JAX package's banded sampler and its gate (``:109-265``) work around TPU
shapes; here ``grid_sample_affine`` builds the grid, at the image's size
or another, and hands it to ``kernels.grid_sample.bilinear_sample`` (this
module's ``bilinear_sample``), which runs K11 forward and K12 backward on a
CUDA tensor and the plain versions on a CPU tensor, an image of C channels
as B * C one-channel images.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from crnn_ocr_torch.kernels.grid_sample import bilinear_sample


def _linspace(n: int) -> np.ndarray:
    """``jnp.linspace(-1, 1, n, dtype=float32)`` bit for bit, as XLA computes
    it on the CPU: ``step = i * f32(1 / (n - 1))``, then ``-1 * (1 - step) +
    1 * step`` with the last product fused into the add (one rounding), then
    the end point 1. The fused step is exact in float64 here (the operands
    have 24-bit significands), so one cast to float32 rounds it once.
    ``torch.linspace`` differs from it by an ulp at many points, and an ulp
    at an integer pixel position flips ``floor``. Bit for bit for n up to
    352, which covers every height and width of the bundled models; above
    that XLA's vectorized loop fuses ``1 - step`` too, and the two differ by
    an ulp at some points."""
    if n == 1:
        return np.full(1, -1.0, np.float32)
    div = n - 1
    i = np.arange(div, dtype=np.float32)
    r = np.float32(1.0) / np.float32(div)
    sub = np.float32(1.0) - i * r
    fused = i.astype(np.float64) * np.float64(r) - sub.astype(np.float64)
    return np.append(fused.astype(np.float32), np.float32(1.0))


@functools.lru_cache(maxsize=None)
def _base_grid(height: int, width: int, device: torch.device):
    """The base grid (gx, gy), each (height, width) f32, on ``device``. Made
    once per shape and device: a copy from host memory blocks the host until
    the stream is idle, and a forward pass would make two. Made outside
    inference mode, so that a grid first built while serving can still
    enter a training graph."""
    with torch.inference_mode(False):
        ys = torch.from_numpy(_linspace(height)).to(device)
        xs = torch.from_numpy(_linspace(width)).to(device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


def affine_grid(theta: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """theta (B, 6) or (B, 2, 3) (identity ``[1, 0, 0, 0, 1, 0]``) ->
    sampling coordinates (B, height, width, 2) f32, (x, y) normalized.

    The affine is broadcast arithmetic in f32, not a matrix product: under
    TF32 a product would shift the coordinates (``:36-38``)."""
    B = theta.shape[0]
    t = theta.reshape(B, 2, 3).float()[:, :, :, None, None]
    gx, gy = _base_grid(height, width, theta.device)
    src_x = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
    src_y = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    return torch.stack([src_x, src_y], dim=-1)


def grid_sample_affine(img: torch.Tensor, theta: torch.Tensor,
                       out_height: Optional[int] = None,
                       out_width: Optional[int] = None) -> torch.Tensor:
    """Warp ``img`` (B, H, W, C) by ``theta`` (B, 6) -> (B, out_height,
    out_width, C) in the image's dtype; the output size defaults to the
    image's."""
    _, H, W, _ = img.shape
    coords = affine_grid(theta, out_height or H, out_width or W)
    return bilinear_sample(img, coords)
