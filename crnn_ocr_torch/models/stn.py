"""Spatial transformer front end (``crnn_ocr_tpu/models/stn.py``).

A localization net predicts an affine ``theta`` per image, and the image is
warped by it at its own size:

* max-pool 2x2 on the input;
* per filter count (``loc_filters``, 16 then 32 by default): a 5x5
  ``SAME`` convolution with bias, ReLU, max-pool 2x2;
* flatten, Dense ``loc_dense`` (50) with ReLU, Dense 6 (``theta``; flax
  initializes its kernel to zero and its bias to the identity ``[1, 0, 0,
  0, 1, 0]``);
* the warp: ``ops.grid_sample.grid_sample_affine`` (K11 forward, K12
  backward on the card).

The forward's two halves are the program's spans ``crnn.stn.localize`` and
``crnn.stn.warp`` (``utils/profiling.py::span``); K12's backward is the
``grid_sample_backward`` span (``kernels/grid_sample.py``).

flax flattens NHWC, so the NCHW activation is permuted to NHWC before the
flatten: the first Dense reads its ``(H / 8) * (W / 8) * loc_filters[-1]``
inputs in flax's order, and is bound to the image size the model was built
for.

Under a bf16 model the localization net computes in bf16 as flax's
``dtype=bf16`` modules do (bf16 operands, the bias added after the product
and rounded), ``affine_grid`` widens ``theta`` to f32, and the sampler
reads the bf16 image as f32 and returns its f32 result cast to bf16.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from crnn_ocr_torch.ops.grid_sample import grid_sample_affine
from crnn_ocr_torch.utils.profiling import span

IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class STN(nn.Module):
    """images (B, H, W) in the compute dtype -> warped (B, H, W), same
    dtype. ``loc_filters`` (the localization convolutions' widths) and
    ``loc_dense`` (its hidden Dense's) are the JAX module's attributes,
    with its defaults."""

    def __init__(self, height: int, width: int, dtype=torch.float32,
                 loc_filters: Sequence[int] = (16, 32), loc_dense: int = 50):
        super().__init__()
        self.size = (height, width)
        self.dtype = dtype
        self.convs = nn.ModuleList()
        ch, h, w = 1, height // 2, width // 2
        for filters in loc_filters:
            self.convs.append(nn.Conv2d(ch, filters, 5, padding=2))
            ch, h, w = filters, h // 2, w // 2
        self.dense = nn.Linear(h * w * ch, loc_dense)
        self.theta = nn.Linear(loc_dense, 6)

    def _affine(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x, layer.weight.to(dt)) + layer.bias.to(dt)

    def localize(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> theta (B, 6) in the compute dtype."""
        if tuple(x.shape[1:]) != self.size:
            raise ValueError(
                f"the STN was built for {self.size[0]}x{self.size[1]} images "
                f"(its localization Dense is bound to that size), got "
                f"{tuple(x.shape[1:])}")
        dt = self.dtype
        h = F.max_pool2d(x[:, None], 2)
        for conv in self.convs:
            h = F.conv2d(h, conv.weight.to(dt), padding=2) \
                + conv.bias.to(dt)[:, None, None]
            h = F.max_pool2d(torch.relu(h), 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten
        h = torch.relu(self._affine(self.dense, h))
        return self._affine(self.theta, h)

    @staticmethod
    def warp(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """(B, H, W) warped by theta (B, 6) -> (B, H, W), same dtype."""
        return grid_sample_affine(x[..., None], theta)[..., 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("crnn.stn.localize"):
            theta = self.localize(x)
        with span("crnn.stn.warp"):
            return self.warp(x, theta)
