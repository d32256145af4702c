"""CRNN text-line recognizer, inference mode (``crnn_ocr_tpu/models/crnn.py``).

images (B, H, W) -> logits (B, T, C+1), in three stages that a caller may
also run one by one (``chip_smoke.py`` times them so):

* ``stem``: conv3x3 (1 -> stem_filters) + BatchNorm + ReLU + maxpool 2x2,
  through ``kernels.fused_stem`` with the BatchNorm folded to an affine;
* ``backbone``: four depthwise-separable blocks (depthwise 3x3 and
  pointwise 1x1, both bias-free, BatchNorm eps 1e-3, ReLU, max-pool), then
  the height axis collapses into the features;
* ``head``: ``time_dense`` + ReLU, per layer a ``BiRNN`` then a BatchNorm
  over (B, T), and the logits layer in f32.

Under ``dtype="bfloat16"`` weights and activations are cast as flax's
``dtype=bf16`` modules cast them: convolutions and dense layers take bf16
operands, BatchNorm computes in f32 and casts its result back. Dropout is a
no-op in inference and is not built. The STN front end is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.kernels.fused_stem import fold_bn, fused_stem_serve
from crnn_ocr_torch.models.rnn import BiRNN

BN_EPS = 1e-3  # Keras BatchNormalization default


class FrozenBatchNorm(nn.Module):
    """BatchNorm with running statistics, as flax computes it: f32
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast back to x's
    dtype. Normalizes the axis ``dim``."""

    def __init__(self, features: int, dim: int = -1):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.dim] = -1
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class DepthwiseSeparableBlock(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 + BatchNorm + ReLU + max-pool (NCHW)."""

    def __init__(self, in_ch: int, filters: int, pool):
        super().__init__()
        self.pool = tuple(pool)
        self.depthwise = nn.Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch,
                                   bias=False)
        self.pointwise = nn.Conv2d(in_ch, filters, 1, bias=False)
        self.bn = FrozenBatchNorm(filters, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.depthwise.weight.to(x.dtype), padding=1,
                     groups=x.shape[1])
        x = F.conv2d(x, self.pointwise.weight.to(x.dtype))
        x = torch.relu(self.bn(x))
        if self.pool != (1, 1):
            x = F.max_pool2d(x, self.pool)
        return x


class CRNN(nn.Module):
    """images (B, H, W) -> logits (B, T, num_classes + 1), f32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.use_stn:
            raise NotImplementedError(
                "use_stn: the STN front end is not ported yet"
            )
        self.cfg = cfg
        self.dtype = {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[cfg.dtype]
        self.stem_conv = nn.Conv2d(1, cfg.stem_filters, 3, padding=1,
                                   bias=False)
        self.stem_bn = FrozenBatchNorm(cfg.stem_filters)
        ch = cfg.stem_filters
        for i, (filters, pool) in enumerate(
            zip(cfg.block_filters, cfg.block_pools)
        ):
            self.add_module(f"block{i}",
                            DepthwiseSeparableBlock(ch, filters, pool))
            ch = filters
        h = cfg.height // 2
        for _, (ph, _) in zip(cfg.block_filters, cfg.block_pools):
            h //= ph
        self.time_dense = nn.Linear(h * ch, cfg.time_dense_size)
        feat = cfg.time_dense_size
        for i in range(cfg.rnn_layers):
            self.add_module(f"birnn{i}", BiRNN(feat, cfg.n_units,
                                               cfg.rnn_cell, self.dtype))
            self.add_module(f"rnn_bn{i}", FrozenBatchNorm(2 * cfg.n_units))
            feat = 2 * cfg.n_units
        self.logits = nn.Linear(feat, cfg.logits_dim)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> (B, C, H/2, W/2), NCHW view of the kernel's NHWC."""
        x = x.to(self.dtype)[..., None]
        bn = self.stem_bn
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, BN_EPS)
        w = self.stem_conv.weight.permute(2, 3, 1, 0)  # (3, 3, 1, C)
        x = fused_stem_serve(x, w, scale, bias)
        return x.permute(0, 3, 1, 2)

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H/2, W/2) -> (B, T, H' * C') features per frame."""
        for i in range(len(self.cfg.block_filters)):
            x = getattr(self, f"block{i}")(x)
        B, C, Hp, T = x.shape
        # (B, C, H', T) -> (B, T, H', C) -> (B, T, H' * C), as the JAX
        # package collapses its NHWC (B, H', T, C)
        return x.permute(0, 3, 2, 1).reshape(B, T, Hp * C)

    def frame_features(self, x: torch.Tensor) -> torch.Tensor:
        """``time_dense`` + ReLU: the first BiRNN's input."""
        td = self.time_dense
        return torch.relu(F.linear(x, td.weight.to(self.dtype),
                                   td.bias.to(self.dtype)))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, F) -> f32 logits (B, T, num_classes + 1)."""
        x = self.frame_features(x)
        for i in range(self.cfg.rnn_layers):
            x = getattr(self, f"birnn{i}")(x)
            x = getattr(self, f"rnn_bn{i}")(x)
        return F.linear(x.float(), self.logits.weight, self.logits.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(self.stem(x)))
