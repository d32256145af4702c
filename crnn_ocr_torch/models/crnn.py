"""CRNN text-line recognizer (``crnn_ocr_tpu/models/crnn.py``).

images (B, H, W) -> logits (B, T, C+1), in three stages that a caller may
also run one by one (``chip_smoke.py`` times them so):

* ``stem``: conv3x3 (1 -> stem_filters) + BatchNorm + ReLU + maxpool 2x2;
* ``backbone``: four depthwise-separable blocks (depthwise 3x3 and
  pointwise 1x1, both bias-free, BatchNorm eps 1e-3, ReLU, max-pool, then
  dropout in training), then the height axis collapses into the features;
* ``head``: ``time_dense`` + ReLU, per layer a ``BiRNN`` then a BatchNorm
  over (B, T), and the logits layer in f32.

``eval()`` is the serving path: the stem runs through the CUDA kernel K1
(``kernels.fused_stem``) with the BatchNorm folded to an affine of its
running statistics, every BatchNorm uses its running statistics, and the
recurrence runs K2. ``train()`` is flax's ``train=True``: every BatchNorm
normalizes with the batch's statistics and updates its running ones, and
dropout at ``cfg.dropout_rate`` follows each block's pool, drawn from the
``torch.Generator`` the caller passes. The training stem is plain PyTorch
(cuDNN conv, BatchNorm, ReLU, max-pool), as the JAX package's XLA branch
(``models/crnn.py:336-340``): the JAX package gates its fused train stem
off for buckets wider than 128 (``crnn.py:241-243``), so at the training
path's bucket 256 no TPU kernel runs there either. The train-stem kernels
K8-K10 (``kernels/fused_stem_train.py``) take over in the next slice.

Under ``dtype="bfloat16"`` weights and activations are cast as flax's
``dtype=bf16`` modules cast them: convolutions and dense layers take bf16
operands, BatchNorm computes in f32 and casts its result back. The STN
front end is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.kernels.fused_stem import fold_bn, fused_stem_serve
from crnn_ocr_torch.models.rnn import BiRNN

BN_EPS = 1e-3  # Keras BatchNormalization default
BN_MOMENTUM = 0.99  # Keras BatchNormalization default


class BatchNorm(nn.Module):
    """BatchNorm as ``flax.linen.BatchNorm`` computes it (momentum 0.99,
    eps 1e-3), normalizing the axis ``dim``: f32
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast back to x's
    dtype.

    In eval mode mean and var are the running statistics. In training mode
    they are the batch's, over every axis but ``dim``, computed in f32 as
    flax does (``E[x^2] - E[x]^2``, clipped at 0: the biased variance), and
    the running statistics move to ``0.99 * running + 0.01 * batch``.
    (``torch.nn.BatchNorm*`` differs: its momentum is the complement and its
    running variance is the unbiased one.)"""

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
        xf = x.float()
        if self.training:
            axes = [a for a in range(x.dim()) if a != self.dim % x.dim()]
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * mean.detach())
                self.running_var.mul_(BN_MOMENTUM).add_(
                    (1.0 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, the factor rounded to
    x's dtype first as JAX rounds a weak-typed scalar. The mask is drawn
    from ``generator``, which must live on x's device."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    scaled = x / torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros_like(x))


class DepthwiseSeparableBlock(nn.Module):
    """Depthwise 3x3 + pointwise 1x1 + BatchNorm + ReLU + max-pool (NCHW),
    then dropout in training."""

    def __init__(self, in_ch: int, filters: int, pool,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.pool = tuple(pool)
        self.dropout_rate = dropout_rate
        self.depthwise = nn.Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch,
                                   bias=False)
        self.pointwise = nn.Conv2d(in_ch, filters, 1, bias=False)
        self.bn = BatchNorm(filters, dim=1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.conv2d(x, self.depthwise.weight.to(x.dtype), padding=1,
                     groups=x.shape[1])
        x = F.conv2d(x, self.pointwise.weight.to(x.dtype))
        x = torch.relu(self.bn(x))
        if self.pool != (1, 1):
            x = F.max_pool2d(x, self.pool)
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("training with dropout needs a "
                                 "torch.Generator on the input's device")
            x = dropout(x, self.dropout_rate, generator)
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
        # NCHW for the training stem; serving folds it into K1's affine
        self.stem_bn = BatchNorm(cfg.stem_filters, dim=1)
        ch = cfg.stem_filters
        for i, (filters, pool) in enumerate(
            zip(cfg.block_filters, cfg.block_pools)
        ):
            self.add_module(f"block{i}", DepthwiseSeparableBlock(
                ch, filters, pool, cfg.dropout_rate))
            ch = filters
        h = cfg.height // 2
        for _, (ph, _) in zip(cfg.block_filters, cfg.block_pools):
            h //= ph
        self.time_dense = nn.Linear(h * ch, cfg.time_dense_size)
        feat = cfg.time_dense_size
        for i in range(cfg.rnn_layers):
            self.add_module(f"birnn{i}", BiRNN(feat, cfg.n_units,
                                               cfg.rnn_cell, self.dtype))
            self.add_module(f"rnn_bn{i}", BatchNorm(2 * cfg.n_units))
            feat = 2 * cfg.n_units
        self.logits = nn.Linear(feat, cfg.logits_dim)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W) -> (B, C, H/2, W/2): in eval mode the NCHW view of K1's
        NHWC output, in training mode plain PyTorch with batch statistics."""
        if self.training:
            x = F.conv2d(x.to(self.dtype)[:, None],
                         self.stem_conv.weight.to(self.dtype), padding=1)
            x = torch.relu(self.stem_bn(x))
            return F.max_pool2d(x, 2)
        x = x.to(self.dtype)[..., None]
        bn = self.stem_bn
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, BN_EPS)
        w = self.stem_conv.weight.permute(2, 3, 1, 0)  # (3, 3, 1, C)
        x = fused_stem_serve(x, w, scale, bias)
        return x.permute(0, 3, 1, 2)

    def backbone(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, H/2, W/2) -> (B, T, H' * C') features per frame."""
        for i in range(len(self.cfg.block_filters)):
            x = getattr(self, f"block{i}")(x, generator)
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

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the dropout stream, needed in training mode when
        ``cfg.dropout_rate > 0``."""
        return self.head(self.backbone(self.stem(x), generator))
