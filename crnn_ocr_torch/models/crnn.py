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
recurrence runs K2 (K4 for an LSTM). ``train()`` is flax's ``train=True``:
every BatchNorm normalizes with the batch's statistics and updates its
running ones, the recurrence runs K3 (K5 for an LSTM), and dropout at ``cfg.dropout_rate`` follows each block's pool, drawn from the
``torch.Generator`` the caller passes. The training stem runs
``kernels.fused_stem_train`` (``crnn.py:297-316``): K8's batch statistics
feed K1, and K9 and K10 give its backward; ``stem_bn``'s running
statistics move toward K8's mean and unclamped variance, as
``_StemBNState`` moves them (``crnn.py:166-196``). The JAX package gates
that path on at B >= 128 and W <= 128 (``crnn.py:241-243``), a gate timed
on the TPU; the port has no shape gate, as its serving stem has none.

Under ``dtype="bfloat16"`` weights and activations are cast as flax's
``dtype=bf16`` modules cast them: convolutions and dense layers take bf16
operands, BatchNorm computes in f32 and casts its result back.

With ``cfg.use_stn`` the image, cast to the compute dtype, first goes
through the ``STN`` (``models/stn.py``; ``crnn.py:272-276``), in both
modes: serving then runs K1 on the warped image, and training runs the
plain stem (cuDNN conv, BatchNorm, ReLU, max-pool), whose convolution
passes the gradient on to the warped image and through K12 to ``theta``
(the JAX package gates its fused train stem off for STN models,
``crnn.py:231-232``, because K10 returns no image gradient).

Data parallelism (``crnn.py:258-270, 292-296``): ``CRNN.mesh``, a process
mesh of ``parallel/mesh.py`` (JAX: ``build_model(cfg, mesh)``), makes every
training BatchNorm take global-batch moments (sync-BN): each sums its
rows, the sums are all-reduced through the autograd ``all_reduce``, and the
running statistics move by the global moments, alike on every rank; the
fused training stem all-reduces K8's and K9's sums. Dropout then draws the
global batch's mask from the step's generator and keeps the rank's rows,
so DP with dropout equals one device with dropout. A ``valid_mask`` (the
pad rows of ``parallel.mesh.pad_batch_to``) makes the training BatchNorms
take flax's masked moments over the valid rows, and the training stem then
runs the plain conv, masked BatchNorm, ReLU and max-pool (K8 sums every
row: JAX's ``fused_ok = bn_mask4 is None and ...``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from crnn_ocr_torch.config import ModelConfig
from crnn_ocr_torch.kernels.fused_stem import fold_bn, fused_stem_serve
from crnn_ocr_torch.kernels.fused_stem_train import fused_stem_train
from crnn_ocr_torch.models.rnn import BiRNN
from crnn_ocr_torch.models.stn import STN
from crnn_ocr_torch.parallel.mesh import Mesh, all_reduce, is_dp

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
    running variance is the unbiased one.)

    In training, a row ``mask`` (B,) (1: a real row) gives flax's masked
    moments: ``sum m*x``, ``sum m*x^2`` and the count of unmasked
    elements; a process ``mesh`` all-reduces those sums (through the
    autograd ``all_reduce``) before ``E[x^2] - E[x]^2``, clipped at 0, so
    every rank normalizes by, and moves its running statistics toward,
    the global batch's moments."""

    def __init__(self, features: int, dim: int = -1):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.dim] = -1
        xf = x.float()
        if self.training:
            axes = [a for a in range(x.dim()) if a != self.dim % x.dim()]
            if mask is None and not is_dp(mesh):
                mean = xf.mean(dim=axes)
                var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                                  min=0.0)
            else:
                mean, var = self.moments(xf, axes, mask, mesh)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)

    def moments(self, xf: torch.Tensor, axes, mask: Optional[torch.Tensor],
                mesh: Optional[Mesh]):
        """The f32 batch (mean, var) over ``axes`` (every axis but ``dim``)
        of the rows ``mask`` keeps (all rows without one), summed over a
        process mesh's ranks."""
        C = xf.shape[self.dim]
        per_row = xf[0].numel() // C  # elements of a channel in one row
        if mask is None:
            xm = xf
            count = torch.full((1,), float(xf.shape[0] * per_row),
                               device=xf.device)
        else:
            xm = xf * mask.float().reshape([-1] + [1] * (xf.dim() - 1))
            count = mask.float().sum().reshape(1) * per_row
        sums = all_reduce(torch.cat([xm.sum(dim=axes),
                                     (xm * xf).sum(dim=axes), count]), mesh)
        mean = sums[:C] / sums[2 * C]
        var = torch.clamp(sums[C:2 * C] / sums[2 * C] - mean * mean, min=0.0)
        return mean, var

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = 0.99 * running + 0.01 * batch``, as flax moves
        them."""
        self.running_mean.mul_(BN_MOMENTUM).add_(
            (1.0 - BN_MOMENTUM) * mean.detach())
        self.running_var.mul_(BN_MOMENTUM).add_(
            (1.0 - BN_MOMENTUM) * var.detach())


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, the factor rounded to
    x's dtype first as JAX rounds a weak-typed scalar. The mask is drawn
    from ``generator``, which must live on x's device. On a process mesh
    the mask of the global batch is drawn (Philox's numbers depend on the
    shape drawn) and the rank keeps its rows, as JAX draws over the global
    shape."""
    keep_prob = 1.0 - rate
    if is_dp(mesh):
        shape = (x.shape[0] * mesh.world,) + tuple(x.shape[1:])
        u = torch.rand(shape, generator=generator, device=x.device)
        keep = u[mesh.rows(shape[0])] < keep_prob
    else:
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
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        x = F.conv2d(x, self.depthwise.weight.to(x.dtype), padding=1,
                     groups=x.shape[1])
        x = F.conv2d(x, self.pointwise.weight.to(x.dtype))
        x = torch.relu(self.bn(x, mask, mesh))
        if self.pool != (1, 1):
            x = F.max_pool2d(x, self.pool)
        if self.training and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("training with dropout needs a "
                                 "torch.Generator on the input's device")
            x = dropout(x, self.dropout_rate, generator, mesh)
        return x


class CRNN(nn.Module):
    """images (B, H, W) -> logits (B, T, num_classes + 1), f32."""

    def __init__(self, cfg: ModelConfig, mesh: Optional[Mesh] = None):
        super().__init__()
        self.cfg = cfg
        # a process mesh: sync-BN and the global dropout draw in training
        self.mesh = mesh
        self.dtype = {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[cfg.dtype]
        self.stn = (STN(cfg.height, cfg.width, self.dtype) if cfg.use_stn
                    else None)
        self.stem_conv = nn.Conv2d(1, cfg.stem_filters, 3, padding=1,
                                   bias=False)
        # NCHW for an STN model's training stem; otherwise its statistics
        # feed K1 (running, folded) or come from K8 (training)
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

    def stem(self, x: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, W) -> (B, C, H/2, W/2), the NCHW view of the NHWC output
        of K1 (eval) or of ``fused_stem_train`` (training); an STN model's
        training stem, and any training stem under a row ``mask``, is
        plain PyTorch with (masked) batch statistics."""
        bn = self.stem_bn
        if self.training and (self.stn is not None or mask is not None):
            x = F.conv2d(x.to(self.dtype)[:, None],
                         self.stem_conv.weight.to(self.dtype), padding=1)
            x = torch.relu(bn(x, mask, self.mesh))
            return F.max_pool2d(x, 2)
        x = x.to(self.dtype)[..., None]
        w = self.stem_conv.weight.permute(2, 3, 1, 0)  # (3, 3, 1, C)
        if self.training:
            x, mean, var = fused_stem_train(x, w, bn.weight, bn.bias, BN_EPS,
                                            self.mesh)
            bn.update_running(mean, var)
        else:
            scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var, BN_EPS)
            x = fused_stem_serve(x, w, scale, bias)
        return x.permute(0, 3, 1, 2)

    def backbone(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, H/2, W/2) -> (B, T, H' * C') features per frame."""
        for i in range(len(self.cfg.block_filters)):
            x = getattr(self, f"block{i}")(x, generator, mask, self.mesh)
        B, C, Hp, T = x.shape
        # (B, C, H', T) -> (B, T, H', C) -> (B, T, H' * C), as the JAX
        # package collapses its NHWC (B, H', T, C)
        return x.permute(0, 3, 2, 1).reshape(B, T, Hp * C)

    def frame_features(self, x: torch.Tensor) -> torch.Tensor:
        """``time_dense`` + ReLU: the first BiRNN's input."""
        td = self.time_dense
        return torch.relu(F.linear(x, td.weight.to(self.dtype),
                                   td.bias.to(self.dtype)))

    def head(self, x: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, F) -> f32 logits (B, T, num_classes + 1)."""
        x = self.frame_features(x)
        for i in range(self.cfg.rnn_layers):
            x = getattr(self, f"birnn{i}")(x)
            x = getattr(self, f"rnn_bn{i}")(x, mask, self.mesh)
        return F.linear(x.float(), self.logits.weight, self.logits.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``generator``: the dropout stream, needed in training mode when
        ``cfg.dropout_rate > 0``. ``valid_mask`` (B,): the real rows of a
        padded batch, which alone give the training BatchNorms' moments
        (ignored in eval mode)."""
        mask = valid_mask if self.training else None
        if self.stn is not None:
            x = self.stn(x.to(self.dtype))
        return self.head(self.backbone(self.stem(x, mask), generator, mask),
                         mask)


def build_model(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                device=None) -> CRNN:
    """``CRNN(cfg, mesh)`` on ``device`` (``crnn_ocr_tpu/models/crnn.py:
    380``): by default the mesh's device, else ``cuda``; the CPU only where
    the caller passes it. Its weights are torch's initial ones:
    ``train.state.init_weights`` draws flax's, a state_dict loads
    trained ones."""
    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    return CRNN(cfg, mesh).to(device)
