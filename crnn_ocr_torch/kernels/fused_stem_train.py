"""Training stem: conv3x3 (1 -> C) + batch-statistics BatchNorm + ReLU +
maxpool 2x2, forward and backward, without the full-resolution activation
in device memory.

Replaces ``crnn_ocr_tpu/kernels/fused_stem_train.py``: ``_run_stats`` (:290,
K8), ``_run_bwd_partials`` (:309, K9) and ``_run_bwd_final`` (:333, K10),
behind ``fused_stem_train`` (:359). The CUDA kernels are in
``csrc/fused_stem.cu`` beside K1 (its header has the designs and the H100
bounds): K8 computes z on the tensor cores (the window tile it shares with
K1's bf16 serving call), K9 and K10 recompute it with K1's training call's
conv function, bit for bit alike, since they route by it;
``stem_stats_plain``, ``stem_bwd_partials_plain`` and
``stem_bwd_final_plain`` are the same functions in plain PyTorch.

The four passes, as the JAX module runs them:

* forward: K8 gives per-channel ``sum z`` and ``sum z^2`` of the conv output
  z over (B, H, W); ``mean = sum z / n`` and ``var = sum z^2 / n - mean^2``
  (not clamped, ``:392-393``); then K1 (on its ``conv9`` design, whose z
  K9 and K10 recompute bit for bit) with ``fold_bn(gamma, beta, mean,
  var)`` writes the pooled output;
* backward (``_bwd``, :402-440): ``inv = rsqrt(var + eps)``, the folded
  ``scale = gamma * inv``, ``bias = beta - mean * inv * gamma``; K9 routes
  the pooled gradient to the first maximum of each 2x2 window in (h, w)
  order, only where that activation is > 0, and sums ``d`` and
  ``d * xhat`` per channel (``xhat = (z - mean) * inv``); ``c1 = gamma *
  inv``, ``c2 = sum d / n``, ``c3 = sum d * xhat / n``; K10 spreads
  ``d_conv = c1 * (d - c2 - xhat * c3)`` over every position and sums
  ``d_w[kh, kw, c] = sum tap * d_conv``. ``d_gamma = sum d * xhat`` and
  ``d_beta = sum d``.

No image gradient is computed (the JAX kernel returns zeros), so
``fused_stem_train`` refuses an image that requires one: the port runs it
only where the image is a gradient leaf (non-STN training).

Layouts are the JAX package's: the image NHWC ``(B, H, W, 1)``, the conv
kernel HWIO ``(3, 3, 1, C)``, the pooled output NHWC. The image's dtype sets
the mode: bf16 rounds the image and the conv weights to bf16 and keeps
products, sums and all BatchNorm math in f32 (the TPU kernels' rounding
points); f32 is f32 throughout. The pooled gradient comes in the pooled
output's dtype and is read as it comes.

Each wrapper dispatches on the image's device and on nothing else: a CPU
tensor goes through the plain version, a CUDA tensor through the kernel,
or the call raises.

Sync-BN on a process mesh (``parallel/mesh.py``; JAX ``:390-391, 426``):
between the launches, the forward all-reduces K8's sums and counts every
rank's positions in ``n``, and the backward all-reduces K9's partials into
the global ``c2`` and ``c3`` that K10 reads. ``d_gamma`` and ``d_beta``
stay the rank's own sums: the train step's gradient sum adds them. The
kernels do not change; the plain versions on the CPU get the same
reductions, so the CPU path is the same math.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from crnn_ocr_torch.kernels import _stem_tiles as tiles
from crnn_ocr_torch.kernels import fused_stem
from crnn_ocr_torch.kernels.fused_stem import fold_bn
from crnn_ocr_torch.parallel.mesh import all_reduce_, is_dp
from crnn_ocr_torch.utils.profiling import span

# Kernel launches: K8 (stem_stats), K9 (stem_bwd_partials) and K10
# (stem_bwd_final). The plain versions are not counted.
stats_launches = 0
partials_launches = 0
final_launches = 0

# K9 and K10 walk the tiles of ``_stem_tiles`` (a thread owns BWD_CPT
# channels of one pooled pixel). The staged f32 band is followed by the
# chunk's constants (64 channels x 20 floats) and K10's warp buffers (8
# warps x (two 4x4 patches, 8 d_conv rows of 72 floats and 16 of shift)) or
# K9's reduction scratch (8 warps x 2 x 64 floats)
BWD_CPT = 4
_K10_BUFFER_FLOATS = 64 * 20 + 8 * (32 + 8 * 72 + 16)
_K9_BUFFER_FLOATS = 64 * 20 + 8 * 2 * 64


def bwd_plan(B: int, H: int, W: int, C: int, final: bool,
             holds: Callable[[int], int]) -> tiles.TilePlan:
    """The plan of K9 (``final`` False) or K10 for a (B, H, W, 1) image and C
    channels; ``holds(smem_bytes)`` is the number of CTAs the card holds at
    once at that much shared memory. The same in both dtypes: the band is
    staged in f32 either way."""
    extra = _K10_BUFFER_FLOATS if final else _K9_BUFFER_FLOATS
    return tiles.tile_plan(B, H, W, C, lambda rows, cols: 4 * (
        (2 * rows + 2) * (2 * cols + 2) + extra), holds)


def bwd_design(img, C: int, final: bool) -> tiles.TilePlan:
    """The plan K9 (``final`` False) or K10 launches with for this CUDA
    image and C channels."""
    B, H, W = img.shape[0], img.shape[1], img.shape[2]
    bf16 = img.dtype == torch.bfloat16
    return bwd_plan(B, H, W, C, final, lambda smem: tiles.card_holds(
        img.device, "crnn_stem_bwd_ctas_per_sm", bf16, final, smem))


def _conv(img, conv_w):
    """The f32 conv output z (B, C, H, W): the image's values and the
    weights rounded to the image's dtype."""
    x = img.float().permute(0, 3, 1, 2)
    w = conv_w.to(img.dtype).float().permute(3, 2, 0, 1)
    return F.conv2d(x, w, padding=1)


def _chan(v):
    return v.float()[:, None, None]


def _routed(z, g, scale, bias):
    """The pooled gradient g (B, H/2, W/2, C) routed to full resolution
    (B, C, H, W): in each 2x2 window to the first position, in (h, w) order,
    whose activation ``relu(z * scale + bias)`` equals the window's
    maximum, and only if that activation is > 0."""
    B, C, H, W = z.shape
    a = torch.relu(z * _chan(scale) + _chan(bias))
    win = a.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5)
    win = win.reshape(B, C, H // 2, W // 2, 4)
    # argmax returns the first maximal index
    hit = F.one_hot(win.argmax(-1), 4).bool() & (win > 0)
    gv = g.float().permute(0, 3, 1, 2)[..., None]
    d = torch.where(hit, gv, torch.zeros((), device=z.device))
    d = d.reshape(B, C, H // 2, W // 2, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return d.reshape(B, C, H, W)


def stem_stats_plain(img, conv_w):
    """K8's function: (2, C) f32 [sum z, sum z^2] over (B, H, W)."""
    z = _conv(img, conv_w)
    return torch.stack([z.sum((0, 2, 3)), (z * z).sum((0, 2, 3))])


def stem_bwd_partials_plain(img, conv_w, g, mean, inv, scale, bias):
    """K9's function: (2, C) f32 [sum d, sum d * xhat], d the routed
    gradient, ``xhat = (z - mean) * inv``."""
    z = _conv(img, conv_w)
    d = _routed(z, g, scale, bias)
    xh = (z - _chan(mean)) * _chan(inv)
    return torch.stack([d.sum((0, 2, 3)), (d * xh).sum((0, 2, 3))])


def stem_bwd_final_plain(img, conv_w, g, mean, inv, scale, bias, c1, c2, c3):
    """K10's function: d_w (3, 3, 1, C) f32, the conv weight gradient of
    ``d_conv = c1 * (d - c2 - xhat * c3)`` at every position."""
    z = _conv(img, conv_w)
    B, C, H, W = z.shape
    d = _routed(z, g, scale, bias)
    xh = (z - _chan(mean)) * _chan(inv)
    dc = _chan(c1) * ((d - _chan(c2)) - xh * _chan(c3))
    taps = F.unfold(img.float().permute(0, 3, 1, 2), 3, padding=1)
    dw = torch.einsum("bkl,bcl->kc", taps, dc.reshape(B, C, H * W))
    return dw.reshape(3, 3, 1, C)


def _check(img, conv_w, g=None, vecs=()):
    if img.dim() != 4 or img.shape[-1] != 1:
        raise ValueError(f"image must be (B, H, W, 1), got {tuple(img.shape)}")
    B, H, W, _ = img.shape
    if H % 2 or W % 2 or H < 2 or W < 2:
        raise ValueError(f"image height and width must be even, got {H}x{W}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"image dtype must be float32 or bfloat16, got "
                        f"{img.dtype}")
    if conv_w.dim() != 4 or tuple(conv_w.shape[:3]) != (3, 3, 1):
        raise ValueError(f"conv kernel must be (3, 3, 1, C), got "
                         f"{tuple(conv_w.shape)}")
    C = conv_w.shape[-1]
    if g is not None and (tuple(g.shape) != (B, H // 2, W // 2, C)
                          or g.dtype != img.dtype):
        raise ValueError(f"the pooled gradient must be ({B}, {H // 2}, "
                         f"{W // 2}, {C}) {img.dtype}, got {tuple(g.shape)} "
                         f"{g.dtype}")
    for v in vecs:
        if tuple(v.shape) != (C,):
            raise ValueError(f"per-channel operands must be ({C},), got "
                             f"{tuple(v.shape)}")
    return B, H, W, C


def _launch_bwd(img, conv_w, g, vecs, final: bool):
    """Launch K9 (``final`` False, ``vecs`` mean, inv, scale, bias) or K10
    (``vecs`` those, then c1, c2, c3) and return the sum of the CTAs'
    partials, (2, C) or (9, C) f32, which the C entry's second kernel adds
    in CTA order. The weights go as they are (f32, read through their
    strides: the model's HWIO view of its OIHW weights needs no copy), and
    so do the vectors: no kernel runs before the launch."""
    tiles.on_card("crnn_stem_bwd", img, (conv_w, g, *vecs))
    B, H, W, C = img.shape[0], img.shape[1], img.shape[2], conv_w.shape[-1]
    plan = bwd_design(img, C, final)
    taps = tiles.taps(conv_w)
    vecs = [v.float().contiguous() for v in vecs]
    vecs += [None] * (7 - len(vecs))
    img, g = img.contiguous(), g.contiguous()
    rows = 9 if final else 2
    parts = torch.empty((plan.ctas, rows, C), dtype=torch.float32,
                        device=img.device)
    out = torch.empty((rows, C), dtype=torch.float32, device=img.device)
    ptr = tiles.ptr
    tiles.call("crnn_stem_bwd",
               [ptr(img), ptr(g), ptr(taps), taps.stride(1), taps.stride(2),
                *map(ptr, vecs), ptr(parts), ptr(out), B, H, W, C,
                int(img.dtype == torch.bfloat16), int(final), plan.rows,
                plan.col_tiles, plan.ctas, plan.smem_bytes], img.device)
    return out


def stem_stats(img, conv_w):
    """K8: (2, C) f32 [sum z, sum z^2] of :func:`stem_stats_plain`."""
    _check(img, conv_w)
    if img.device.type == "cpu":
        return stem_stats_plain(img, conv_w)
    out = tiles.launch_mma(img, conv_w)
    global stats_launches
    stats_launches += 1
    return out


def stem_bwd_partials(img, conv_w, g, mean, inv, scale, bias):
    """K9: (2, C) f32 [sum d, sum d * xhat] of
    :func:`stem_bwd_partials_plain`."""
    vecs = (mean, inv, scale, bias)
    _check(img, conv_w, g, vecs)
    if img.device.type == "cpu":
        return stem_bwd_partials_plain(img, conv_w, g, *vecs)
    out = _launch_bwd(img, conv_w, g, vecs, final=False)
    global partials_launches
    partials_launches += 1
    return out


def stem_bwd_final(img, conv_w, g, mean, inv, scale, bias, c1, c2, c3):
    """K10: d_w (3, 3, 1, C) f32 of :func:`stem_bwd_final_plain`."""
    vecs = (mean, inv, scale, bias, c1, c2, c3)
    _check(img, conv_w, g, vecs)
    if img.device.type == "cpu":
        return stem_bwd_final_plain(img, conv_w, g, *vecs)
    out = _launch_bwd(img, conv_w, g, vecs, final=True)
    global final_launches
    final_launches += 1
    return out.reshape(3, 3, 1, -1)


def bwd_affine(gamma, beta, mean, var, eps: float = 1e-3):
    """The backward's per-channel f32 ``(inv, scale, bias)``, as ``_bwd``
    computes them: ``inv = rsqrt(var + eps)``, ``scale = gamma * inv``,
    ``bias = beta - mean * inv * gamma``."""
    inv = torch.rsqrt(var + eps)
    gf = gamma.float()
    return inv, gf * inv, beta.float() - mean * inv * gf


class _FusedStemTrain(torch.autograd.Function):
    """K8 + K1 forward, K9 + K10 backward (``fused_stem_train``'s custom
    VJP, ``_fwd``/``_bwd``). mean and var are outputs without gradient."""

    @staticmethod
    def forward(ctx, img, conv_w, gamma, beta, eps, mesh):
        B, H, W, _ = img.shape
        n = float(B * H * W)
        s = stem_stats(img, conv_w)
        if is_dp(mesh):  # equal shards: every rank has n positions
            s = all_reduce_(s, mesh)
            n *= mesh.world
        mean = s[0] / n
        var = s[1] / n - mean * mean
        scale, bias = fold_bn(gamma, beta, mean, var, eps)
        # K1 on conv9: K9 and K10 recompute its z bit for bit
        pooled = fused_stem._forward(img, conv_w, scale, bias, "conv9")
        ctx.save_for_backward(img, conv_w, gamma, beta, mean, var)
        ctx.eps, ctx.n, ctx.mesh = eps, n, mesh
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g, _d_mean, _d_var):
        img, conv_w, gamma, beta, mean, var = ctx.saved_tensors
        with span("stem_backward"):
            inv, scale, bias = bwd_affine(gamma, beta, mean, var, ctx.eps)
            g = g.contiguous()
            p = stem_bwd_partials(img, conv_w, g, mean, inv, scale, bias)
            p_tot = (all_reduce_(p.clone(), ctx.mesh) if is_dp(ctx.mesh)
                     else p)
            # c1 = gamma * inv is the folded scale
            d_w = stem_bwd_final(img, conv_w, g, mean, inv, scale, bias,
                                 scale, p_tot[0] / ctx.n, p_tot[1] / ctx.n)
        # d_gamma and d_beta: the rank's own sums (the gradient sum adds
        # them)
        return (None, d_w.to(conv_w.dtype), p[1].to(gamma.dtype),
                p[0].to(beta.dtype), None, None)


def fused_stem_train(img, conv_w, gamma, beta, eps: float = 1e-3,
                     mesh=None):
    """img (B, H, W, 1) -> (pooled (B, H/2, W/2, C) in the image's dtype,
    batch mean (C,), batch var (C,) f32, unclamped), differentiable in
    ``conv_w``, ``gamma`` and ``beta``; on a process ``mesh`` the
    statistics are the global batch's (every rank holding an equal shard).
    Raises if the image requires a gradient: none is computed."""
    if img.requires_grad:
        raise RuntimeError(
            "fused_stem_train computes no image gradient, and the image "
            "requires one (an STN model trains through the plain stem)")
    _check(img, conv_w, vecs=(gamma, beta))
    return _FusedStemTrain.apply(img, conv_w, gamma, beta, eps, mesh)
