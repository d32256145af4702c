"""Serve stem: conv3x3 (1 -> C) + folded BatchNorm + ReLU + maxpool 2x2.

Replaces ``crnn_ocr_tpu/kernels/fused_stem.py::fused_stem_serve``, the TPU
kernel that keeps the full-resolution conv activation out of device memory
and writes only the pooled ``(B, H/2, W/2, C)`` result. The CUDA kernels
are in ``csrc/fused_stem.cu`` (its header has the designs and the H100
bound, 21 us at the main-path shape, bytes-bound), in two designs:

* ``"mma"`` (``stem_mma_kernel``, launched by ``_stem_tiles.launch_mma``,
  which K8 shares): the conv on the tensor cores, as the TPU kernel runs
  it on the MXU; bf16 serving takes it;
* ``"conv9"`` (``stem_kernel``): the conv as 9 f32 FMAs on the CUDA cores;
  f32 serving takes it, and so does the training forward in both dtypes
  (``fused_stem_train``), whose z the backward's kernels recompute bit for
  bit.

``fused_stem_plain`` is the same function in plain PyTorch.

Layouts are the JAX package's: the image is NHWC ``(B, H, W, 1)``, the conv
kernel HWIO ``(3, 3, 1, C)``, the output NHWC. The image's dtype sets the
mode and the output's dtype: bf16 rounds the conv weights to bf16 and keeps
products, sums, affine, ReLU and max in f32 before one cast to bf16 (the
TPU kernel's rounding points); f32 is f32 throughout.

``fused_stem_serve`` dispatches on the image's device and on nothing else:
a CPU tensor goes through ``fused_stem_plain``, a CUDA tensor through a
kernel (its design set by the dtype), or the call raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from crnn_ocr_torch.kernels._stem_tiles import launch_mma

# Kernel launches per design (the plain version is not counted); their sum
# reads as ``launches``, like the other kernel modules' counts
design_launches: collections.Counter = collections.Counter()


def __getattr__(name):
    if name == "launches":
        return sum(design_launches.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def fold_bn(gamma, beta, mean, var, eps: float = 1e-3):
    """BatchNorm running statistics -> per-channel f32 (scale, bias), as
    ``fused_stem.py:172-179``: ``inv = gamma * rsqrt(var + eps)``,
    ``bias = beta - mean * inv``."""
    inv = gamma.float() * torch.rsqrt(var.float() + eps)
    return inv, beta.float() - mean.float() * inv


def fused_stem_plain(img, conv_w, scale, bias):
    """``maxpool2x2(relu(conv3x3(img) * scale + bias))`` in plain PyTorch:
    an f32 conv on the image's values and on weights rounded to the
    image's dtype, then the affine, ReLU and pool in f32, then one cast to
    the image's dtype."""
    x = img.float().permute(0, 3, 1, 2)  # (B, 1, H, W)
    w = conv_w.to(img.dtype).float().permute(3, 2, 0, 1)  # (C, 1, 3, 3)
    z = F.conv2d(x, w, padding=1)
    a = torch.relu(z * scale.float()[:, None, None] + bias.float()[:, None, None])
    p = F.max_pool2d(a, 2)
    return p.permute(0, 2, 3, 1).to(img.dtype).contiguous()


def _check(img, conv_w, scale, bias):
    if img.dim() != 4 or img.shape[-1] != 1:
        raise ValueError(f"image must be (B, H, W, 1), got {tuple(img.shape)}")
    B, H, W, _ = img.shape
    if H % 2 or W % 2 or H < 2 or W < 2:
        raise ValueError(f"image height and width must be even, got {H}x{W}")
    if conv_w.dim() != 4 or tuple(conv_w.shape[:3]) != (3, 3, 1):
        raise ValueError(f"conv kernel must be (3, 3, 1, C), got "
                         f"{tuple(conv_w.shape)}")
    C = conv_w.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError("scale and bias must have shape (C,)")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"image dtype must be float32 or bfloat16, got "
                        f"{img.dtype}")
    return B, H, W, C


def fused_stem_serve(img, conv_w, scale, bias):
    """img (B, H, W, 1) -> pooled stem activation (B, H/2, W/2, C) in the
    image's dtype. ``scale``/``bias``: the BatchNorm folded by
    :func:`fold_bn`. A bf16 image takes the ``"mma"`` design, an f32 one
    ``"conv9"``."""
    design = "mma" if img.dtype == torch.bfloat16 else "conv9"
    return _forward(img, conv_w, scale, bias, design)


def _forward(img, conv_w, scale, bias, design: str):
    """:func:`fused_stem_serve` on ``design`` (``"mma"``: bf16 only, or
    ``"conv9"``); the plain version for a CPU image."""
    B, H, W, C = _check(img, conv_w, scale, bias)
    if img.device.type == "cpu":
        return fused_stem_plain(img, conv_w, scale, bias)
    if img.device.type != "cuda":
        raise RuntimeError(f"fused_stem_serve: no kernel for {img.device}")
    dev = img.device
    for name, t in (("conv_w", conv_w), ("scale", scale), ("bias", bias)):
        if t.device != dev:
            raise RuntimeError(f"fused_stem_serve: {name} is on {t.device}, "
                               f"image on {dev}")
    if design == "mma":
        if img.dtype != torch.bfloat16:
            raise ValueError(f"the mma design takes a bf16 image, got "
                             f"{img.dtype}")
        out = launch_mma(img, conv_w, scale, bias)
    elif design == "conv9":
        out = _launch_conv9(img, conv_w, scale, bias)
    else:
        raise ValueError(f"unknown stem design {design!r}")
    design_launches[design] += 1
    return out


def _launch_conv9(img, conv_w, scale, bias):
    from crnn_ocr_torch.kernels import _build

    B, H, W, _ = img.shape
    C = conv_w.shape[-1]
    dev = img.device
    taps = conv_w.to(img.dtype).float().reshape(9, C)  # (kh, kw), channel
    params = torch.cat([taps.reshape(-1), scale.float(), bias.float()])
    img = img.contiguous()
    out = torch.empty((B, H // 2, W // 2, C), dtype=img.dtype, device=dev)
    lib = _build.load("fused_stem")
    fn = lib.crnn_fused_stem_serve
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn(
            img.data_ptr(), params.data_ptr(), out.data_ptr(), B, H, W, C,
            int(img.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, "fused_stem_serve")
    return out
