"""Bilinear sampling at pixel coordinates, border-clamped: the STN's warp.

Replaces ``crnn_ocr_tpu/kernels/grid_sample.py``: ``_sample_pix_fwd_impl``
(:131, K11, kernel ``_fwd_kernel`` :62-74) and ``_sample_pix_bwd`` (:160,
K12, kernel ``_bwd_kernel`` :77-103). The CUDA kernels are in
``csrc/grid_sample.cu`` (its header has the designs and the H100 bounds);
``sample_pix_plain`` and ``sample_pix_bwd_plain`` are the same functions in
plain PyTorch, in the same order of operations.

The math is the TPU kernel's (``_corner_weights``, :40-59), which is
``ops/grid_sample.py::bilinear_sample``'s: for a sample at pixel (x, y), the
weights come from the unclipped position (``wx1 = x - floor(x)``) and the
indices are clamped to the border. Per axis the sample has two corners with
weights ``1 - w1`` and ``w1``; where the clamp makes them one index, that
index carries both weights summed, as the TPU kernel's one-hot columns sum
them. The x-blend comes first, ``s_h = img[h, x0] * mx0 + img[h, x1] * mx1``
for the rows ``y0`` and ``y1``, then the y-blend ``my0 * s_y0 + my1 * s_y1``.

The backward, for an upstream gradient ``g`` per sample:

* ``dx = g * (my0 * (img[y0, x1] - img[y0, x0]) + my1 * (img[y1, x1] -
  img[y1, x0]))``;
* ``dy = g * (s_y1 - s_y0)``;
* ``d_img[h, w] += (g * my_h) * mx_w`` for the (up to four) distinct
  corners, in f32.

(floor and the clamp have zero gradient, as in XLA's autodiff of the gather
path.) The image is read as f32 whatever its dtype; samples, coordinates
and the coordinate gradients are f32, ``d_img`` is f32 from the kernel.

``sample_pix`` and ``sample_pix_bwd`` dispatch on the image's device and on
nothing else: a CPU tensor goes through the plain version, a CUDA tensor
through the kernel, or the call raises. ``bilinear_sample`` is the
differentiable entry point (a ``torch.autograd.Function``: K11 forward,
K12 backward).
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches: K11 (sample_pix) and K12 (sample_pix_bwd). The plain
# versions are not counted.
launches = 0
bwd_launches = 0

# K12 keeps one image's f32 gradient in shared memory (227 KB a block)
MAX_BWD_PIXELS = 232_448 // 4


def _corners(x, y, H: int, W: int):
    """Corner indices (int64) and weights (f32) of each sample."""
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0f, y - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, W - 1), (xi + 1).clamp(0, W - 1)
    y0, y1 = yi.clamp(0, H - 1), (yi + 1).clamp(0, H - 1)
    zero = torch.zeros_like(wx1)
    same_x, same_y = x0 == x1, y0 == y1
    mx0 = torch.where(same_x, wx0 + wx1, wx0)
    mx1 = torch.where(same_x, zero, wx1)
    my0 = torch.where(same_y, wy0 + wy1, wy0)
    my1 = torch.where(same_y, zero, wy1)
    return x0, x1, y0, y1, mx0, mx1, my0, my1


def _blend(img, x, y):
    """The four corner values and both x-blends of each sample."""
    B, H, W = img.shape
    flat = img.float().reshape(B, H * W)
    x0, x1, y0, y1, mx0, mx1, my0, my1 = _corners(x, y, H, W)

    def at(yy, xx):
        return torch.gather(flat, 1, yy * W + xx)

    v00, v01, v10, v11 = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    s0 = v00 * mx0 + v01 * mx1
    s1 = v10 * mx0 + v11 * mx1
    return (x0, x1, y0, y1, mx0, mx1, my0, my1), (v00, v01, v10, v11), s0, s1


def sample_pix_plain(img, x, y):
    """K11's function: img (B, H, W) f32 or bf16, x and y (B, N) f32 pixel
    coordinates -> samples (B, N) f32."""
    (_, _, _, _, _, _, my0, my1), _, s0, s1 = _blend(img, x, y)
    return my0 * s0 + my1 * s1


def sample_pix_bwd_plain(img, x, y, g):
    """K12's function: the same inputs and ``g`` (B, N) f32 -> (d_img
    (B, H, W) f32, dx (B, N), dy (B, N))."""
    B, H, W = img.shape
    c, (v00, v01, v10, v11), s0, s1 = _blend(img, x, y)
    x0, x1, y0, y1, mx0, mx1, my0, my1 = c
    dx = g * (my0 * (v01 - v00) + my1 * (v11 - v10))
    dy = g * (s1 - s0)
    g0, g1 = g * my0, g * my1
    dimg = torch.zeros((B, H * W), dtype=torch.float32, device=img.device)
    for yy, xx, val in ((y0, x0, g0 * mx0), (y0, x1, g0 * mx1),
                        (y1, x0, g1 * mx0), (y1, x1, g1 * mx1)):
        dimg.scatter_add_(1, yy * W + xx, val)
    return dimg.reshape(B, H, W), dx, dy


def _check(img, x, y, g=None):
    if img.dim() != 3 or img.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"img must be (B, H, W) float32 or bfloat16, got "
                         f"{tuple(img.shape)} {img.dtype}")
    B, H, W = img.shape
    for name, t in (("x", x), ("y", y), ("g", g)):
        if t is None:
            continue
        if t.dim() != 2 or t.shape[0] != B or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, N) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, x "
                             f"{tuple(x.shape)}")
    return B, H, W, x.shape[1]


def _launch(entry, img, ins, outs, B, H, W, N):
    dev = img.device
    if dev.type != "cuda":
        raise RuntimeError(f"{entry}: no kernel for {dev}")
    for t in ins:
        if t.device != dev:
            raise RuntimeError(f"{entry}: an operand is on {t.device}, the "
                               f"image on {dev}")
    if B > 65535:
        raise ValueError(f"{entry}: at most 65535 images a launch, got {B}")
    from crnn_ocr_torch.kernels import _build

    img = img.contiguous()
    ins = [t.contiguous() for t in ins]
    lib = _build.load("grid_sample")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    n_ptr = 1 + len(ins) + len(outs)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn(img.data_ptr(), *(t.data_ptr() for t in ins),
                 *(t.data_ptr() for t in outs), B, H, W, N,
                 int(img.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, entry)


def sample_pix(img, x, y):
    """K11: samples (B, N) f32 of :func:`sample_pix_plain`."""
    B, H, W, N = _check(img, x, y)
    if img.device.type == "cpu":
        return sample_pix_plain(img, x, y)
    out = torch.empty((B, N), dtype=torch.float32, device=img.device)
    _launch("crnn_grid_sample_fwd", img, (x, y), (out,), B, H, W, N)
    global launches
    launches += 1
    return out


def sample_pix_bwd(img, x, y, g):
    """K12: (d_img, dx, dy) of :func:`sample_pix_bwd_plain`."""
    B, H, W, N = _check(img, x, y, g)
    if img.device.type == "cpu":
        return sample_pix_bwd_plain(img, x, y, g)
    if H * W > MAX_BWD_PIXELS:
        raise ValueError(f"sample_pix_bwd: the image's f32 gradient must fit "
                         f"a block's shared memory ({MAX_BWD_PIXELS} pixels),"
                         f" got {H}x{W}")
    dev = img.device
    dimg = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    dx = torch.empty((B, N), dtype=torch.float32, device=dev)
    dy = torch.empty_like(dx)
    _launch("crnn_grid_sample_bwd", img, (x, y, g), (dimg, dx, dy), B, H, W,
            N)
    global bwd_launches
    bwd_launches += 1
    return dimg, dx, dy


class _SamplePix(torch.autograd.Function):
    """K11 forward, K12 backward (``_sample_pix``'s custom VJP)."""

    @staticmethod
    def forward(ctx, img, x, y):
        ctx.save_for_backward(img, x, y)
        return sample_pix(img, x, y)

    @staticmethod
    def backward(ctx, g):
        img, x, y = ctx.saved_tensors
        dimg, dx, dy = sample_pix_bwd(img, x, y, g.float().contiguous())
        return (dimg.to(img.dtype) if ctx.needs_input_grad[0] else None,
                dx, dy)


def pixel_coords(coords, H: int, W: int):
    """coords (B, Ho, Wo, 2) normalized (x, y) -> f32 pixel coordinates x,
    y (B, Ho * Wo) in an (H, W) image, as ``bilinear_sample_pallas`` maps
    them (``kernels/grid_sample.py:229-230``)."""
    B = coords.shape[0]
    x = (coords[..., 0] + 1.0) * ((W - 1) / 2.0)
    y = (coords[..., 1] + 1.0) * ((H - 1) / 2.0)
    return x.reshape(B, -1).float(), y.reshape(B, -1).float()


def bilinear_sample(img, coords):
    """``bilinear_sample_pallas`` (``kernels/grid_sample.py:219-235``): img
    (B, H, W, 1), coords (B, Ho, Wo, 2) normalized (x, y) in [-1, 1]
    (pixel centres at the ends, torch's ``align_corners=True``) -> (B, Ho,
    Wo, 1) in the image's dtype. Differentiable in the image and in the
    coordinates."""
    if img.dim() != 4 or img.shape[-1] != 1:
        raise ValueError(f"img must be (B, H, W, 1), got {tuple(img.shape)}")
    B, H, W, _ = img.shape
    _, Ho, Wo, _ = coords.shape
    out = _SamplePix.apply(img[..., 0], *pixel_coords(coords, H, W))
    return out.reshape(B, Ho, Wo, 1).to(img.dtype)
