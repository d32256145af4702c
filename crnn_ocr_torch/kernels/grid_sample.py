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
through the kernel, or the call raises. K12 launches as :func:`plan` says,
a pure function of the shape: ``"cluster"`` (an image's samples spread
over a thread-block cluster, ``d_img`` reduced in the cluster's shared
memory) on every path; ``"image"`` (the first design, one CTA an image) is
kept to time against it. ``bilinear_sample`` is the differentiable entry
point (a ``torch.autograd.Function``: K11 forward, K12 backward; the
backward, on autograd's thread, is the program's ``grid_sample_backward``
span).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from crnn_ocr_torch.utils.profiling import span

# Kernel launches: K11 (sample_pix) and K12 (sample_pix_bwd), and K12's by
# design. The plain versions are not counted.
launches = 0
bwd_launches = 0
design_launches: collections.Counter = collections.Counter()

SMEM_MAX = 232_448  # a CTA's shared memory (the H100's, with the opt-in)
MAX_CLUSTER = 8  # the portable cluster size
# K12's CTAs an image on the "cluster" design: 2 where B * 2 CTAs of 512
# threads fit the H100 at once (2 an SM on its 132 SMs), else 1 (one CTA
# an image already fills the card: at B 256, 1 ran K12 faster than 2, and
# 2 faster than 4 at B 128); more where an image's slice must shrink to
# fit a CTA
CLUSTER = 2
WAVE_CTAS = 2 * 132
THREADS = 512  # a "cluster" CTA's threads
DESIGNS = {"image": 0, "cluster": 1}  # the C entry's design codes
CHUNK, RING = 1024, 2  # a ring slot's samples (x, y, g f32), the slots
RING_BYTES = RING * 3 * CHUNK * 4


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


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


class Plan(NamedTuple):
    """How K12 launches (``csrc/grid_sample.cu``): ``design``, ``cluster``
    CTAs an image (1 on ``"image"``), each accumulating ``d_img`` over the
    whole image (``tile``) or over its own ``slice`` of pixels (flat
    ranges; on ``"image"`` all of them) and taking ``span`` samples
    (contiguous ranges), the image ``staged`` in shared memory or read
    through L1, ``smem_bytes`` of shared memory a CTA, ``ctas`` in all."""

    design: str
    cluster: int
    tile: bool
    slice: int
    span: int
    staged: bool
    smem_bytes: int
    ctas: int


def cluster_for(B: int, H: int, W: int) -> int:
    """The "cluster" design's CTAs an image (see ``CLUSTER``)."""
    c = CLUSTER if B * CLUSTER <= WAVE_CTAS else 1
    while (c < MAX_CLUSTER
           and _round(-(-H * W // c), 4) * 4 > SMEM_MAX - RING_BYTES):
        c *= 2
    return c


def plan(B: int, H: int, W: int, N: int, itemsize: int,
         design: str = "cluster", cluster: int | None = None) -> Plan:
    """K12's launch for B images of (H, W) elements of ``itemsize`` bytes
    and N samples each, a pure function of the shape. ``"cluster"`` keeps
    a CTA's f32 tile of the whole image where it fits beside the ring of
    samples (up to 51,968 pixels) and each CTA's pixel slice (H * W /
    cluster, rounded up to 4) past that, so at 2 CTAs it takes up to
    103,936 pixels: every shape the JAX package's ``sampler_supported``
    admits (H * W * 4 <= 256 KB). The image is staged in shared memory
    where it fits beside them.
    ``"image"`` (one CTA an image) takes up to 58,112 pixels. A shape past
    the gate raises."""
    if design not in DESIGNS:
        raise ValueError(f"sample_pix_bwd: no design {design!r}")
    HW = H * W
    if HW < 1:
        raise ValueError(f"sample_pix_bwd: an empty image {H}x{W}")
    if design == "image":
        if HW * 4 > SMEM_MAX:
            raise ValueError(f"sample_pix_bwd: the image design keeps the "
                             f"image's f32 gradient in one CTA's shared "
                             f"memory ({SMEM_MAX // 4} pixels), got {H}x{W}")
        return Plan("image", 1, True, HW, N, False, HW * 4, B)
    if cluster is None:
        cluster = cluster_for(B, H, W)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"sample_pix_bwd: 1 to {MAX_CLUSTER} CTAs a "
                         f"cluster, got {cluster}")
    slice_ = _round(-(-HW // cluster), 4)
    room = SMEM_MAX - RING_BYTES  # beside the ring of x, y, g
    tile = _round(HW, 4) * 4 <= room
    acc = _round(HW, 4) if tile else slice_
    if acc * 4 > room:
        raise ValueError(f"sample_pix_bwd: a CTA's share of the image's f32 "
                         f"gradient ({acc} pixels of {H}x{W} over "
                         f"{cluster} CTAs) must fit its shared memory "
                         f"({room // 4} pixels beside its samples)")
    image = _round(HW * itemsize, 16)
    # past a tile, slice and image never fit together at cluster_for's size
    staged = tile and acc * 4 + image <= room
    return Plan(design, cluster, tile, slice_, _round(-(-N // cluster), 4),
                staged, acc * 4 + RING_BYTES + (image if staged else 0),
                B * cluster)


_entries: dict = {}  # name -> (library, C entry), bound once


def plan_args(p: Plan) -> tuple:
    """The C entry's plan arguments."""
    return (DESIGNS[p.design], p.cluster, int(p.tile), p.slice, p.span,
            int(p.staged), p.smem_bytes)


def _entry(name):
    got = _entries.get(name)
    if got is None:
        from crnn_ocr_torch.kernels import _build

        lib = _build.load("grid_sample")
        fn = getattr(lib, f"crnn_grid_sample_{name}")
        fn.restype = ctypes.c_int
        if name == "fwd":  # img, x, y, out; B, H, W, N, bf16
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        else:  # img, x, y, g, dimg, dx, dy; B, H, W, N, bf16, the plan
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
        fn.argtypes += [ctypes.c_void_p]  # the stream
        got = _entries[name] = (lib, fn)
    return got


def _launch(name, img, ins, outs, B, H, W, N, extra=()):
    dev = img.device
    for t in ins:
        if t.device != dev:
            raise RuntimeError(f"sample_pix {name}: an operand is on "
                               f"{t.device}, the image on {dev}")
    if B > 65535:
        raise ValueError(f"sample_pix {name}: at most 65535 images a "
                         f"launch, got {B}")
    img = img.contiguous()
    ins = [t.contiguous() for t in ins]
    lib, fn = _entry(name)
    args = (img.data_ptr(), *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in outs), B, H, W, N,
            int(img.dtype == torch.bfloat16), *extra)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        from crnn_ocr_torch.kernels import _build

        _build.check(lib, err, f"sample_pix {name}")


def resources(p: Plan, itemsize: int) -> dict:
    """A cluster plan's instance on this card, launching nothing: its
    registers and local memory a thread, and the clusters the card holds
    at once (``ctas`` / ``cluster`` / that is the waves the grid takes)."""
    from crnn_ocr_torch.kernels import _build

    lib = _build.load("grid_sample")
    fn = lib.crnn_grid_sample_bwd_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    info = (ctypes.c_int * 3)()
    err = fn(int(itemsize == 2), int(p.tile), int(p.staged), p.cluster,
             p.smem_bytes, ctypes.addressof(info))
    _build.check(lib, err, f"sample_pix_bwd info ({p})")
    return dict(registers=info[0], local_bytes=info[1],
                clusters_at_once=info[2])


def _on_card(img, what: str) -> bool:
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for {img.device}")
    return True


def sample_pix(img, x, y):
    """K11: samples (B, N) f32 of :func:`sample_pix_plain`."""
    B, H, W, N = _check(img, x, y)
    if not _on_card(img, "sample_pix"):
        return sample_pix_plain(img, x, y)
    out = torch.empty((B, N), dtype=torch.float32, device=img.device)
    _launch("fwd", img, (x, y), (out,), B, H, W, N)
    global launches
    launches += 1
    return out


def sample_pix_bwd(img, x, y, g, design: str = "cluster",
                   cluster: int | None = None):
    """K12: (d_img, dx, dy) of :func:`sample_pix_bwd_plain`, on ``design``
    (:func:`plan`) for a CUDA tensor."""
    B, H, W, N = _check(img, x, y, g)
    if not _on_card(img, "sample_pix_bwd"):
        return sample_pix_bwd_plain(img, x, y, g)
    p = plan(B, H, W, N, img.element_size(), design, cluster)
    dev = img.device
    dimg = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    dx = torch.empty((B, N), dtype=torch.float32, device=dev)
    dy = torch.empty_like(dx)
    _launch("bwd", img, (x, y, g), (dimg, dx, dy), B, H, W, N,
            plan_args(p))
    global bwd_launches
    bwd_launches += 1
    design_launches[p.design] += 1
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
        with span("grid_sample_backward"):
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
    """``bilinear_sample_pallas`` (``kernels/grid_sample.py:219-235``) and
    ``ops/grid_sample.py::bilinear_sample`` (``:45``): img (B, H, W, C),
    coords (B, Ho, Wo, 2) normalized (x, y) in [-1, 1] (pixel centres at
    the ends, torch's ``align_corners=True``) -> (B, Ho, Wo, C) in the
    image's dtype. Differentiable in the image and in the coordinates.
    C > 1 channels fold into the batch, (B * C, H, W), each image's pixel
    coordinates repeated C times (autograd sums their gradients back): one
    K11 and one K12 launch, whatever C."""
    if img.dim() != 4:
        raise ValueError(f"img must be (B, H, W, C), got {tuple(img.shape)}")
    B, H, W, C = img.shape
    _, Ho, Wo, _ = coords.shape
    x, y = pixel_coords(coords, H, W)
    if C == 1:
        planes = img[..., 0]
    else:
        planes = img.permute(0, 3, 1, 2).reshape(B * C, H, W)
        x, y = x.repeat_interleave(C, dim=0), y.repeat_interleave(C, dim=0)
    out = _SamplePix.apply(planes, x, y)
    return out.reshape(B, C, Ho, Wo).permute(0, 2, 3, 1).to(img.dtype)
