"""The tiles that the stem's tiled kernels walk, and the tensor-core launch.

K1's bf16 serving call and K8 (``csrc/fused_stem.cu::stem_mma_kernel``),
K9 and K10 (``bwd_tile_kernel``) run a persistent one-wave grid over the
same tiles: TILE_ROWS pooled rows of one image (8: one tile a CTA at the
training shapes, the fastest of 2, 4 and 8 for K9 and K10 on the H100, and
4 was no faster for K1 and slower for K8) by a column tile of at most
TILE_COL_CAP pooled columns by TILE_CHUNK channels. The rest as
``csrc/fused_stem.cu`` fixes it. Each C entry re-derives the plan's
shared-memory bytes and refuses a plan whose bytes differ.

This module holds the plan (:func:`tile_plan`; :func:`stem_plan` for
``stem_mma_kernel``), the card's capacity (:func:`card_holds`), the C-entry
plumbing, and :func:`launch_mma`, which ``fused_stem`` (K1) and
``fused_stem_train`` (K8) both call. K9's and K10's plan and launch are in
``fused_stem_train``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Tuple

import torch

TILE_ROWS, TILE_COL_CAP, TILE_CHUNK = 8, 128, 64
# stem_mma_kernel's shared memory after its two raw bands: K8's warps'
# sums (8 warps x 2 x 64 floats), or K1's chunk scale and bias (2 x 64
# floats) and the warps' output staging (8 warps x 8 pooled pixels x 36
# words)
_K8_BUFFER_FLOATS = 8 * 2 * 64
_K1_BUFFER_FLOATS = 2 * 64 + 8 * 8 * 36


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch of a tiled kernel (K1's bf16 serving call, K8, K9, K10):
    ``rows`` pooled rows a tile, the pooled columns in ``col_tiles``
    near-equal runs, ``chunks`` channel chunks, ``tiles`` tiles in all,
    walked by ``ctas`` persistent CTAs (one wave: no more than the card
    holds at once) with ``smem_bytes`` of shared memory each."""

    rows: int
    col_tiles: int
    chunks: int
    tiles: int
    ctas: int
    smem_bytes: int


def tile_plan(B: int, H: int, W: int, C: int,
              smem_of: Callable[[int, int], int],
              holds: Callable[[int], int], rows: int = TILE_ROWS) -> TilePlan:
    """The tiles of a (B, H, W, 1) image and C channels, at most ``rows``
    pooled rows a tile; ``smem_of(rows, max_cols)``: the launch's
    shared-memory bytes; ``holds(smem_bytes)``: the CTAs the card holds at
    once at that much shared memory."""
    H2, W2 = H // 2, W // 2
    rows = min(rows, H2)
    col_tiles = -(-W2 // TILE_COL_CAP)
    max_cols = -(-W2 // col_tiles)
    chunks = -(-C // TILE_CHUNK)
    tiles = B * -(-H2 // rows) * col_tiles * chunks
    smem = smem_of(rows, max_cols)
    return TilePlan(rows, col_tiles, chunks, tiles, min(tiles, holds(smem)),
                    smem)


def stem_plan(B: int, H: int, W: int, C: int, stats: bool, bf16: bool,
              holds: Callable[[int], int], rows: int = TILE_ROWS) -> TilePlan:
    """The plan of K8 (``stats`` True) or K1's bf16 serving call. Two bands
    of the image's raw elements (one tile's and the next one's, in flight),
    each a column wider on both sides than K9's, so that its rows start at
    even image columns."""
    extra = _K8_BUFFER_FLOATS if stats else _K1_BUFFER_FLOATS
    elem = 2 if bf16 else 4
    return tile_plan(B, H, W, C, lambda rows, cols: -(-2 * (2 * rows + 2) * (
        2 * cols + 4) * elem // 16) * 16 + 4 * extra, holds, rows)


def _lib():
    from crnn_ocr_torch.kernels import _build

    return _build, _build.load("fused_stem")


# CTAs the card holds at once, per (device, C entry, bf16, flag, shared
# memory)
_holds: Dict[Tuple[int, str, bool, bool, int], int] = {}


def card_holds(dev, entry: str, bf16: bool, flag: bool, smem: int) -> int:
    """``entry`` (``crnn_stem_bwd_ctas_per_sm``, flag K10; or
    ``crnn_stem_mma_ctas_per_sm``, flag K8) asked for its kernel's CTAs an
    SM holds, times the card's SMs."""
    key = (dev.index, entry, bf16, flag, smem)
    if key not in _holds:
        build, lib = _lib()
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = fn(int(bf16), int(flag), smem, ctypes.byref(per_sm))
        build.check(lib, err, entry)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _holds[key] = per_sm.value * sms
    return _holds[key]


def stem_design(img, C: int, stats: bool, rows: int = TILE_ROWS) -> TilePlan:
    """The plan K8 (``stats`` True) or K1's bf16 serving call launches with
    for this CUDA image and C channels."""
    B, H, W = img.shape[0], img.shape[1], img.shape[2]
    bf16 = img.dtype == torch.bfloat16
    return stem_plan(B, H, W, C, stats, bf16, lambda smem: card_holds(
        img.device, "crnn_stem_mma_ctas_per_sm", bf16, stats, smem), rows)


def on_card(entry, img, tensors):
    """Raise unless the image and every operand are on one CUDA device and
    the pooled pixels fit the kernels' 32-bit indices."""
    dev = img.device
    if dev.type != "cuda":
        raise RuntimeError(f"{entry}: no kernel for {dev}")
    for t in tensors:
        if t.device != dev:
            raise RuntimeError(f"{entry}: an operand is on {t.device}, the "
                               f"image on {dev}")
    B, H, W = img.shape[0], img.shape[1], img.shape[2]
    npix = B * (H // 2) * (W // 2)
    if npix >= 2 ** 31:
        raise ValueError(f"{entry}: at most 2^31 - 1 pooled pixels, got "
                         f"{npix}")


def call(entry, args, dev):
    """Call C entry ``entry`` of ``csrc/fused_stem.cu`` with ``args``
    (pointers as ``ctypes.c_void_p``, the rest ints) on ``dev``'s current
    stream, and raise on a CUDA error."""
    build, lib = _lib()
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [type(a) if isinstance(a, ctypes.c_void_p) else ctypes.c_int
                   for a in args] + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, entry)


def ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def taps(conv_w):
    """The f32 weights as the kernels read them, (3, 3, C) with tap kh * 3 +
    kw at [kh, kw]: the model's HWIO view of its OIHW weights needs no copy
    (its strides go to the kernel)."""
    t = conv_w.float()[:, :, 0]
    return t if t.stride(0) == 3 * t.stride(1) else t.contiguous()


def launch_mma(img, conv_w, scale=None, bias=None, rows: int = TILE_ROWS):
    """Launch ``stem_mma_kernel``: K8 (``scale`` None; returns the sum of
    the CTAs' partials, (2, C) f32, which the C entry's second kernel adds
    in CTA order) or K1's bf16 serving call with the folded ``scale`` and
    ``bias`` (returns the pooled output). The weights go as they are (f32,
    read through their strides); no kernel runs before the launch. Counts
    nothing: its callers count their launches."""
    stats = scale is None
    vecs = () if stats else (scale, bias)
    on_card("crnn_stem_mma", img, (conv_w, *vecs))
    B, H, W, C = img.shape[0], img.shape[1], img.shape[2], conv_w.shape[-1]
    plan = stem_design(img, C, stats, rows)
    w = taps(conv_w)
    vecs = [v.float().contiguous() for v in vecs] + [None] * (2 - len(vecs))
    img = img.contiguous()
    if stats:
        parts = torch.empty((plan.ctas, 2, C), dtype=torch.float32,
                            device=img.device)
        out = torch.empty((2, C), dtype=torch.float32, device=img.device)
    else:
        parts = None
        out = torch.empty((B, H // 2, W // 2, C), dtype=img.dtype,
                          device=img.device)
    call("crnn_stem_mma",
         [ptr(img), ptr(w), w.stride(1), w.stride(2),
          *map(ptr, vecs), ptr(parts), ptr(out), B, H, W, C,
          int(img.dtype == torch.bfloat16), int(stats), plan.rows,
          plan.col_tiles, plan.ctas, plan.smem_bytes], img.device)
    return out
