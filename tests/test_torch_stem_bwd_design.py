"""The tiled design of K9 and K10 (``csrc/fused_stem.cu::bwd_tile_kernel``),
checked on the CPU where it is plain Python or plain arithmetic.

* ``fused_stem_train.bwd_plan``: the tiles cover every pooled row and
  column exactly once per 64-channel chunk, the chunks cover every channel,
  the grid is one wave (no more CTAs than tiles or than the card holds),
  and the shared memory stays within the H100's 232,448 bytes a CTA, at the
  card tests' shapes and at the training buckets 64-256. The plan is the
  same in both dtypes (the band is staged in f32 in both), so it takes
  none; K9's and K10's plans differ in their buffers and both are checked.
* K10's weight-gradient product on the tensor cores, emulated: d_conv
  split into TF32 hi (x's low 13 mantissa bits cleared) and lo = x - hi,
  which the tensor cores read as its own TF32 truncation; the taps exact
  in bf16 mode and split the same way in f32 mode (hi * hi + hi * lo +
  lo * hi); products summed in float64. It stays within 1e-5 of the sum
  of |tap * d_conv| of ``stem_bwd_final_plain`` (the card tests'
  tolerance, with no 1e-6 added) at a reduced fonts-small shape (B 8,
  32 x 128, C 64), and the dropped terms are within 2^-20 (bf16) and
  2^-18 (f32: the taps' lo truncated, and lo * lo dropped) of that sum. A
  product of hi alone is not: its error is above 1e-5 of it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from crnn_ocr_torch.kernels import _stem_tiles as stiles
from crnn_ocr_torch.kernels import fused_stem_train as fst

CARD_HOLDS = 2 * 132  # two CTAs a SM on 132 SMs, as ptxas is asked for
SMEM_LIMIT = 232448  # bytes of shared memory a CTA can use on the H100

SHAPES = [(128, 32, 128, 64), (4, 32, 48, 8), (3, 6, 10, 12),
          (2, 32, 66, 64), (1, 4, 4, 1000), (2, 10, 520, 20),
          (3, 6, 14, 18), (16, 32, 256, 64), (5, 26, 262, 70),
          (8, 32, 64, 64), (8, 2, 2, 1)]
BUCKETS = [(128, 32, w, 64) for w in (64, 128, 192, 256)]


def _tiles(plan, B, H, W):
    """(channel chunk, image, pooled rows, pooled columns) of each tile, as
    ``bwd_tile_kernel`` decodes tile i: chunk, image, row tile, column
    tile, the column tile fastest; column tile ct covers pooled columns
    ct * W2 // col_tiles up to (ct + 1) * W2 // col_tiles."""
    H2, W2 = H // 2, W // 2
    row_tiles = -(-H2 // plan.rows)
    spatial = B * row_tiles * plan.col_tiles
    for i in range(plan.tiles):
        chunk, s = divmod(i, spatial)
        s, ct = divmod(s, plan.col_tiles)
        b, rt = divmod(s, row_tiles)
        r0 = rt * plan.rows
        yield (chunk, b, range(r0, min(H2, r0 + plan.rows)),
               range(ct * W2 // plan.col_tiles,
                     (ct + 1) * W2 // plan.col_tiles))


@pytest.mark.parametrize("final", [False, True], ids=["K9", "K10"])
@pytest.mark.parametrize("shape", SHAPES + BUCKETS)
def test_plan_covers_every_pixel_once_within_shared_memory(shape, final):
    B, H, W, C = shape
    plan = fst.bwd_plan(B, H, W, C, final, lambda smem: CARD_HOLDS)
    H2, W2 = H // 2, W // 2
    seen = np.zeros((plan.chunks, B, H2, W2), np.int64)
    tiles = list(_tiles(plan, B, H, W))
    for chunk, b, rows, cols in tiles:
        assert 0 < len(rows) <= stiles.TILE_ROWS
        assert 0 < len(cols) <= stiles.TILE_COL_CAP
        seen[chunk, b, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert len(tiles) == plan.tiles
    assert (seen == 1).all()
    assert plan.chunks * stiles.TILE_CHUNK >= C > (plan.chunks - 1) * \
        stiles.TILE_CHUNK
    assert plan.ctas == min(plan.tiles, CARD_HOLDS)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_plan_asks_the_card_at_its_own_shared_memory():
    """``holds`` is asked at the plan's shared memory, and a card that holds
    fewer CTAs than there are tiles gets one wave of them."""
    asked = []

    def holds(smem):
        asked.append(smem)
        return 100

    plan = fst.bwd_plan(128, 32, 256, 64, True, holds)
    assert asked == [plan.smem_bytes]
    assert plan.tiles == 128 * 2 and plan.ctas == 100


def _tf32(x):
    """An f32 operand as the tensor cores read it in TF32: its low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """K10's split: hi = x truncated to TF32, lo = x - hi (exact in f32),
    each as the tensor cores read it."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _k10_operands(dtype, seed=21, B=8, H=32, W=128, C=64):
    """The image, weights, pooled gradient and K10's per-channel vectors,
    as the autograd Function derives them, and d_conv at every position."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(size=(B, H, W, 1)).astype(np.float32))
    img = img.to(dtype)
    w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, H // 2, W // 2, C))
                         .astype(np.float32)).to(dtype)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    beta = torch.from_numpy((rng.normal(size=C) * 0.3).astype(np.float32))
    n = float(B * H * W)
    st = fst.stem_stats_plain(img, w)
    mean = st[0] / n
    var = st[1] / n - mean * mean
    inv, scale, bias = fst.bwd_affine(gamma, beta, mean, var)
    p = fst.stem_bwd_partials_plain(img, w, g, mean, inv, scale, bias)
    vecs = (mean, inv, scale, bias, scale, p[0] / n, p[1] / n)
    z = fst._conv(img, w)
    d = fst._routed(z, g, scale, bias)
    ch = lambda v: v[:, None, None]  # noqa: E731
    xh = (z - ch(mean)) * ch(inv)
    dc = ch(vecs[4]) * ((d - ch(vecs[5])) - xh * ch(vecs[6]))
    taps = F.unfold(img.float().permute(0, 3, 1, 2), 3, padding=1)
    return img, w, g, vecs, taps, dc.reshape(B, C, H * W)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
def test_split_tf32_product_stays_within_the_card_tolerance(dtype):
    img, w, g, vecs, taps, dc = _k10_operands(dtype)
    want = fst.stem_bwd_final_plain(img, w, g, *vecs).reshape(9, -1)
    scale = torch.einsum("bkl,bcl->kc", taps.abs().double(),
                         dc.abs().double())
    exact = torch.einsum("bkl,bcl->kc", taps.double(), dc.double())
    dc_hi, dc_lo = _split(dc)
    if dtype == torch.bfloat16:
        assert torch.equal(_tf32(taps), taps)  # bf16 taps: exact in TF32
        pairs = [(taps, dc_hi), (taps, dc_lo)]
    else:
        t_hi, t_lo = _split(taps)
        pairs = [(t_hi, dc_hi), (t_hi, dc_lo), (t_lo, dc_hi)]
    got = sum(torch.einsum("bkl,bcl->kc", a.double(), b.double())
              for a, b in pairs)
    bound = 2.0 ** (-20 if dtype == torch.bfloat16 else -18)
    assert float(((got - exact).abs() / scale).max()) <= bound
    err = (got - want.double()).abs()
    assert bool((err <= 1e-5 * scale).all()), float((err / scale).max())
    hi_only = torch.einsum("bkl,bcl->kc", pairs[0][0].double(),
                           dc_hi.double())
    assert float(((hi_only - exact).abs() / scale).max()) > 1e-5


def test_stem_bwd_ptxas_keys_every_instance_apart():
    """chip_smoke.stem_bwd_ptxas on a canned ``nvcc -Xptxas -v`` report of
    K9's and K10's four instances and K8's: one key per instance of the
    tiled kernel, named by its wrapper and dtype, each with its numbers."""
    import chip_smoke

    lines, want = [], {}
    for i, (dt, final) in enumerate([(d, f) for d in ("f", "13__nv_bfloat16")
                                     for f in (0, 1)]):
        name = (f"_ZN46_GLOBAL__N__8a6c2fe1_13_fused_stem_cu_55b765f515"
                f"bwd_tile_kernelI{dt}Lb{final}EEEvPKT_S3_NS_11BwdOperands"
                f"EPfiiiiii")
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"    {i} bytes stack frame, {2 * i} bytes spill stores, "
                  f"{3 * i} bytes spill loads",
                  f"ptxas info    : Used {100 + i} registers"]
        key = (f"{'stem_bwd_final' if final else 'stem_bwd_partials'} "
               f"{'float32' if dt == 'f' else 'bfloat16'}")
        want[key] = dict(registers=100 + i, stack_bytes=i,
                         spill_store_bytes=2 * i, spill_load_bytes=3 * i)
    lines += ["ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__8a6"
              "c2fe1_13_fused_stem_cu_55b765f512stats_kernelIfEEvPKT_PKfPfiiii"
              "' for 'sm_90a'", "ptxas info    : Used 40 registers"]
    assert chip_smoke.stem_bwd_ptxas("\n".join(lines)) == want


def test_wrappers_take_plain_versions_on_the_cpu_and_launchers_refuse_it():
    """K9's and K10's wrappers run their plain versions for a CPU image and
    count no launch; their launcher refuses a CPU image."""
    img, w, g, vecs, _, _ = _k10_operands(torch.float32, B=2, H=4, W=6, C=3)
    before = (fst.partials_launches, fst.final_launches)
    torch.testing.assert_close(
        fst.stem_bwd_partials(img, w, g, *vecs[:4]),
        fst.stem_bwd_partials_plain(img, w, g, *vecs[:4]), rtol=0, atol=0)
    torch.testing.assert_close(fst.stem_bwd_final(img, w, g, *vecs),
                               fst.stem_bwd_final_plain(img, w, g, *vecs),
                               rtol=0, atol=0)
    assert (fst.partials_launches, fst.final_launches) == before
    with pytest.raises(RuntimeError, match="no kernel"):
        fst._launch_bwd(img, w, g, vecs, final=True)
