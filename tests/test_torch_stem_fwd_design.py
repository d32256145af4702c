"""The window tile of K1's bf16 serving call and K8
(``csrc/fused_stem.cu::stem_mma_kernel``), checked on the CPU where it is
plain Python or plain arithmetic.

* ``_stem_tiles.stem_plan``: the tiles cover every pooled row and
  column exactly once per 64-channel chunk, the chunks cover every channel,
  the grid is one wave (no more CTAs than tiles or than the card holds),
  and the shared memory stays within the H100's 232,448 bytes a CTA, for
  K8 (``stats``) and K1, at the card tests' shapes of both kernels, at the
  training buckets 64-256 and at the serving batch of 256.
* The window tile's fragment map, a numpy model assembled from mma's
  layouts in the PTX ISA (``mma.m16n8k16`` with ``.bf16`` operands;
  ``mma.m16n8k8`` with ``.tf32``, K8's f32 mode): each lane's A values as
  the kernel reads them from the staged band (``window_values``, then
  ``WinBf16::set_a`` / ``WinTf32::set_a``) and its B values
  (``load_taps``) placed where the layouts put them, multiplied, and each
  lane's accumulators read back through the C layout. They equal the
  conv's z, and lane (g, t) holds all four window positions of pixel g
  for channels 2t and 2t + 1 of each product.
* K8's f32 mode: every operand split hi + lo (hi x's low 13 mantissa bits
  cleared, each part as the tensor cores read it in TF32), three products
  summed in float64: the sums stay within 1e-5 of the sum of their terms'
  magnitudes of ``stem_stats_plain`` (the card tests' tolerance, with no
  1e-6 added), and each z's dropped terms within 2^-18 of its sum of
  |tap * x|.
* On the CPU the wrappers take their plain versions and count no launch;
  the tensor-core launcher refuses a CPU image.
"""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from crnn_ocr_torch.kernels import _stem_tiles as stiles
from crnn_ocr_torch.kernels import fused_stem as fs
from crnn_ocr_torch.kernels import fused_stem_train as fst

CARD_HOLDS = 3 * 132  # three CTAs a SM on 132 SMs
SMEM_LIMIT = 232448  # bytes of shared memory a CTA can use on the H100

# K8's card-test shapes (tests/test_torch_cuda.py), K1's, the training
# buckets and fonts-hard's serving batch
K8_SHAPES = [(128, 32, 128, 64), (4, 32, 48, 8), (3, 6, 10, 12),
             (2, 32, 66, 64), (1, 4, 4, 1000), (2, 10, 520, 20),
             (3, 6, 14, 18), (16, 32, 256, 64), (5, 26, 262, 70)]
K1_SHAPES = [(4, 32, 48, 8), (3, 32, 256, 64), (2, 32, 66, 12),
             (1, 6, 10, 64), (2, 32, 66, 130)]
BUCKETS = [(128, 32, w, 64) for w in (64, 128, 192, 256)]
SERVE = [(256, 32, w, 64) for w in (64, 128, 256)]


def _tiles(plan, B, H, W):
    """(channel chunk, image, pooled rows, pooled columns) of each tile, as
    the kernel's ``Tile`` decodes tile i: chunk, image, row tile, column
    tile, the column tile fastest."""
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


@pytest.mark.parametrize("stats,bf16", [(True, True), (True, False),
                                        (False, True)],
                         ids=["K8-bf16", "K8-f32", "K1-bf16"])
@pytest.mark.parametrize("shape", sorted(set(K8_SHAPES + K1_SHAPES +
                                             BUCKETS + SERVE)))
def test_stem_plan_covers_every_pixel_once_within_shared_memory(shape,
                                                                stats, bf16):
    B, H, W, C = shape
    plan = stiles.stem_plan(B, H, W, C, stats, bf16, lambda smem: CARD_HOLDS)
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
    # two bands of raw elements (a column wider on each side than the
    # tile's halo), 16-byte aligned, then K8's warps' sums or K1's scale,
    # bias and staging
    max_cols = -(-W2 // plan.col_tiles)
    band = (2 * plan.rows + 2) * (2 * max_cols + 4) * (2 if bf16 else 4)
    extra = 8 * 2 * 64 if stats else 2 * 64 + 8 * 8 * 36
    assert plan.smem_bytes == -(-2 * band // 16) * 16 + 4 * extra


def test_stem_plan_asks_the_card_at_its_own_shared_memory():
    asked = []

    def holds(smem):
        asked.append(smem)
        return 100

    plan = stiles.stem_plan(256, 32, 256, 64, False, True, holds)
    assert asked == [plan.smem_bytes]
    assert plan.tiles == 256 * 2 and plan.ctas == 100


# mma's fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16 with
# floating point type" and "for mma.m16n8k8" with .tf32): lane = 4 g + t
# holds element i of its fragment at (row, column)

def _a16(g, t, i):  # A 16 x 16, 8 bf16 elements in 4 registers
    row = g + 8 * ((i >> 1) & 1)
    col = 2 * t + (i & 1) + 8 * (i >= 4)
    return row, col


def _b16(g, t, i):  # B 16 x 8, 4 bf16 elements in 2 registers
    return 2 * t + (i & 1) + 8 * (i >= 2), g


def _a8(g, t, i):  # A 16 x 8, 4 tf32 elements
    return g + 8 * (i & 1), t + 4 * (i >= 2)


def _b8(g, t, i):  # B 8 x 8, 2 tf32 elements
    return t + 4 * i, g


def _c(g, t, i):  # C/D 16 x 8, 4 f32 elements
    return g + 8 * (i >= 2), 2 * t + (i & 1)


def _band(img, r0, nr, c0, tw):
    """A tile's staged band (``stage_band_async``): image rows 2 r0 - 1 ..
    2 (r0 + nr), columns 2 c0 - 2 .. 2 (c0 + tw) + 1, zero outside the
    image."""
    pad = np.pad(img, 2)
    return pad[2 * r0 + 1:2 * r0 + 2 * nr + 3, 2 * c0:2 * c0 + 2 * tw + 4]


def _window_values(band, pixel, ja, jb, t0):
    """``window_values``: the lane's taps ja, jb and (t = 0) 8 at window
    positions 0-3 of pooled pixel (r, x) of the tile; zeros for a pixel
    past the tile (None)."""
    v = np.zeros((4, 3))
    if pixel is None:
        return v
    r, x = pixel
    for k in range(4):  # the patch starts one column into the band
        y0, x0 = 2 * r + (k >> 1), 2 * x + 1 + (k & 1)
        for s, j in enumerate((ja, jb, 8)):
            if s < 2 or t0:
                v[k, s] = band[y0 + j // 3, x0 + j % 3]
    return v


def _lane_z(mode, band, pix, taps):
    """Every lane's accumulators for one product: A and B assembled from
    the lanes' fragments through mma's layouts, the product, and D read
    back through the C layout. pix: the 8 pooled pixels (r, x) of the
    window tile, None past the tile; taps (9, 8): the product's channels.
    Returns d[g][t] of shape (2 m-tiles, 4)."""
    k_steps = 1 if mode == "bf16" else 2
    kdim = 16 if mode == "bf16" else 8
    A = np.full((2, k_steps, 16, kdim), np.nan)
    Bm = np.full((k_steps, kdim, 8), np.nan)
    for g in range(8):
        for t in range(4):
            ja, jb = (2 * t, 2 * t + 1) if mode == "bf16" else (t, t + 4)
            v = _window_values(band, pix[g], ja, jb, t == 0)
            w8 = taps[8, g] if t == 0 else 0.0
            if mode == "bf16":  # WinBf16::set_a, set_b: registers lo, hi
                for m in range(2):
                    regs = [(v[2 * m][0], v[2 * m][1]),
                            (v[2 * m + 1][0], v[2 * m + 1][1]),
                            (v[2 * m][2], 0.0), (v[2 * m + 1][2], 0.0)]
                    elems = [e for reg in regs for e in reg]
                    for i, e in enumerate(elems):
                        A[(m, 0) + _a16(g, t, i)] = e
                elems = [taps[ja, g], taps[jb, g], w8, 0.0]
                for i, e in enumerate(elems):
                    Bm[(0,) + _b16(g, t, i)] = e
            else:  # WinTf32::set_a, set_b
                for m in range(2):
                    x = [[v[2 * m][0], v[2 * m + 1][0], v[2 * m][1],
                          v[2 * m + 1][1]], [v[2 * m][2], v[2 * m + 1][2],
                                             0.0, 0.0]]
                    for s in range(2):
                        for i in range(4):
                            A[(m, s) + _a8(g, t, i)] = x[s][i]
                for s, elems in enumerate(([taps[ja, g], taps[jb, g]],
                                           [w8, 0.0])):
                    for i, e in enumerate(elems):
                        Bm[(s,) + _b8(g, t, i)] = e
    assert not np.isnan(A).any() and not np.isnan(Bm).any()  # all placed
    D = np.einsum("msik,skn->min", A, Bm)
    return np.array([[[[D[(m,) + _c(g, t, i)] for i in range(4)]
                       for m in range(2)] for t in range(4)]
                     for g in range(8)])


@pytest.mark.parametrize("mode", ["bf16", "tf32"])
def test_window_tile_fragments_give_the_conv_with_a_window_in_one_lane(mode):
    """On a tile of 3 pooled rows by 5 columns at the bottom right of an
    image 10 x 14 (its band takes the SAME halo), in two window tiles (the
    second runs past the tile's 15 pixels), every lane's accumulators
    equal the conv's z of its own pixel, all four positions, channels 2t
    and 2t + 1; zero for a pixel past the tile."""
    rng = np.random.default_rng(7)
    H, W, C = 10, 14, 8
    img = rng.integers(-8, 9, size=(H, W)) / 8.0
    w = rng.integers(-16, 17, size=(3, 3, C)) / 16.0
    z = F.conv2d(torch.from_numpy(img)[None, None],
                 torch.from_numpy(w).permute(2, 0, 1)[:, None],
                 padding=1)[0].numpy()  # (C, H, W), exact: small dyadics
    r0, nr, c0, tw = 2, 3, 2, 5
    band = _band(img, r0, nr, c0, tw)
    taps = w.reshape(9, C)
    for q0 in (0, 8):
        pix = [divmod(q0 + g, tw) if q0 + g < nr * tw else None
               for g in range(8)]
        d = _lane_z(mode, band, pix, taps)
        for g in range(8):
            for t in range(4):
                for m in range(2):
                    for i in range(2):
                        oy, ox = divmod(2 * m + i, 2)
                        for e in range(2):
                            want = 0.0
                            if pix[g] is not None:
                                r, x = pix[g]
                                want = z[2 * t + e, 2 * (r0 + r) + oy,
                                         2 * (c0 + x) + ox]
                            assert d[g, t, m, 2 * i + e] == want


def _tf32(x):
    """An f32 operand as the tensor cores read it in TF32: its low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def test_k8_split_tf32_stays_within_the_card_tolerance():
    rng = np.random.default_rng(22)
    B, H, W, C = 8, 32, 128, 64
    img = torch.from_numpy(rng.normal(size=(B, H, W, 1)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                         .astype(np.float32))
    want = fst.stem_stats_plain(img, w)
    x = F.unfold(img.permute(0, 3, 1, 2), 3, padding=1)  # (B, 9, H W)
    taps = w.reshape(9, C)
    (xh, xl), (th, tl) = _split(x), _split(taps)
    d = lambda a: a.double()  # noqa: E731
    z = sum(torch.einsum("bkl,kc->bcl", d(a), d(b))
            for a, b in ((xl, th), (xh, tl), (xh, th)))
    exact = torch.einsum("bkl,kc->bcl", d(x), d(taps))
    mag = torch.einsum("bkl,kc->bcl", d(x).abs(), d(taps).abs())
    assert float(((z - exact).abs() / mag.clamp(min=1e-300)).max()) <= \
        2.0 ** -18
    got = torch.stack([z.sum((0, 2)), (z * z).sum((0, 2))])
    scale = torch.stack([exact.abs().sum((0, 2)), (exact * exact).sum((0, 2))])
    err = (got - want.double()).abs()
    assert bool((err <= 1e-5 * scale).all()), float((err / scale).max())


def test_wrappers_take_plain_versions_on_the_cpu_and_launcher_refuses_it():
    """K1 (both designs), K8 and the training stem's autograd Function run
    their plain versions for a CPU image and count no launch;
    ``launch_mma`` refuses a CPU image."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.normal(size=(2, 4, 6, 1)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 1, 3)).astype(np.float32))
    gamma, beta = torch.ones(3), torch.zeros(3)
    scale, bias = fs.fold_bn(gamma, beta, torch.zeros(3), torch.ones(3))
    before = (fs.launches, dict(fs.design_launches), fst.stats_launches)
    for dt in (torch.float32, torch.bfloat16):
        x = img.to(dt)
        plain = fs.fused_stem_plain(x, w, scale, bias)
        assert torch.equal(fs.fused_stem_serve(x, w, scale, bias), plain)
        for design in ("mma", "conv9"):
            assert torch.equal(fs._forward(x, w, scale, bias, design), plain)
        assert torch.equal(fst.stem_stats(x, w), fst.stem_stats_plain(x, w))
        fst.fused_stem_train(x, w, gamma, beta)
    assert (fs.launches, dict(fs.design_launches),
            fst.stats_launches) == before
    with pytest.raises(RuntimeError, match="no kernel"):
        stiles.launch_mma(img.to(torch.bfloat16), w)
    with pytest.raises(RuntimeError, match="no kernel"):
        stiles.launch_mma(img.to(torch.bfloat16), w, scale, bias)


def test_k1_launches_read_as_the_sum_of_its_designs():
    """``fused_stem.launches`` is no counter of its own: it reads the sum of
    ``design_launches``, so the two cannot disagree."""
    saved = collections.Counter(fs.design_launches)
    try:
        fs.design_launches.clear()
        assert fs.launches == 0
        fs.design_launches.update({"mma": 3, "conv9": 2})
        assert fs.launches == 5
    finally:
        fs.design_launches.clear()
        fs.design_launches.update(saved)
    with pytest.raises(AttributeError):
        fs.no_such_counter


def test_stem_fwd_ptxas_keys_every_instance_apart():
    """chip_smoke.stem_fwd_ptxas on a canned ``nvcc -Xptxas -v`` report of
    K1's and K8's five instances and one of K9's: one key per instance,
    named by its wrapper, dtype and (K1) design."""
    import chip_smoke

    pre = "_ZN46_GLOBAL__N__8a6c2fe1_13_fused_stem_cu_55b765f5"
    names = {
        f"{pre}15stem_mma_kernelI13__nv_bfloat16Lb0EEEvPKT_NS_12Stem"
        f"OperandsEPviiiiiii": "fused_stem bfloat16 mma",
        f"{pre}15stem_mma_kernelI13__nv_bfloat16Lb1EEEvPKT_NS_12Stem"
        f"OperandsEPviiiiiii": "stem_stats bfloat16",
        f"{pre}15stem_mma_kernelIfLb1EEEvPKT_NS_12StemOperandsEPviiiiiii":
            "stem_stats float32",
        f"{pre}11stem_kernelI13__nv_bfloat16EEvPKT_PKfPS2_iiii":
            "fused_stem bfloat16 conv9",
        f"{pre}11stem_kernelIfEEvPKT_PKfPS1_iiii": "fused_stem float32 conv9",
    }
    lines, want = [], {}
    for i, (name, key) in enumerate(names.items()):
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"    {i} bytes stack frame, {2 * i} bytes spill stores, "
                  f"{3 * i} bytes spill loads",
                  f"ptxas info    : Used {60 + i} registers"]
        want[key] = dict(registers=60 + i, stack_bytes=i,
                         spill_store_bytes=2 * i, spill_load_bytes=3 * i)
    lines += [f"ptxas info    : Compiling entry function '{pre}15bwd_tile_"
              f"kernelIfLb0EEEvPKT_S3_NS_11BwdOperandsEPfiiiiii' for "
              f"'sm_90a'", "ptxas info    : Used 128 registers"]
    assert chip_smoke.stem_fwd_ptxas("\n".join(lines)) == want


def test_read_stem_design_requires_the_path_design():
    """chip_smoke.read_stem_design: every K1 launch of a counted run on the
    path's design (serving ``"mma"``, training ``"conv9"``); a run without
    K1 (an STN model's training) on none."""
    import chip_smoke

    saved = collections.Counter(fs.design_launches)
    try:
        fs.design_launches.clear()
        fs.design_launches["mma"] = 20
        assert chip_smoke.read_stem_design({"fused_stem": 20}, "serve",
                                           "x") == {"mma": 20}
        with pytest.raises(RuntimeError, match="expected"):
            chip_smoke.read_stem_design({"fused_stem": 20}, "train", "x")
        fs.design_launches["conv9"] = 1
        with pytest.raises(RuntimeError, match="expected"):
            chip_smoke.read_stem_design({"fused_stem": 21}, "serve", "x")
        fs.design_launches.clear()
        assert chip_smoke.read_stem_design({"fused_stem": 0}, "train",
                                           "x") == {}
    finally:
        fs.design_launches.clear()
        fs.design_launches.update(saved)
