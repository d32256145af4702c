"""Which kernel design runs each recurrence on the card: a pure function of
(cell, stash, H, B, dtype) in ``crnn_ocr_torch/kernels/bigru.py``. No
card is needed: the choice is made before any launch, and the card tests
(``tests/test_torch_cuda.py``) assert that the launch took it."""

import pytest
import torch

from crnn_ocr_torch.kernels import bigru as tbg

BF16, F32 = torch.bfloat16, torch.float32
RES = "resident"


def _res(cluster, rows):
    return tbg.Design(RES, cluster, rows)


STREAMED = tbg.Design("streamed", 0, 16)
OLD_F32 = tbg.Design("f32")


@pytest.mark.parametrize("cell,stash,H,B,dtype,want", [
    # the main paths: K2 serving fonts-hard, K5 fine-tuning fonts-hard-lstm
    ("gru", False, 256, 256, BF16, _res(4, 16)),
    ("lstm", True, 256, 128, BF16, _res(4, 16)),
    # the card tests' shapes: ragged batches, H 128, 96 and the padded 40
    ("gru", False, 256, 13, BF16, _res(4, 8)),
    ("gru", False, 128, 8, BF16, _res(2, 8)),
    ("gru", False, 128, 3, BF16, _res(2, 8)),
    ("gru", False, 96, 5, BF16, _res(2, 16)),
    ("gru", False, 40, 4, BF16, _res(1, 16)),  # 48 units after padding
    ("lstm", True, 256, 13, BF16, _res(4, 8)),
    ("lstm", True, 128, 8, BF16, _res(2, 8)),
    ("lstm", True, 128, 3, BF16, _res(2, 8)),
    ("lstm", True, 40, 4, BF16, _res(1, 16)),
    # 8 rows while the grid is one wave: at 256 units 120 CTAs for the
    # LSTM, 248 for the GRU; at 128, 396 and 528 ...
    ("lstm", True, 256, 112, BF16, _res(4, 8)),
    ("gru", False, 256, 240, BF16, _res(4, 8)),
    ("gru", False, 128, 256, BF16, _res(2, 8)),
    ("lstm", True, 128, 792, BF16, _res(2, 8)),
    # ... else 16 where 16 fits (K5 at B 128 would take 128 CTAs at 8 rows,
    # K2 at B 256 256), else 32 where 32 fits (K5 at B 256: 128 CTAs at 16
    # rows, 64 at 32), else 16 (no measured instance holds K2's B 512)
    ("gru", False, 256, 512, BF16, _res(4, 16)),
    ("lstm", True, 256, 256, BF16, _res(4, 32)),
    ("gru", False, 128, 1064, BF16, _res(2, 16)),
    ("lstm", True, 128, 800, BF16, _res(2, 16)),
    # 16 rows at the widths where 8 were not measured
    ("gru", False, 240, 8, BF16, _res(4, 16)),
    # no 3-CTA split of 160 units: 4 CTAs of 40
    ("lstm", True, 160, 8, BF16, _res(4, 16)),
    # more than 4 x 64 units: the streamed design
    ("gru", False, 1024, 3, BF16, STREAMED),
    ("gru", False, 272, 256, BF16, STREAMED),
    ("lstm", True, 1024, 3, BF16, STREAMED),
    # the f32 GRU at 256 units: 4 CTAs of 64, 16 rows (8 rows would take
    # 256 CTAs; one f32 CTA an SM, so B 256 runs two waves either way)
    ("gru", False, 256, 256, F32, _res(4, 16)),
    # K5 f32 at fonts-hard-lstm's training shape: 8 CTAs of 32 units, 32
    # rows (64 CTAs, one wave of the 120 the card holds in clusters of 8;
    # 16 rows would take 128)
    ("lstm", True, 256, 128, F32, _res(8, 32)),
    # K3 and K4 on the resident design too: K3 fine-tuning fonts-hard and
    # fonts-small on 8 rows, K4 serving fonts-hard-lstm at B 256 on 32 rows
    # (64 CTAs, one wave; 16 rows would take 128, two waves)
    ("gru", True, 256, 128, BF16, _res(4, 8)),
    ("gru", True, 128, 128, BF16, _res(2, 8)),
    ("lstm", False, 256, 256, BF16, _res(4, 32)),
    ("lstm", False, 40, 4, BF16, _res(1, 16)),
    # K3 and K4 at other batches, K5 at the edges of the 16-row wave
    ("gru", True, 256, 64, BF16, _res(4, 8)),
    ("gru", True, 256, 256, BF16, _res(4, 16)),
    ("gru", True, 256, 13, BF16, _res(4, 8)),
    ("gru", True, 40, 4, BF16, _res(1, 16)),
    ("lstm", False, 256, 128, BF16, _res(4, 16)),
    ("lstm", False, 256, 13, BF16, _res(4, 8)),
    ("lstm", False, 128, 256, BF16, _res(2, 8)),
    ("lstm", False, 256, 480, BF16, _res(4, 32)),
    ("lstm", False, 256, 481, BF16, _res(4, 16)),
    ("lstm", True, 256, 240, BF16, _res(4, 16)),
    ("lstm", True, 256, 241, BF16, _res(4, 32)),
    # the streamed design above 4 x 64 units; K4 f32 at fonts-hard-lstm's
    # serving shape on 16 rows: no rows fit one wave (32 rows take 128
    # CTAs of the 120), and 16 rows' three waves were measured faster than
    # 32 rows' two
    ("gru", True, 1024, 128, BF16, STREAMED),
    ("lstm", False, 1024, 256, BF16, STREAMED),
    ("lstm", False, 256, 256, F32, _res(8, 16)),
    # the f32 GRU (K2, K3) on its resident design: fonts-small's serving
    # (B 256) and training (B 128) shapes on 8 rows, 2 CTAs of 64 units
    ("gru", False, 128, 256, F32, _res(2, 8)),
    ("gru", True, 128, 128, F32, _res(2, 8)),
    ("gru", False, 128, 128, F32, _res(2, 8)),
    ("gru", True, 128, 256, F32, _res(2, 8)),
    # the card tests' f32 shapes: 96 units in 2 CTAs of 48, 40 padded to 48
    # in one CTA (16 rows: widths not measured), 256 at a ragged batch
    ("gru", False, 96, 5, F32, _res(2, 16)),
    ("gru", True, 96, 5, F32, _res(2, 16)),
    ("gru", False, 40, 4, F32, _res(1, 16)),
    ("gru", True, 40, 4, F32, _res(1, 16)),
    ("gru", False, 256, 13, F32, _res(4, 8)),
    ("gru", True, 256, 128, F32, _res(4, 16)),  # 8 rows: 128 CTAs of 120
    # f32 past 256 units on the old design; the f32 LSTM up to 128 padded
    # units on the 64-unit tile (K4 at H 128, B 256: 2 CTAs of 64, 8 rows,
    # 128 CTAs of the 132 the card holds; 40 padded to 48 in one CTA), past
    # it on the 32-unit tile (144: 6 CTAs of 24; 13 rows of 256: 8 of 32)
    ("gru", True, 272, 128, F32, OLD_F32),
    ("gru", False, 1024, 3, F32, OLD_F32),
    ("lstm", False, 128, 256, F32, _res(2, 8)),
    ("lstm", True, 40, 4, F32, _res(1, 16)),
    ("lstm", True, 144, 5, F32, _res(6, 16)),
    ("lstm", False, 256, 13, F32, _res(8, 8)),
    ("lstm", False, 300, 8, F32, OLD_F32),
])
def test_design_for_shape(cell, stash, H, B, dtype, want):
    assert tbg.design_for(cell, stash, H, B, dtype) == want


@pytest.mark.parametrize("cell,stash", tbg.RESIDENT_KERNELS)
def test_every_resident_design_fits_the_card(cell, stash):
    """For every H up to 256 and a range of batches: at most 4 CTAs of at
    most 64 units, an even number each, all units covered; the U slice
    (one 64-row M-tile per gate) and two h buffers fit the 227 KB of shared
    memory a CTA may hold; the rows the fewest whose grid fits the measured
    capacity of their instance (one wave), 16 when none does; and no
    capacity above what the H100's 132 SMs of 228 KB of shared memory
    could hold (1 KB of it reserved per CTA)."""
    for H in range(1, 257):
        hp = -(-H // 16) * 16
        for B in (1, 3, 13, 64, 128, 200, 256, 1000):
            d = tbg.design_for(cell, stash, H, B, BF16)
            assert d.name == RES
            upc = hp // d.cluster
            assert 1 <= d.cluster <= 4 and upc * d.cluster == hp
            assert upc % 2 == 0 and upc <= tbg.RESIDENT_UNITS
            assert d.rows in tbg.RESIDENT_ROWS
            smem = tbg.GATES[cell] * 64 * hp * 2 + 2 * d.rows * hp * 2
            assert smem <= 232448
            fits = [r for r in tbg.RESIDENT_ROWS if -(-B // r) * 2 * d.cluster
                    <= tbg.WAVE_CTAS.get((BF16, cell, stash, hp, r), 0)]
            if fits:
                assert d.rows == fits[0]
                wave = tbg.WAVE_CTAS[(BF16, cell, stash, hp, d.rows)]
                assert -(-B // d.rows) * 2 * d.cluster <= wave
                assert wave <= 132 * (233472 // (smem + 1024))
            else:
                assert d.rows == 16


def test_resident_ptxas_keys_every_instance_apart():
    """chip_smoke.resident_ptxas on a canned ``nvcc -Xptxas -v`` report of
    every resident instance (both cells, with and without the stash, 8, 16
    and 32 rows) and a streamed one: one key per resident instance, named
    by its kernel and rows, none colliding, each with its own numbers."""
    import chip_smoke

    lines, want = [], {}
    instances = [(cell, stash, rows) for cell in ("gru", "lstm")
                 for stash in (False, True) for rows in tbg.RESIDENT_ROWS]
    for i, (cell, stash, rows) in enumerate(instances):
        c = {"gru": "7GruCell", "lstm": "8LstmCell"}[cell]
        name = (f"_ZN12_GLOBAL__N_121birnn_resident_kernelINS_{c}ELi{rows}"
                f"ELb{int(stash)}ENS_7ResBf16ELi64EEEvPKNT2_1TES6_PKfPS4_"
                f"Pfiiii")
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    {i} bytes stack frame, {2 * i} bytes spill stores, "
                  f"{3 * i} bytes spill loads",
                  f"ptxas info    : Used {100 + i} registers, used 1 "
                  f"barriers, 384 bytes cmem[0]"]
        key = f"bi{cell}{'_train' if stash else ''} R{rows}"
        want[key] = dict(registers=100 + i, stack_bytes=i,
                         spill_store_bytes=2 * i, spill_load_bytes=3 * i)
    streamed = ("_ZN12_GLOBAL__N_116birnn_mma_kernelINS_7GruCellELi256ELi6E"
                "Lb0EEEvPK13__nv_bfloat16S4_PKfPS2_Pfiii")
    lines += [f"ptxas info    : Compiling entry function '{streamed}' for "
              f"'sm_90a'",
              "ptxas info    : Used 64 registers, 384 bytes cmem[0]"]
    got = chip_smoke.resident_ptxas("\n".join(lines))
    assert len(want) == len(instances) == 12
    assert got == want
    assert chip_smoke.ptxas_key("lstm", True, 32) == "bilstm_train R32"


def test_launch_on_cpu_raises_and_wrappers_take_plain_versions():
    """The wrappers dispatch on the device only: a CPU tensor runs the
    plain version, and asking the launcher for a CPU tensor raises."""
    rng = torch.Generator().manual_seed(0)
    xw = torch.randn(3, 2, 4, 3 * 32, generator=rng).bfloat16()
    u = (torch.randn(2, 32, 3 * 32, generator=rng) * 0.1).bfloat16()
    b = torch.zeros(2, 3 * 32)
    before = dict(tbg.design_launches)
    torch.testing.assert_close(tbg.bigru_infer(xw, u, b),
                               tbg.bigru_plain(xw, u, b), rtol=0, atol=0)
    assert tbg.design_launches == before
    with pytest.raises(RuntimeError, match="no kernel"):
        tbg._launch("gru", xw, u, b, None, False)


@pytest.mark.parametrize("stash", (False, True))
def test_every_f32_resident_design_fits_the_card(stash):
    """The f32 GRU (K2, K3) for every H up to 256 and a range of batches:
    the resident design (its f32 instance), at most 4 CTAs of at most 64 units, an even
    number each, all units covered; the f32 U slice (three 64-row M-tiles)
    and two f32 h buffers fit the 227 KB of shared memory a CTA may hold;
    the rows the fewest of 8 and 16 whose grid fits the measured capacity
    of their instance, 16 when none does; no capacity above what 132 SMs
    could hold. Past 256 units the old ``"f32"`` design; the f32 LSTM on
    the resident design too (its own test below)."""
    for H in range(1, 257):
        hp = -(-H // 16) * 16
        for B in (1, 3, 13, 64, 128, 200, 256, 1000):
            d = tbg.design_for("gru", stash, H, B, F32)
            assert d.name == RES
            upc = hp // d.cluster
            assert 1 <= d.cluster <= 4 and upc * d.cluster == hp
            assert upc % 2 == 0 and upc <= tbg.RESIDENT_UNITS
            assert d.rows in tbg.F32_RESIDENT_ROWS
            smem = 3 * 64 * hp * 4 + 2 * d.rows * hp * 4
            assert smem <= 232448
            fits = [r for r in tbg.F32_RESIDENT_ROWS
                    if -(-B // r) * 2 * d.cluster
                    <= tbg.WAVE_CTAS.get((F32, "gru", stash, hp, r), 0)]
            if fits:
                assert d.rows == fits[0]
                wave = tbg.WAVE_CTAS[(F32, "gru", stash, hp, d.rows)]
                assert wave <= 132 * (233472 // (smem + 1024))
            else:
                assert d.rows == 16
    for H in (257, 300, 1024):
        assert tbg.design_for("gru", stash, H, 8, F32) == OLD_F32
    for H, want in ((8, _res(1, 16)), (128, _res(2, 8)), (256, _res(8, 8))):
        assert tbg.design_for("lstm", stash, H, 8, F32) == want


@pytest.mark.parametrize("stash", (False, True))
def test_every_f32_lstm_resident_design_fits_the_card(stash):
    """The f32 LSTM (K4, K5) for every H up to 256 and a range of batches:
    the resident design (its f32 instance); up to 128 padded units at most
    4 CTAs of the 64-unit tile, past it at most 8 (the portable maximum)
    of the 32-unit tile; units a CTA even, all units covered; U's f32 slice
    (four M-tiles of the tile's rows), two f32 h buffers and, on the
    32-unit tile, the K parts' handed partials (f32, 4 gates x 32 units x
    rows, 3 parts at 16 rows, else 1) within the 227 KB of shared memory a
    CTA may hold; the rows the fewest of 8, 16 and 32 whose grid fits the
    measured capacity of their instance, 16 when none does; no capacity
    above what 132 SMs could hold."""
    for H in range(1, 257):
        hp = -(-H // 16) * 16
        for B in (1, 3, 13, 64, 128, 200, 256, 1000):
            d = tbg.design_for("lstm", stash, H, B, F32)
            assert d.name == RES
            tile, most = (32, 8) if hp > 128 else (64, 4)
            assert tbg.resident_tile("lstm", hp, F32) == (tile, most)
            upc = hp // d.cluster
            assert 1 <= d.cluster <= most and upc * d.cluster == hp
            assert upc % 2 == 0 and upc <= tile
            assert d.rows in tbg.RESIDENT_ROWS
            parts = 1 if tile == 64 else 4 if d.rows == 16 else 2
            smem = (4 * tile * hp * 4 + 2 * d.rows * hp * 4
                    + (parts - 1) * 4 * tile * d.rows * 4)
            assert smem <= 232448
            fits = [r for r in tbg.RESIDENT_ROWS
                    if -(-B // r) * 2 * d.cluster
                    <= tbg.WAVE_CTAS.get((F32, "lstm", stash, hp, r), 0)]
            if fits:
                assert d.rows == fits[0]
                wave = tbg.WAVE_CTAS[(F32, "lstm", stash, hp, d.rows)]
                assert wave <= 132 * (233472 // (smem + 1024))
            else:
                assert d.rows == 16


@pytest.mark.parametrize("cell,H", [("gru", 40), ("gru", 96), ("gru", 128),
                                    ("gru", 256), ("gru", 300),
                                    ("lstm", 128), ("lstm", 256),
                                    ("lstm", 300)])
def test_f32_kernel_weights_round_trip(cell, H):
    """kernel_weights in f32: for the resident design (both cells) U padded
    to a multiple of 16 units and transposed, (2, n hp, hp) as [d][n][k],
    whose transpose gives U back with zeros in the padding; past 256
    units U itself (the old design's operand)."""
    n = tbg.GATES[cell]
    u = torch.randn(2, H, n * H, generator=torch.Generator().manual_seed(H))
    uk = tbg.kernel_weights(u)
    assert uk.dtype == F32 and uk.is_contiguous()
    if tbg.design_for(cell, False, H, 8, F32) == OLD_F32:
        assert torch.equal(uk, u)
        return
    hp = -(-H // 16) * 16
    assert tuple(uk.shape) == (2, n * hp, hp)
    back = uk.transpose(1, 2).reshape(2, hp, n, hp)
    assert torch.equal(back[:, :H, :, :H].reshape(2, H, n * H), u)
    assert not back[:, H:].any() and not back[..., H:].any()


def test_resident_ptxas_keys_the_f32_instances():
    """chip_smoke.resident_ptxas on the f32 instances' names (the operand
    policy and the tile's units as the kernel's last template arguments):
    keyed by the dtype after the kernel, the f32 LSTM's 32-unit tile apart
    from its 64-unit one, and the bf16 policy's names as the bf16 keys."""
    import chip_smoke

    lines, want = [], {}
    for i, (cell, ops, dtype, stash, rows, units) in enumerate((
            ("gru", "7ResBf16", "bfloat16", False, 16, 64),
            ("gru", "7ResTf32", "float32", False, 8, 64),
            ("gru", "7ResTf32", "float32", True, 16, 64),
            ("gru", "7ResBf16", "bfloat16", True, 32, 64),
            ("lstm", "7ResTf32", "float32", False, 16, 64),
            ("lstm", "7ResTf32", "float32", False, 16, 32),
            ("lstm", "7ResTf32", "float32", True, 32, 32))):
        c = {"gru": "7GruCell", "lstm": "8LstmCell"}[cell]
        name = (f"_ZN12_GLOBAL__N_121birnn_resident_kernelINS_{c}ELi{rows}"
                f"ELb{int(stash)}ENS_{ops}ELi{units}EEEvPKNT2_1TES6_PKfPS4_"
                f"Pfiiii")
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Used {90 + i} registers, used 1 "
                  f"barriers, 384 bytes cmem[0]"]
        want[chip_smoke.ptxas_key(cell, stash, rows, dtype, units)] = dict(
            registers=90 + i)
    got = chip_smoke.resident_ptxas("\n".join(lines))
    assert got == want
    assert sorted(got) == ["bigru R16", "bigru float32 R8",
                           "bigru_train R32", "bigru_train float32 R16",
                           "bilstm float32 R16", "bilstm float32 R16 U32",
                           "bilstm_train float32 R32 U32"]
