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
    # ... else 16 (K5 at B 128 would take 128 CTAs at 8 rows, K2 at B 256
    # 256)
    ("gru", False, 256, 512, BF16, _res(4, 16)),
    ("lstm", True, 256, 256, BF16, _res(4, 16)),
    ("gru", False, 128, 1064, BF16, _res(2, 16)),
    ("lstm", True, 128, 800, BF16, _res(2, 16)),
    # 16 rows at the widths where 8 were not measured
    ("gru", False, 240, 8, BF16, _res(4, 16)),
    # no 3-CTA split of 160 units: 4 CTAs of 40
    ("lstm", True, 160, 8, BF16, _res(4, 16)),
    # more than 4 x 64 units, or f32: the streamed and f32 designs
    ("gru", False, 1024, 3, BF16, STREAMED),
    ("gru", False, 272, 256, BF16, STREAMED),
    ("lstm", True, 1024, 3, BF16, STREAMED),
    ("gru", False, 256, 256, F32, tbg.Design("f32")),
    ("lstm", True, 256, 128, F32, tbg.Design("f32")),
    # K3 and K4 stay on the streamed design whatever the shape
    ("gru", True, 256, 128, BF16, STREAMED),
    ("gru", True, 128, 128, BF16, STREAMED),
    ("lstm", False, 256, 256, BF16, STREAMED),
    ("lstm", False, 40, 4, BF16, STREAMED),
])
def test_design_for_shape(cell, stash, H, B, dtype, want):
    assert tbg.design_for(cell, stash, H, B, dtype) == want


@pytest.mark.parametrize("cell,stash", tbg.RESIDENT_KERNELS)
def test_every_resident_design_fits_the_card(cell, stash):
    """For every H up to 256 and a range of batches: at most 4 CTAs of at
    most 64 units, an even number each, all units covered; the U slice
    (one 64-row M-tile per gate) and two h buffers fit the 227 KB of shared
    memory a CTA may hold; 8 rows only at a measured width, while the grid
    is one wave, and no wave above what the H100's 132 SMs of 228 KB of
    shared memory could hold (1 KB of it reserved per CTA)."""
    for H in range(1, 257):
        hp = -(-H // 16) * 16
        for B in (1, 3, 13, 64, 128, 200, 256, 1000):
            d = tbg.design_for(cell, stash, H, B, BF16)
            assert d.name == RES
            upc = hp // d.cluster
            assert 1 <= d.cluster <= 4 and upc * d.cluster == hp
            assert upc % 2 == 0 and upc <= tbg.RESIDENT_UNITS
            smem = tbg.GATES[cell] * 64 * hp * 2 + 2 * d.rows * hp * 2
            assert smem <= 232448
            if d.rows == 8:
                wave = tbg.ROWS8_WAVE_CTAS[(cell, hp)]
                assert -(-B // 8) * 2 * d.cluster <= wave
                assert wave <= 132 * (233472 // (smem + 1024))
            else:
                assert d.rows == 16


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
