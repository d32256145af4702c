"""The GRU's backward on the card (``crnn_ocr_torch/kernels/csrc/bigru.cu::
bigru_bwd_kernel``): which shapes take it, and its arithmetic modelled on
the CPU, where the card cannot run.

``backward_design_for`` is a pure function of (H, B, dtype): the kernel at
``fonts-hard``'s training shape (bf16, H 256) and ``fonts-small``'s (f32,
H 128), the plain loop past 256 padded units and at widths no cluster
splits into multiples of 8 units.

The kernel splits each step's product ``drec . U^T`` over K: CTA c of a
cluster multiplies its own units' drec (3 upc columns) by U's columns of
those units into a share of every unit's dh, and each unit's owner adds the
C shares in rank order. The products run in TF32 on the tensor cores with
drec split hi + lo; a bf16 U is a TF32 value, so two products (U.hi, U.lo)
are the whole 3xTF32 product; an f32 U is split too (three products).
``kernel_model`` repeats that arithmetic (the tensor cores' own f32
accumulation order left out: each product is summed in f64 and rounded)
and is held to ``bigru_backward_plain`` and to the JAX package's ``_bwd``
at rtol 1e-5 (f32: ~1e-7 a term, carried through T steps). One TF32
product (hi alone) misses that, which is why the kernel keeps two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_tpu.kernels.bigru import _bwd

BF16, F32 = torch.bfloat16, torch.float32


def _res(cluster, rows):
    return tbg.Design("resident", cluster, rows)


@pytest.mark.parametrize("H,B,dtype,want", [
    # train-hard: fonts-hard, B 1024 (no rows fit one wave: the most rows
    # that fit, 40: 52 clusters, two waves of the card's 30)
    (256, 1024, BF16, _res(4, 40)),
    # the card tests' and chip_smoke's training batches
    (256, 128, BF16, _res(4, 16)),
    (256, 37, BF16, _res(4, 8)),
    (256, 1000, BF16, _res(4, 40)),
    (256, 256, BF16, _res(4, 32)),  # 64 CTAs: one wave
    # fonts-small trains in f32 at H 128 (2 CTAs of 64 units)
    (128, 128, F32, _res(2, 8)),
    (128, 13, F32, _res(2, 8)),
    (128, 128, BF16, _res(2, 8)),
    (128, 1024, F32, _res(2, 32)),  # 128 CTAs of the 132
    # f32 at 256 units: U's f32 columns of 64 units do not fit beside the
    # buffers, so 8 CTAs of 32
    (256, 128, F32, _res(8, 32)),
    (256, 16, F32, _res(8, 8)),
    # padded widths: 40 -> 48 units in one CTA; 240 in 5 CTAs of 48
    (40, 4, BF16, _res(1, 8)),
    (240, 5, BF16, _res(5, 8)),
    # the plain loop: past 256 padded units, and 208 (13 x 16), which no
    # cluster of at most 8 splits into multiples of 8 units of at most 64
    (272, 8, BF16, tbg.PLAIN),
    (1024, 3, F32, tbg.PLAIN),
    (208, 8, BF16, tbg.PLAIN),
])
def test_backward_design_for_shape(H, B, dtype, want):
    assert tbg.backward_design_for(H, B, dtype) == want


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_every_backward_design_fits_the_card(dtype):
    """For every H up to 256 and a range of batches: the kernel's
    constraints (a multiple of 8 units a CTA, at most 64, at most 8 CTAs,
    all units covered), its shared memory within an H100 block's, rows of
    the compiled instances, the fewest clusters that fit, and the rows the
    fewest whose grid fits the capacity table, else the most that fit."""
    elem = 2 if dtype == BF16 else 4
    for H in range(1, 257):
        hp = -(-H // 16) * 16
        for B in (1, 3, 13, 64, 128, 200, 256, 1000, 1024):
            d = tbg.backward_design_for(H, B, dtype)
            if d == tbg.PLAIN:
                assert not any(
                    hp % c == 0 and (hp // c) % 8 == 0 and hp // c <= 64
                    and tbg.bwd_smem(hp, c, 16, elem) <= tbg.SMEM_BYTES
                    for c in range(1, 9)), (H, B)
                continue
            upc = hp // d.cluster
            assert d.name == "resident" and 1 <= d.cluster <= 8
            assert upc * d.cluster == hp and upc % 8 == 0 and upc <= 64
            assert d.rows in tbg.BWD_ROWS
            assert tbg.bwd_smem(hp, d.cluster, d.rows, elem) <= 232448
            assert all(hp % c or (hp // c) % 8 or hp // c > 64
                       or tbg.bwd_smem(hp, c, 16, elem) > tbg.SMEM_BYTES
                       for c in range(1, d.cluster))
            fits = [r for r in tbg.BWD_ROWS
                    if tbg.bwd_smem(hp, d.cluster, r, elem)
                    <= tbg.SMEM_BYTES]
            wave = [r for r in fits if -(-B // r) * 2 * d.cluster
                    <= tbg.BWD_WAVE_CTAS.get((dtype, hp, d.cluster, r),
                                             tbg.BWD_DEFAULT_CTAS)]
            assert d.rows == (wave[0] if wave else fits[-1])


@pytest.mark.parametrize("T,B,want", [
    (64, 1024, 32),  # train-hard: 32 chunks of 2 steps (2,048 rows)
    (32, 128, 2),  # fonts-small's training batch
    (6, 1000, 2),
    (5, 13, 1),
    (64, 37, 1),  # no chunk of fewer steps holds 2,048 rows
])
def test_du_splits(T, B, want):
    assert tbg.du_splits(T, B) == want


def test_bwd_smem_at_the_main_path_shapes():
    """The kernel's header arithmetic: 193 KB at H 256, C 4, R 32 in bf16
    (U's columns 100 KB, drec 25 KB, the shares 68 KB); f32 at H 256 on 8
    CTAs of 32 units."""
    assert tbg.bwd_smem(256, 4, 32, 2) == 102400 + 25600 + 69632
    assert tbg.bwd_smem(256, 4, 16, 4) > tbg.SMEM_BYTES
    assert tbg.bwd_smem(256, 8, 32, 4) == 106496 + 13312 + 73728


def _case(seed, T=5, B=6, H=32, dtype=F32):
    rng = np.random.default_rng(seed)
    xw = torch.from_numpy(rng.normal(size=(T, 2, B, 3 * H))
                          .astype(np.float32)).to(dtype)
    u = torch.from_numpy((rng.normal(size=(2, H, 3 * H)) / np.sqrt(H))
                         .astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.normal(size=(2, 3 * H)) * 0.1)
                         .astype(np.float32))
    hs, gates = tbg.bigru_train(xw, u, b)
    g = torch.from_numpy(rng.normal(size=(T, 2, B, H)).astype(np.float32)
                         ).to(dtype)
    return g, u, hs, gates


def _tf32(x):
    """x's top 19 bits: sign, exponent and 10 mantissa bits (TF32), as
    ``split_tf32``'s hi and as the tensor cores read an operand."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def kernel_model(g, u, hs, gates, cluster: int, terms: int = 2):
    """The kernel's backward on the CPU: per step the elementwise part in
    JAX's order, the product split over ``cluster`` CTAs' K parts, each
    with drec split hi + lo (``terms=1``: hi alone) and, for an f32 U, U
    split too (lo(U) hi(drec) the third product), the shares added in rank
    order; dU and db as the wrapper forms them. Returns (dxw, du, db)."""
    T, D, B, H = hs.shape
    upc = H // cluster
    uf = u.float()
    split_u = u.dtype == F32
    z, r, hh, rh = gates.reshape(T, D, B, 4, H).unbind(3)
    f64 = torch.float64
    dxw = torch.empty((T, D, B, 3 * H))
    drec = torch.empty((D, T, B, 3 * H))
    h_prev = torch.zeros((D, T, B, H))
    carry = torch.zeros((D, B, H))
    for t in range(T - 1, -1, -1):
        hp = hs[t - 1].float() if t else torch.zeros((D, B, H))
        dh = carry + g[t].float()
        da_z = dh * (hp - hh[t]) * z[t] * (1 - z[t])
        da_h = dh * (1 - z[t]) * (1 - hh[t] * hh[t])
        da_r = da_h * rh[t] * r[t] * (1 - r[t])
        dr = torch.cat([da_z, da_r, da_h * r[t]], -1)
        dxw[t] = torch.cat([da_z, da_r, da_h], -1)
        drec[:, t], h_prev[:, t] = dr, hp
        shares = []
        for c in range(cluster):
            cols = torch.cat([q * H + c * upc + torch.arange(upc)
                              for q in range(3)])
            d_c, u_c = dr[..., cols], uf[..., cols].transpose(1, 2)
            hi = _tf32(d_c)
            lo = _tf32(d_c - hi)
            u_hi = _tf32(u_c) if split_u else u_c
            p = torch.bmm(hi.to(f64), u_hi.to(f64))
            if terms > 1:
                p = p + torch.bmm(lo.to(f64), u_hi.to(f64))
                if split_u:
                    p = p + torch.bmm(hi.to(f64),
                                      _tf32(u_c - u_hi).to(f64))
            shares.append(p.float())
        total = shares[0]
        for p in shares[1:]:
            total = total + p
        carry = dh * z[t] + total
    S = tbg.du_splits(T, B)
    du = torch.bmm(h_prev.reshape(D * S, T * B // S, H).transpose(1, 2),
                   drec.reshape(D * S, T * B // S, 3 * H)).view(
                       D, S, H, 3 * H).sum(1)
    return dxw.to(hs.dtype), du.to(u.dtype), drec.sum(dim=(1, 2))


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_kernel_model_holds_to_the_plain_loop_and_jax(cluster):
    g, u, hs, gates = _case(3)
    got = kernel_model(g, u, hs, gates, cluster)
    plain = tbg.bigru_backward_plain(g, u, hs, gates)
    jax_out = _bwd(True, (jnp.asarray(u.numpy()), jnp.asarray(hs.numpy()),
                          jnp.asarray(gates.numpy())), jnp.asarray(g.numpy()))
    for a, b, w in zip(got, plain, jax_out):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * scale)


def test_one_tf32_product_misses_the_bound():
    """drec's hi alone (one TF32 product) errs by ~1e-4 of the terms: the
    reason the kernel keeps lo's product."""
    g, u, hs, gates = _case(3)
    got = kernel_model(g, u, hs, gates, 2, terms=1)
    plain = tbg.bigru_backward_plain(g, u, hs, gates)
    err = max(float(((a - b).abs() / (1e-6 * b.abs().max() + b.abs()))
                     .max()) for a, b in zip(got, plain))
    assert err > 1e-4, err


def test_bf16_u_makes_two_tf32_products_the_whole_three():
    """A bf16 value widened to f32 is a TF32 value (its low 16 bits are 0),
    so U's lo is 0 and the third product of 3xTF32, lo(U) hi(drec), adds
    nothing: the kernel's two products for a bf16 U equal the three, bit
    for bit, here on the model."""
    g, u, hs, gates = _case(4, dtype=BF16)
    uf = u.float()
    assert torch.equal(_tf32(uf), uf)
    two = kernel_model(g, u, hs, gates, 2)
    # the same model with U taken as f32: U split, three products
    three = kernel_model(g.float(), uf, hs.float(), gates, 2)
    for a, b in zip(two, three):
        assert torch.equal(a.float(), b.to(a.dtype).float())


def test_kernel_model_bf16_holds_to_the_plain_loop():
    g, u, hs, gates = _case(5, T=6, B=3, H=48, dtype=BF16)
    got = kernel_model(g, u, hs, gates, 1)
    plain = tbg.bigru_backward_plain(g, u, hs, gates)
    assert [t.dtype for t in got] == [BF16, BF16, F32]
    for a, b in zip(got, plain):
        np.testing.assert_allclose(
            a.float().numpy(), b.float().numpy(), rtol=2.0 ** -7,
            atol=1e-6 * float(b.float().abs().max()))


def test_backward_on_cpu_runs_the_plain_loop():
    """A CPU tensor takes the plain loop whatever its shape (no launch);
    the autograd Function's gradients are the plain loop's."""
    g, u, hs, gates = _case(6, H=64)
    n, ran = tbg.backward_launches, dict(tbg.backward_design_launches)
    got = tbg.bigru_backward(g, u, hs, gates)
    want = tbg.bigru_backward_plain(g, u, hs, gates)
    assert tbg.backward_launches == n
    assert dict(tbg.backward_design_launches) == ran
    for a, b in zip(got, want):
        assert torch.equal(a, b)
