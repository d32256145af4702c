"""The f32 GRU's resident design multiplies in 3xTF32 on the tensor cores
(``crnn_ocr_torch/kernels/csrc/bigru.cu::ResTf32``): every operand x is
split into hi (x with its low 13 mantissa bits cleared, a TF32 value) and
lo = x - hi, and a product is hi.hi + hi.lo + lo.hi, the tensor cores
reading lo as its TF32 truncation. The card cannot run here, so this file
models that split in PyTorch and runs it through the GRU recurrence at
``fonts-small``'s width (H 128) over T 8:

* every step's recurrent product within 1e-6 of the sum of its terms'
  magnitudes of the exact product (f64) of the same h and U, which is what
  ``bigru_plain`` computes in f32 (its own f32 rounding is ~2^-24 of that
  sum a term): the split drops lo.lo and lo's truncation, each below 2^-20
  of a term and mostly far below;
* hs within 1e-6 of ``bigru_plain``'s (outputs in (-1, 1));
* hs within 1e-5 of the JAX package's f32 K2 (``bigru_pallas_raw``) in
  interpret mode, the tolerance ``tests/test_torch_kernels.py`` holds the
  plain version to.

A plain TF32 product (hi.hi alone) misses the first bound by two orders of
magnitude, which ``test_plain_tf32_misses_the_bound`` shows.

The f32 LSTM past 128 units (``fonts-hard-lstm``'s H 256) splits K over
the warps of each M-tile: each K part forms its own 3xTF32 partial (hi.hi
in one accumulator, lo.hi + hi.lo in another, added), and the owner of a
row adds the parts' partials in f32 in K order. The LSTM tests run that
through the LSTM recurrence of ``bigru._lstm_recurrence`` at H 256, T 8,
with 2 K parts (32 rows a cluster) and 4 (16 rows): within 1e-6 of
``bilstm_plain``, and within 1e-5 of the JAX package's f32 K4
(``bilstm_pallas_raw``) in interpret mode at a narrow width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_tpu.kernels.bigru import bigru_pallas_raw, bilstm_pallas_raw

H, T, B = 128, 8, 8  # fonts-small's n_units


def _tf32(x):
    """x's top 19 bits: sign, exponent and 10 mantissa bits (TF32)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)  # x - hi is exact in f32


def product_tf32x3(h, u, terms: int = 3):
    """h (D, B, H) . u (D, H, 3H) as the kernel forms it: the three (or,
    with ``terms=1``, one) products of split operands, summed in f64 and
    rounded to f32 (the tensor cores accumulate in f32, in an order this
    model leaves out)."""
    (hh, hl), (uh, ul) = _split(h), _split(u)
    f = torch.float64
    out = torch.bmm(hh.to(f), uh.to(f))
    if terms == 3:
        out = out + torch.bmm(hh.to(f), ul.to(f)) + torch.bmm(hl.to(f),
                                                             uh.to(f))
    return out.float()


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, 2, B, 3 * H)).astype(np.float32),
            (rng.normal(size=(2, H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (rng.normal(size=(2, 3 * H)) * 0.1).astype(np.float32))


def gru_tf32x3(xw, u, b, terms: int = 3):
    """The GRU recurrence of ``bigru._recurrence`` with the modelled
    product: hs (T, 2, B, H), and per step the product's largest error
    over the sum of its terms' magnitudes against the exact product."""
    h = torch.zeros((2, xw.shape[2], H))
    out, worst = [], 0.0
    for t in range(xw.shape[0]):
        p = product_tf32x3(h, u, terms)
        exact = torch.bmm(h.double(), u.double())
        scale = torch.bmm(h.abs().double(), u.abs().double())
        worst = max(worst, float(((p.double() - exact).abs()
                                  / scale.clamp(min=1e-30)).max()))
        rec = p + b[:, None, :]
        x = xw[t]
        z = torch.sigmoid(x[..., :H] + rec[..., :H])
        r = torch.sigmoid(x[..., H:2 * H] + rec[..., H:2 * H])
        hh = torch.tanh(x[..., 2 * H:] + r * rec[..., 2 * H:])
        h = z * h + (1.0 - z) * hh
        out.append(h)
    return torch.stack(out), worst


def test_split_is_exact_and_tf32():
    """hi + lo = x exactly; hi and the truncated lo are TF32 values (low 13
    bits clear); |lo| < 2^-10 |x|."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32)) * 3.0
    hi = _tf32(x)
    lo = x - hi
    assert torch.equal(hi + lo, x)
    for v in (hi, _tf32(lo)):
        assert not bool((v.view(torch.int32) & 8191).any())
    assert bool((lo.abs() < 2.0 ** -10 * x.abs()).all())


def test_tf32x3_recurrence_holds_to_the_plain_version():
    xw, u, b = (torch.from_numpy(a) for a in _inputs())
    hs, worst = gru_tf32x3(xw, u, b)
    assert worst <= 1e-6, worst
    np.testing.assert_allclose(hs.numpy(), tbg.bigru_plain(xw, u, b).numpy(),
                               rtol=0, atol=1e-6)


def test_tf32x3_recurrence_holds_to_jax_k2_interpret():
    xw, u, b = _inputs()
    want = bigru_pallas_raw(jnp.asarray(xw), jnp.asarray(u), jnp.asarray(b),
                            interpret=True)
    hs, _ = gru_tf32x3(*(torch.from_numpy(a) for a in (xw, u, b)))
    np.testing.assert_allclose(hs.numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=1e-5)


def test_plain_tf32_misses_the_bound():
    """One TF32 product (hi.hi) errs by ~1e-4 of the terms' magnitudes:
    the reason the kernel keeps three."""
    xw, u, b = (torch.from_numpy(a) for a in _inputs())
    _, worst = gru_tf32x3(xw, u, b, terms=1)
    assert worst > 1e-4, worst


def product_split_k(h, u, parts: int):
    """h (D, B, H) . u (D, H, G) as the f32 LSTM's kernel forms it on its
    32-unit tile: K cut into ``parts`` equal ranges (the warps' K parts);
    per part hi.hi and lo.hi + hi.lo each summed (in f64, rounded to f32:
    the order of the tensor cores' f32 accumulation is left out) and added
    in f32; then the parts' partials added in f32 in K order."""
    (hh, hl), (uh, ul) = _split(h), _split(u)
    f = torch.float64
    H = h.shape[-1]
    total = None
    for k in range(parts):
        ks = slice(k * H // parts, (k + 1) * H // parts)
        acc = torch.bmm(hh[..., ks].to(f), uh[:, ks].to(f)).float()
        cross = (torch.bmm(hh[..., ks].to(f), ul[:, ks].to(f))
                 + torch.bmm(hl[..., ks].to(f), uh[:, ks].to(f))).float()
        part = acc + cross
        total = part if total is None else total + part
    return total


def _lstm_inputs(Hn, Bn, seed=12):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, 2, Bn, 4 * Hn)).astype(np.float32),
            (rng.normal(size=(2, Hn, 4 * Hn)) / np.sqrt(Hn))
            .astype(np.float32))


def lstm_split_k(xw, u, parts: int):
    """The LSTM recurrence of ``bigru._lstm_recurrence`` (gates i|f|c|o, h
    and c in f32) with the modelled product: hs (T, 2, B, H), and per step
    the product's largest error over the sum of its terms' magnitudes
    against the exact product."""
    Hn = u.shape[1]
    h = torch.zeros((2, xw.shape[2], Hn))
    c = torch.zeros_like(h)
    out, worst = [], 0.0
    for t in range(xw.shape[0]):
        p = product_split_k(h, u, parts)
        exact = torch.bmm(h.double(), u.double())
        scale = torch.bmm(h.abs().double(), u.abs().double())
        worst = max(worst, float(((p.double() - exact).abs()
                                  / scale.clamp(min=1e-30)).max()))
        gates = xw[t] + p
        i = torch.sigmoid(gates[..., :Hn])
        f = torch.sigmoid(gates[..., Hn:2 * Hn])
        g = torch.tanh(gates[..., 2 * Hn:3 * Hn])
        o = torch.sigmoid(gates[..., 3 * Hn:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        out.append(h)
    return torch.stack(out), worst


@pytest.mark.parametrize("parts", (2, 4))
def test_lstm_split_k_recurrence_holds_to_the_plain_version(parts):
    xw, u = (torch.from_numpy(a) for a in _lstm_inputs(256, B))
    hs, worst = lstm_split_k(xw, u, parts)
    assert worst <= 1e-6, worst
    np.testing.assert_allclose(hs.numpy(), tbg.bilstm_plain(xw, u).numpy(),
                               rtol=0, atol=1e-6)


def test_lstm_split_k_recurrence_holds_to_jax_k4_interpret():
    xw, u = _lstm_inputs(32, B)
    want = bilstm_pallas_raw(jnp.asarray(xw), jnp.asarray(u), interpret=True)
    hs, _ = lstm_split_k(*(torch.from_numpy(a) for a in (xw, u)), parts=2)
    np.testing.assert_allclose(hs.numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=1e-5)
