"""Port parity for the kernel modules: crnn_ocr_torch.kernels.*.

On the CPU each wrapper runs its plain PyTorch version, which is held here
to the JAX package's Pallas kernel in interpret mode on the same inputs:

* stem, f32: atol 1e-5 (f32 sums of 9 products in another order);
  bf16: the output is bf16, so within one bf16 ulp of the JAX value
  (rtol 2^-7), plus 1e-6 for values that the sums' order puts on either
  side of the ReLU.
* BiGRU, f32: atol 1e-5 over 6 steps (f32 sums of 128 products in another
  order, carried through the recurrence); bf16: the output is bf16 of
  values in (-1, 1), where one ulp is at most 2^-8, so atol 2^-7 (two
  ulps).

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import bigru as tbg
from crnn_ocr_torch.kernels import fused_stem as tfs
from crnn_ocr_tpu.kernels.bigru import bigru_pallas_raw
from crnn_ocr_tpu.kernels.fused_stem import fused_stem_serve as jax_stem

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _stem_inputs(seed=0, B=4, H=32, W=48, C=8):
    rng = np.random.default_rng(seed)
    return dict(
        img=rng.normal(size=(B, H, W, 1)).astype(np.float32),
        conv_w=(rng.normal(size=(3, 3, 1, C)) * 0.5).astype(np.float32),
        gamma=rng.uniform(0.5, 1.5, C).astype(np.float32),
        beta=(rng.normal(size=C) * 0.2).astype(np.float32),
        mean=(rng.normal(size=C) * 0.1).astype(np.float32),
        var=rng.uniform(0.5, 2.0, C).astype(np.float32),
    )


def _torch_stem(a, dtype, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
    scale, bias = tfs.fold_bn(t["gamma"], t["beta"], t["mean"], t["var"])
    return tfs.fused_stem_serve(t["img"].to(dtype), t["conv_w"], scale, bias)


def _stem_close(got, want, bf16):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if bf16:
        assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-6).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stem_plain_matches_pallas_interpret(dtype):
    tdt, jdt = DTYPES[dtype]
    a = _stem_inputs()
    want = jax_stem(
        jnp.asarray(a["img"]).astype(jdt), a["conv_w"], a["gamma"],
        a["beta"], a["mean"], a["var"], interpret=True, out_dtype=jdt,
        bf16=dtype == "bfloat16")
    before = tfs.launches
    got = _torch_stem(a, tdt)
    assert tfs.launches == before  # the CPU path launches no kernel
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _stem_close(got.float().numpy(), np.asarray(want, np.float32),
                dtype == "bfloat16")


def _gru_inputs(seed=1, T=6, B=8, H=128):
    rng = np.random.default_rng(seed)
    return dict(
        xw=rng.normal(size=(T, 2, B, 3 * H)).astype(np.float32),
        u=(rng.normal(size=(2, H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        b=(rng.normal(size=(2, 3 * H)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bigru_plain_matches_pallas_interpret(dtype):
    tdt, jdt = DTYPES[dtype]
    a = _gru_inputs()
    want = bigru_pallas_raw(jnp.asarray(a["xw"]).astype(jdt),
                            jnp.asarray(a["u"]).astype(jdt),
                            jnp.asarray(a["b"]), interpret=True)
    before = tbg.launches
    got = tbg.bigru(torch.from_numpy(a["xw"]).to(tdt),
                    torch.from_numpy(a["u"]).to(tdt), torch.from_numpy(a["b"]))
    assert tbg.launches == before
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    atol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


def test_wrappers_check_shapes_and_devices():
    a = _stem_inputs(H=31)  # odd height
    with pytest.raises(ValueError, match="even"):
        _torch_stem(a, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        tfs.fused_stem_serve(torch.zeros(1, 4, 4, 1, dtype=torch.float16),
                             torch.zeros(3, 3, 1, 2), torch.ones(2),
                             torch.zeros(2))
    with pytest.raises(ValueError, match="rec_bias"):
        tbg.bigru(torch.zeros(2, 2, 1, 6), torch.zeros(2, 2, 6),
                  torch.zeros(2, 5))
    # no fallback: a tensor on a device without a kernel raises
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tfs.fused_stem_serve(torch.zeros(1, 4, 4, 1, device=meta),
                             torch.zeros(3, 3, 1, 2, device=meta),
                             torch.ones(2, device=meta),
                             torch.zeros(2, device=meta))
    with pytest.raises(RuntimeError, match="no kernel"):
        tbg.bigru(torch.zeros(2, 2, 1, 6, device=meta),
                  torch.zeros(2, 2, 6, device=meta),
                  torch.zeros(2, 6, device=meta))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_birnn_rebuilds_kernel_weights_on_load(dtype):
    """BiRNN keeps the card kernel's layout of its recurrent kernel as the
    buffer ``u_kernel``: rebuilt when a state dict is loaded, not saved."""
    from crnn_ocr_torch.models.rnn import BiRNN

    tdt = DTYPES[dtype][0]
    H = 40  # both dtypes' GRU designs pad 40 units to 48
    rnn = BiRNN(8, H, dtype=tdt)
    assert "u_kernel" not in rnn.state_dict()
    sd = {k: torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(v.shape)).astype(np.float32))
        for k, v in rnn.state_dict().items()}
    rnn.load_state_dict(sd)
    want = tbg.kernel_weights(sd["recurrent_kernel"].to(tdt))
    assert rnn.u_kernel.dtype == tdt
    assert tuple(rnn.u_kernel.shape) == (2, 3 * 48, 48)
    assert torch.equal(rnn.u_kernel, want)
