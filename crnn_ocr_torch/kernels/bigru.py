"""BiGRU recurrence for both directions (Keras GRU, ``reset_after``).

Replaces ``crnn_ocr_tpu/kernels/bigru.py::bigru_pallas_raw``. The input
projections for every step come in precomputed as ``xw`` (T, 2, B, 3H) in
the compute dtype, direction 1 time-reversed; what is left is, per step and
direction, ``rec = round(h) . U[d] + b_rec[d]`` and the gate math, with the
hidden state ``h`` carried in f32 whatever the compute dtype (as the Pallas
kernel carries it, ``kernels/bigru.py:63-73``). The CUDA kernels are in
``csrc/bigru.cu``: bf16 on the tensor cores (``mma.sync``), f32 on the CUDA
cores (its header has the designs and the H100 bound, 20 us per layer at
the main path, bytes-bound, plus 64 dependent steps); ``bigru_plain`` is
the same function as a Python loop over T.

``bigru`` dispatches on the device of ``xw`` and on nothing else: a CPU
tensor goes through ``bigru_plain``, a CUDA tensor through the kernel, or
the call raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Kernel launches made by bigru (the plain version is not counted).
launches = 0

MAX_UNITS = 1024  # one thread per hidden unit in a block


def bigru_plain(xw, u, rec_bias):
    """The recurrence as a loop over T: f32 products of operands rounded to
    ``u``'s dtype, f32 gate math and state, output in ``xw``'s dtype."""
    T, D, B, G = xw.shape
    H = G // 3
    uf = u.float()
    b = rec_bias.float()[:, None, :]
    h = torch.zeros((D, B, H), dtype=torch.float32, device=xw.device)
    out = torch.empty((T, D, B, H), dtype=xw.dtype, device=xw.device)
    for t in range(T):
        rec = torch.bmm(h.to(u.dtype).float(), uf) + b
        x = xw[t].float()
        z = torch.sigmoid(x[..., :H] + rec[..., :H])
        r = torch.sigmoid(x[..., H:2 * H] + rec[..., H:2 * H])
        hh = torch.tanh(x[..., 2 * H:] + r * rec[..., 2 * H:])
        h = z * h + (1.0 - z) * hh
        out[t] = h.to(xw.dtype)
    return out


def _check(xw, u, rec_bias):
    if xw.dim() != 4 or xw.shape[1] != 2 or xw.shape[3] % 3:
        raise ValueError(f"xw must be (T, 2, B, 3H), got {tuple(xw.shape)}")
    T, _, B, G = xw.shape
    H = G // 3
    if tuple(u.shape) != (2, H, G):
        raise ValueError(f"u must be (2, {H}, {G}), got {tuple(u.shape)}")
    if tuple(rec_bias.shape) != (2, G):
        raise ValueError(f"rec_bias must be (2, {G}), got "
                         f"{tuple(rec_bias.shape)}")
    if xw.dtype not in (torch.float32, torch.bfloat16) or u.dtype != xw.dtype:
        raise TypeError(f"xw and u must share a dtype, float32 or bfloat16; "
                        f"got {xw.dtype} and {u.dtype}")
    return T, B, H


def mma_operand(u):
    """U (2, H, 3H) -> the bf16 kernel's B operand (2, 3H, H): transposed to
    [d][n][k], with k permuted inside each 16-block to (0,1,8,9, 2,3,10,11,
    4,5,12,13, 6,7,14,15) so that one 8-byte load is one mma B fragment."""
    D, H, G = u.shape
    ut = u.transpose(1, 2).reshape(D, G, H // 16, 2, 4, 2)
    return ut.permute(0, 1, 2, 4, 3, 5).reshape(D, G, H).contiguous()


def _padded_units(H: int, dtype) -> int:
    """Hidden units per gate the kernel runs: the bf16 kernel's mma tiles
    take a multiple of 16. A padded unit sees zero input, weights and bias,
    so its state stays 0 (z = 1/2, hh = 0) and it adds nothing to the real
    units' products."""
    return -(-H // 16) * 16 if dtype == torch.bfloat16 else H


def _pad_gates(x, H: int, hp: int):
    """Zero-pad the last axis (3H, gates z|r|h) to 3 * hp."""
    return F.pad(x.reshape(*x.shape[:-1], 3, H), (0, hp - H)).reshape(
        *x.shape[:-1], 3 * hp)


def kernel_weights(u):
    """U (2, H, 3H) -> the operand the card's kernel reads: for bf16, the
    units padded to a multiple of 16 and the layout of :func:`mma_operand`;
    for f32, U itself. It depends on the weights only, so a caller that
    runs them often builds it once (``BiRNN`` does when its weights are
    loaded) and passes it to :func:`bigru`."""
    if u.dtype != torch.bfloat16:
        return u.contiguous()
    H = u.shape[1]
    hp = _padded_units(H, u.dtype)
    if hp != H:
        u = F.pad(_pad_gates(u, H, hp), (0, 0, 0, hp - H))
    return mma_operand(u)


def bigru(xw, u, rec_bias, u_kernel=None):
    """Run the recurrence: xw (T, 2, B, 3H), u (2, H, 3H) in the same dtype,
    rec_bias (2, 3H) -> hs (T, 2, B, H) in xw's dtype, direction 1 still
    time-reversed. ``u_kernel``: ``kernel_weights(u)``, built here when
    not given."""
    T, B, H = _check(xw, u, rec_bias)
    if xw.device.type == "cpu":
        return bigru_plain(xw, u, rec_bias)
    if xw.device.type != "cuda":
        raise RuntimeError(f"bigru: no kernel for {xw.device}")
    if H > MAX_UNITS:
        raise ValueError(f"bigru: at most {MAX_UNITS} units, got {H}")
    dev = xw.device
    if u.device != dev or rec_bias.device != dev:
        raise RuntimeError("bigru: xw, u and rec_bias must be on one device")
    bf16 = xw.dtype == torch.bfloat16
    hp = _padded_units(H, xw.dtype)
    if u_kernel is None:
        u_kernel = kernel_weights(u)
    want = (2, 3 * hp, hp) if bf16 else (2, H, 3 * H)
    if (tuple(u_kernel.shape) != want or u_kernel.dtype != xw.dtype
            or u_kernel.device != dev or not u_kernel.is_contiguous()):
        raise ValueError(f"bigru: u_kernel must be kernel_weights(u), "
                         f"{want} {xw.dtype} on {dev}; got "
                         f"{tuple(u_kernel.shape)} {u_kernel.dtype} on "
                         f"{u_kernel.device}")
    from crnn_ocr_torch.kernels import _build

    rb = rec_bias.float()
    if hp != H:
        xw, rb = _pad_gates(xw, H, hp), _pad_gates(rb, H, hp)
    xw = xw.contiguous()
    rb = rb.contiguous()
    hs = torch.empty((T, 2, B, hp), dtype=xw.dtype, device=dev)
    lib = _build.load("bigru")
    fn = lib.crnn_bigru_bf16 if bf16 else lib.crnn_bigru_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    global launches
    with torch.cuda.device(dev):
        err = fn(xw.data_ptr(), u_kernel.data_ptr(), rb.data_ptr(),
                 hs.data_ptr(), T, B, hp,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "bigru")
    launches += 1
    return hs if hp == H else hs[..., :H].contiguous()
