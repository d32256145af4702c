"""BiGRU recurrence for both directions (Keras GRU, ``reset_after``).

Replaces ``crnn_ocr_tpu/kernels/bigru.py::bigru_pallas_raw`` (K2) and, for
training, ``bigru_pallas_train`` (K3) with the analytic backward of
``bigru_fused`` (``bigru.py:203-268``). The input
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
the call raises. When a gradient is needed (grad mode on and an input that
requires it) it runs the training forward instead, as JAX's ``custom_vjp``
does: K3 (``bigru_train``; the same kernels with a gate-stash template flag)
writes ``hs`` and the gates (T, 2, B, 4H) f32 = [z | r | hh | rh], and the
backward is plain PyTorch on either device, as the JAX package's is a
``lax.scan``: a reverse loop over T carrying only ``dh`` with one batched
product per step, then ``dU`` as one einsum and ``db`` as a sum. Its
rounding points are the JAX backward's: ``h_prev`` is the stored ``hs`` (the
compute dtype) widened to f32, U is widened to f32, ``dxw`` is cast to
``hs``'s dtype and ``dU`` to U's, and ``db`` stays f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Kernel launches: K2 (bigru, inference) and K3 (bigru_train, the forward
# with the gate stash). The plain versions are not counted.
launches = 0
train_launches = 0

MAX_UNITS = 1024  # one thread per hidden unit in a block


def _recurrence(xw, u, rec_bias, stash: bool):
    T, D, B, G = xw.shape
    H = G // 3
    uf = u.float()
    b = rec_bias.float()[:, None, :]
    h = torch.zeros((D, B, H), dtype=torch.float32, device=xw.device)
    out = torch.empty((T, D, B, H), dtype=xw.dtype, device=xw.device)
    gates = (torch.empty((T, D, B, 4 * H), dtype=torch.float32,
                         device=xw.device) if stash else None)
    for t in range(T):
        rec = torch.bmm(h.to(u.dtype).float(), uf) + b
        x = xw[t].float()
        z = torch.sigmoid(x[..., :H] + rec[..., :H])
        r = torch.sigmoid(x[..., H:2 * H] + rec[..., H:2 * H])
        rh = rec[..., 2 * H:]
        hh = torch.tanh(x[..., 2 * H:] + r * rh)
        h = z * h + (1.0 - z) * hh
        out[t] = h.to(xw.dtype)
        if stash:
            gates[t] = torch.cat([z, r, hh, rh], dim=-1)
    return out, gates


def bigru_plain(xw, u, rec_bias):
    """The recurrence as a loop over T: f32 products of operands rounded to
    ``u``'s dtype, f32 gate math and state, output in ``xw``'s dtype."""
    return _recurrence(xw, u, rec_bias, stash=False)[0]


def bigru_train_plain(xw, u, rec_bias):
    """:func:`bigru_plain` that also returns the gates (T, 2, B, 4H) f32,
    ``[z | r | hh | rh]`` per step (``bigru.py:117-141``)."""
    return _recurrence(xw, u, rec_bias, stash=True)


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


def _launch(xw, u, rec_bias, u_kernel, stash: bool):
    """Run K2 (``stash=False``) or K3 on the card: hs, and the gates for
    K3. Checks every operand; raises for a device without a kernel."""
    T, B, H = _check(xw, u, rec_bias)
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

    rb = rec_bias.detach().float()
    xw = xw.detach()
    if hp != H:
        xw, rb = _pad_gates(xw, H, hp), _pad_gates(rb, H, hp)
    xw = xw.contiguous()
    rb = rb.contiguous()
    hs = torch.empty((T, 2, B, hp), dtype=xw.dtype, device=dev)
    gates = (torch.empty((T, 2, B, 4 * hp), dtype=torch.float32, device=dev)
             if stash else None)
    lib = _build.load("bigru")
    fn = lib.crnn_bigru_bf16 if bf16 else lib.crnn_bigru_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn(xw.data_ptr(), u_kernel.data_ptr(), rb.data_ptr(),
                 hs.data_ptr(), gates.data_ptr() if stash else None, T, B, hp,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "bigru_train" if stash else "bigru")
    if hp != H:
        hs = hs[..., :H].contiguous()
        if stash:
            gates = gates.reshape(T, 2, B, 4, hp)[..., :H].reshape(
                T, 2, B, 4 * H)
    return hs, gates


def bigru_train(xw, u, rec_bias, u_kernel=None):
    """K3: ``(hs, gates)`` as :func:`bigru_train_plain` computes them. A CPU
    tensor goes through the plain version, a CUDA tensor through the
    kernel; no gradient flows through this call (see :func:`bigru`)."""
    _check(xw, u, rec_bias)
    if xw.device.type == "cpu":
        with torch.no_grad():
            return bigru_train_plain(xw, u, rec_bias)
    global train_launches
    out = _launch(xw, u, rec_bias, u_kernel, stash=True)
    train_launches += 1
    return out


def bigru_backward(g, u, hs, gates):
    """The analytic GRU backward (``bigru.py:214-265``), in plain PyTorch.

    Per step, both directions at once (direction 1 is time-reversed
    everywhere, so one reverse loop serves both)::

        dh    = dh_carry + g_t
        da_z  = dh (h_prev - hh) z (1 - z)
        da_h  = dh (1 - z) (1 - hh^2)
        da_r  = da_h rh r (1 - r)
        drec  = [da_z, da_r, da_h r]          cotangent of h_prev U + b
        dxw_t = [da_z, da_r, da_h]
        dh_prev = dh z + drec U^T

    The factors that do not depend on ``dh`` are formed for all steps at
    once, so the loop is an add, two products and one batched matmul per
    step. Returns ``(dxw, du, db)`` in the dtypes of ``hs``, ``u`` and f32.
    """
    T, D, B, H = hs.shape
    with torch.profiler.record_function("bigru_backward"):
        h_prev = torch.cat([hs.new_zeros((1, D, B, H)), hs[:-1]]).float()
        z, r, hh, rh = gates.reshape(T, D, B, 4, H).unbind(3)
        dz = (h_prev - hh) * z * (1.0 - z)
        dhh = (1.0 - z) * (1.0 - hh * hh)
        # per-gate factors of dh: drec = dh * f_rec, dxw = dh * f_x
        f_rec = torch.stack([dz, dhh * rh * r * (1.0 - r), dhh * r], dim=3)
        ut = u.float().transpose(1, 2)  # (D, 3H, H)
        dhs = torch.empty((T, D, B, H), dtype=torch.float32, device=hs.device)
        dh = torch.zeros((D, B, H), dtype=torch.float32, device=hs.device)
        for t in range(T - 1, -1, -1):
            dh = dh + g[t].float()
            dhs[t] = dh
            drec = (dh[:, :, None, :] * f_rec[t]).reshape(D, B, 3 * H)
            dh = torch.baddbmm(dh * z[t], drec, ut)
        drec_seq = (dhs[:, :, :, None, :] * f_rec).reshape(T, D, B, 3 * H)
        f_rec[..., 2, :] = dhh  # the h-gate's dxw lacks the factor r
        dxw = (dhs[:, :, :, None, :] * f_rec).reshape(T, D, B, 3 * H)
        du = torch.einsum("tdbh,tdbg->dhg", h_prev, drec_seq)
        db = drec_seq.sum(dim=(0, 2))
    return dxw.to(hs.dtype), du.to(u.dtype), db


class _BiGRUTrain(torch.autograd.Function):
    """K3 forward, :func:`bigru_backward` backward (JAX's ``bigru_fused``
    custom VJP)."""

    @staticmethod
    def forward(ctx, xw, u, rec_bias, u_kernel):
        hs, gates = bigru_train(xw, u, rec_bias, u_kernel)
        ctx.save_for_backward(u, hs, gates)
        return hs

    @staticmethod
    def backward(ctx, g):
        u, hs, gates = ctx.saved_tensors
        dxw, du, db = bigru_backward(g, u, hs, gates)
        return dxw, du, db, None


def bigru_infer(xw, u, rec_bias, u_kernel=None):
    """K2: hs as :func:`bigru_plain` computes it, with no gradient. A CPU
    tensor goes through the plain version, a CUDA tensor through the
    kernel."""
    _check(xw, u, rec_bias)
    if xw.device.type == "cpu":
        return bigru_plain(xw, u, rec_bias)
    global launches
    hs, _ = _launch(xw, u, rec_bias, u_kernel, stash=False)
    launches += 1
    return hs


def bigru(xw, u, rec_bias, u_kernel=None):
    """Run the recurrence: xw (T, 2, B, 3H), u (2, H, 3H) in the same dtype,
    rec_bias (2, 3H) -> hs (T, 2, B, H) in xw's dtype, direction 1 still
    time-reversed. ``u_kernel``: ``kernel_weights(u)``, built here when
    not given. Differentiable in ``xw``, ``u`` and ``rec_bias``: with a
    gradient needed it runs K3 and the analytic backward, else K2."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xw, u, rec_bias)):
        return _BiGRUTrain.apply(xw, u, rec_bias, u_kernel)
    return bigru_infer(xw, u, rec_bias, u_kernel)
