"""BiGRU and BiLSTM recurrences for both directions (Keras GRU with
``reset_after``; Keras LSTM).

Replaces the four Pallas kernels of ``crnn_ocr_tpu/kernels/bigru.py``: the
GRU's ``bigru_pallas_raw`` (K2) and, for training, ``bigru_pallas_train``
(K3) with the analytic backward of ``bigru_fused`` (``bigru.py:203-268``);
the LSTM's ``bilstm_pallas_raw`` (K4) and ``bilstm_pallas_train`` (K5) with
the analytic backward of ``bilstm_fused`` (``bigru.py:439-501``). The input
projections for every step come in precomputed as ``xw`` (T, 2, B, nH) in
the compute dtype, direction 1 time-reversed: n = 3 gates z|r|h for the
GRU, n = 4 gates i|f|c|o for the LSTM, whose single bias is already folded
into ``xw``. What is left is, per step and direction, ``rec = round(h) .
U[d]`` (plus the GRU's recurrent bias ``b_rec[d]``) and the gate math, with
the state carried in f32 whatever the compute dtype: h, and for the LSTM
also c, as the Pallas kernels carry them (``bigru.py:63-73, 343-345``).
The CUDA kernels are in ``csrc/bigru.cu``, the cell a template parameter
of each (its header has the designs and the H100 bounds, bytes-bound plus
the T dependent steps). :func:`design_for` picks the design from the shape
alone: up to 256 padded units K2-K5, in bf16 and in f32, keep U resident
in a cluster's shared memory (bf16 products on the tensor cores; f32 ones
as 3xTF32 on the tensor cores; the f32 LSTM past 128 units in clusters of
up to 8 CTAs of 32 units); wider bf16 shapes stream U from L2; wider f32
ones read it from L2 on the CUDA cores.
``bigru_plain`` and ``bilstm_plain`` are the same functions as Python loops
over T.

``bigru`` and ``bilstm`` dispatch on the device of ``xw`` and on nothing
else: a CPU tensor goes through the plain version, a CUDA tensor through
the kernel, or the call raises. When a gradient is needed (grad mode on
and an input that requires it) they run the training forward instead, as
JAX's ``custom_vjp`` does: K3 (``bigru_train``) writes ``hs`` and the gates
(T, 2, B, 4H) f32 = [z | r | hh | rh], K5 (``bilstm_train``) ``hs`` and
(T, 2, B, 5H) f32 = [i | f | g | o | c], each the same kernels with a
stash template flag. The backwards follow the JAX package's
``lax.scan``s: a reverse loop over T with one batched product per step,
then ``dU`` as one matmul (and the GRU's ``db`` as a sum). The GRU's runs
on the card as one kernel a layer (``csrc/bigru.cu::bigru_bwd_kernel``,
:func:`backward_design_for` picks its shape, :func:`bigru_backward_plain`
is its plain version); the LSTM's is plain PyTorch on either device. Their
rounding points are the JAX backwards': ``h_prev`` is the stored ``hs``
(the compute dtype) widened to f32, U is widened to f32, ``dxw`` is cast
to ``hs``'s dtype and ``dU`` to U's, and ``db`` stays f32.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from crnn_ocr_torch.utils.profiling import span

# Kernel launches: K2 (bigru, inference), K3 (bigru_train, the forward with
# the gate stash), K4 (bilstm) and K5 (bilstm_train). The plain versions
# are not counted.
launches = 0
train_launches = 0
lstm_launches = 0
lstm_train_launches = 0

MAX_UNITS = 1024  # one thread per hidden unit in a block
GATES = {"gru": 3, "lstm": 4}
STASH = {"gru": 4, "lstm": 5}  # the training stash's width, in units of H

# The resident design keeps U in the shared memory of a cluster of CTAs,
# each owning at most a tile of units of every gate (:func:`resident_tile`):
# RESIDENT_UNITS (one M-tile of 64 rows on 4 warps) in at most 4 CTAs, or,
# for the f32 LSTM past 128 padded units (whose 64-unit f32 slice would not
# fit), LSTM_F32_UNITS (two M-tiles of 16, K split over 2 warps each, 4 at
# 16 rows) in at most 8, the portable maximum. Every (cell, stash) pair
# runs it, as
# csrc/bigru.cu::resident takes them: K2 (the GRU, serving), K3 (the GRU,
# training), K4 (the LSTM, serving), K5 (the LSTM, training); in bf16 up to
# 256 padded units (4 x 64), in f32 (the product as 3xTF32 on the tensor
# cores) up to F32_RESIDENT_UNITS. The dtype picks the instance.
RESIDENT_UNITS = 64
LSTM_F32_UNITS = 32
RESIDENT_KERNELS = (("gru", False), ("gru", True), ("lstm", False),
                    ("lstm", True))
RESIDENT_ROWS = (8, 16, 32)  # batch rows a cluster, the instances compiled
F32_RESIDENT_UNITS = 256
F32_RESIDENT_ROWS = (8, 16)  # the f32 GRU: two f32 h buffers of 32 rows do
# not fit beside its 192 KB slice at 256 units; the f32 LSTM has all three
# The CTAs the H100 holds at once per resident instance, (dtype, cell,
# stash, padded units, rows): cudaOccupancyMaxActiveClusters times the
# cluster size, as tools/time_rnn_designs.py measured them (PERF.md), the
# same with and without the stash. A grid past it runs in two waves and
# loses (K4 at B 256: 16 rows in two waves 20 % slower than 32 in one).
# design_for takes the fewest rows whose grid fits, since at one wave fewer
# rows were measured faster; a width not in the table, or a batch that no
# measured instance holds in one wave, takes 16 rows. In f32 at 128 units
# the GRU holds two CTAs an SM, at 256 one (U's slice alone takes 192 KB);
# the f32 LSTM one at both (128 KB slices: 64 units at 128, 32 at 256),
# and at 256 its clusters of 8 fit 15 at once, not 16 (120 CTAs): K5 at B
# 128 fits one wave on 32 rows (64 CTAs), K4 at B 256 on none (16 rows,
# three waves, measured faster than 32 rows' two).
WAVE_CTAS = {
    (dtype, cell, stash, hp, rows): ctas
    for dtype, rows_of, cell, hp, caps in (
        (torch.bfloat16, RESIDENT_ROWS, "gru", 256, (248, 248, 120)),
        (torch.bfloat16, RESIDENT_ROWS, "lstm", 256, (120, 120, 120)),
        (torch.bfloat16, RESIDENT_ROWS, "gru", 128, (528, 528, 264)),
        (torch.bfloat16, RESIDENT_ROWS, "lstm", 128, (396, 396, 264)),
        (torch.float32, F32_RESIDENT_ROWS, "gru", 256, (120, 120)),
        (torch.float32, F32_RESIDENT_ROWS, "gru", 128, (264, 264)),
        (torch.float32, RESIDENT_ROWS, "lstm", 256, (120, 120, 120)),
        (torch.float32, RESIDENT_ROWS, "lstm", 128, (132, 132, 132)))
    for stash in (False, True)
    for rows, ctas in zip(rows_of, caps)
}
# launches per Design, counted where K2-K5 launch (the comparisons'
# launches included); the per-kernel counts above are the path's
design_launches: collections.Counter = collections.Counter()

# The GRU's backward on the card (csrc/bigru.cu::bigru_bwd_kernel): its
# launches, and its launches per Design (the plain loop is not counted).
# A cluster of C CTAs a (direction, tile of rows) keeps U's columns of each
# CTA's units in shared memory (at most BWD_CTA_UNITS units a CTA, at most
# BWD_MAX_UNITS padded units: 8 warps of two 16-unit M-tiles) and splits
# the step's product over K, each CTA's partial dh handed to the units'
# owners; bwd_smem is the kernel's shared memory, which SMEM_BYTES bounds.
backward_launches = 0
backward_design_launches: collections.Counter = collections.Counter()
BWD_MAX_UNITS = 256
BWD_CTA_UNITS = 64
BWD_ROWS = (8, 16, 32, 40)
SMEM_BYTES = 232448  # the dynamic shared memory an H100 block may hold
# The CTAs the H100 holds at once per backward instance (dtype, padded
# units, cluster, rows): cudaOccupancyMaxActiveClusters times the cluster,
# as chip_smoke.py's phase 6 read them (H100); one CTA an SM at these
# sizes. A shape not in the table is taken to hold BWD_DEFAULT_CTAS.
BWD_DEFAULT_CTAS = 120
BWD_WAVE_CTAS = {
    **{(torch.bfloat16, 256, 4, r): 120 for r in BWD_ROWS},
    **{(torch.float32, 128, 2, r): 132 for r in BWD_ROWS},
}


class Design(NamedTuple):
    """Which kernel design runs a recurrence: ``"resident"`` (U in a
    cluster's shared memory, ``cluster`` CTAs of ``rows`` batch rows; bf16
    products on the tensor cores, f32 ones as 3xTF32 on them),
    ``"streamed"`` (bf16, U streamed from L2 by blocks of 16 rows) or
    ``"f32"`` (U read from L2 by the CUDA cores)."""

    name: str
    cluster: int = 0
    rows: int = 0


def _resident(H: int, dtype) -> bool:
    """Whether a recurrence of ``H`` units may run the resident design: in
    bf16 every shape (up to 256 padded units, else it streams), in f32 up
    to F32_RESIDENT_UNITS padded units."""
    return dtype == torch.bfloat16 or -(-H // 16) * 16 <= F32_RESIDENT_UNITS


def resident_tile(cell: str, hp: int, dtype) -> tuple:
    """The resident instance's tile at ``hp`` padded units: (the units of
    each gate a CTA owns at most, the most CTAs a cluster). 32 units in up
    to 8 CTAs for the f32 LSTM past 128 units (4 x 64 x 256 x 4 bytes, 256
    KB, would not fit a CTA), else 64 in up to 4."""
    if dtype == torch.float32 and cell == "lstm" and hp > 128:
        return LSTM_F32_UNITS, 8
    return RESIDENT_UNITS, 4


def resident_rows(dtype, cell: str) -> tuple:
    """The rows a cluster of the resident instances compiled for ``dtype``
    and ``cell``."""
    if dtype == torch.float32 and cell == "gru":
        return F32_RESIDENT_ROWS
    return RESIDENT_ROWS


def design_for(cell: str, stash: bool, H: int, B: int, dtype) -> Design:
    """The design for a recurrence of ``H`` units at batch ``B``, a pure
    function of the shape: every (cell, stash) pair in bf16 up to 256
    padded units, and in f32 up to F32_RESIDENT_UNITS, takes the resident
    design; the cluster is the fewest CTAs that hold the padded units, an
    even number each within the instance's tile (:func:`resident_tile`:
    4 CTAs of 64, or for the f32 LSTM past 128 units 8 of 32), and the rows
    a cluster the fewest of the instance's rows whose grid ``WAVE_CTAS``
    says the card holds in one wave, else 16. Wider bf16 shapes stream U;
    wider f32 ones take the ``"f32"`` design."""
    if not _resident(H, dtype):
        return Design("f32")
    hp = _padded_units(H, dtype)
    units, max_cluster = resident_tile(cell, hp, dtype)
    for c in range(-(-hp // units), max_cluster + 1):
        if hp % c == 0 and (hp // c) % 2 == 0:
            rows = next((r for r in resident_rows(dtype, cell)
                         if -(-B // r) * 2 * c
                         <= WAVE_CTAS.get((dtype, cell, stash, hp, r), 0)),
                        16)
            return Design("resident", c, rows)
    return Design("streamed", 0, 16)


def bwd_smem(hp: int, cluster: int, rows: int, elem: int) -> int:
    """Bytes of the backward kernel's shared memory (its C entry computes
    the same): U's columns of a CTA's ``hp / cluster`` units, ``hp`` rows of
    3 upc + 8 elements of ``elem`` bytes (rounded up to 16 bytes); the step's
    drec, ``rows`` rows of 3 upc + 8 f32; the shares of dh handed in, two
    buffers of ``cluster`` x ``rows`` x (upc + 4) f32."""
    upc = hp // cluster
    ks = 3 * upc + 8
    return (-(-hp * ks * elem // 16) * 16 + rows * ks * 4
            + 2 * cluster * rows * (upc + 4) * 4)


PLAIN = Design("plain")


def backward_design_for(H: int, B: int, dtype) -> Design:
    """The design of the GRU's backward at ``H`` units and batch ``B``, a
    pure function of the shape: ``"resident"`` (the card's kernel) up to
    BWD_MAX_UNITS padded units in either dtype, on the fewest CTAs a cluster
    (at most 8) whose units are a multiple of 8 and at most BWD_CTA_UNITS
    and whose shared memory at 16 rows fits; the rows the fewest of
    BWD_ROWS whose grid ``BWD_WAVE_CTAS`` says the card holds in one wave,
    else the most that fit. Wider shapes, and widths no cluster splits so,
    take :data:`PLAIN` (:func:`bigru_backward_plain`)."""
    hp = -(-H // 16) * 16
    if hp > BWD_MAX_UNITS:
        return PLAIN
    elem = 2 if dtype == torch.bfloat16 else 4
    for c in range(1, 9):
        upc = hp // c
        if (hp % c or upc % 8 or upc > BWD_CTA_UNITS
                or bwd_smem(hp, c, 16, elem) > SMEM_BYTES):
            continue
        fits = [r for r in BWD_ROWS if bwd_smem(hp, c, r, elem) <= SMEM_BYTES]
        rows = next((r for r in fits if -(-B // r) * 2 * c <= BWD_WAVE_CTAS
                     .get((dtype, hp, c, r), BWD_DEFAULT_CTAS)), fits[-1])
        return Design("resident", c, rows)
    return PLAIN


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


def _lstm_recurrence(xw, u, stash: bool):
    T, D, B, G = xw.shape
    H = G // 4
    uf = u.float()
    h = torch.zeros((D, B, H), dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    out = torch.empty((T, D, B, H), dtype=xw.dtype, device=xw.device)
    st = (torch.empty((T, D, B, 5 * H), dtype=torch.float32,
                      device=xw.device) if stash else None)
    for t in range(T):
        gates = xw[t].float() + torch.bmm(h.to(u.dtype).float(), uf)
        i = torch.sigmoid(gates[..., :H])
        f = torch.sigmoid(gates[..., H:2 * H])
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = torch.sigmoid(gates[..., 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[t] = h.to(xw.dtype)
        if stash:
            st[t] = torch.cat([i, f, g, o, c], dim=-1)
    return out, st


def bilstm_plain(xw, u):
    """The LSTM recurrence as a loop over T (``_lstm_gate_math``,
    ``bigru.py:284-294``): f32 products of h rounded to ``u``'s dtype, f32
    gate math, h and c carried in f32, output in ``xw``'s dtype."""
    return _lstm_recurrence(xw, u, stash=False)[0]


def bilstm_train_plain(xw, u):
    """:func:`bilstm_plain` that also returns the stash (T, 2, B, 5H) f32,
    ``[i | f | g | o | c]`` per step, c the new cell state
    (``bigru.py:351-378``)."""
    return _lstm_recurrence(xw, u, stash=True)


def _check(xw, u, rec_bias, cell: str):
    """Shapes and dtypes of a recurrence's operands; ``rec_bias`` is the
    GRU's (2, 3H) recurrent bias, None for the LSTM."""
    n = GATES[cell]
    if xw.dim() != 4 or xw.shape[1] != 2 or xw.shape[3] % n:
        raise ValueError(f"xw must be (T, 2, B, {n}H), got {tuple(xw.shape)}")
    T, _, B, G = xw.shape
    H = G // n
    if tuple(u.shape) != (2, H, G):
        raise ValueError(f"u must be (2, {H}, {G}), got {tuple(u.shape)}")
    if cell == "gru" and tuple(rec_bias.shape) != (2, G):
        raise ValueError(f"rec_bias must be (2, {G}), got "
                         f"{tuple(rec_bias.shape)}")
    if xw.dtype not in (torch.float32, torch.bfloat16) or u.dtype != xw.dtype:
        raise TypeError(f"xw and u must share a dtype, float32 or bfloat16; "
                        f"got {xw.dtype} and {u.dtype}")
    return T, B, H


def mma_operand(u):
    """U (2, H, nH) -> the bf16 kernel's B operand (2, nH, H): transposed to
    [d][n][k], with k permuted inside each 16-block to (0,1,8,9, 2,3,10,11,
    4,5,12,13, 6,7,14,15) so that one 8-byte load is one mma B fragment."""
    D, H, G = u.shape
    ut = u.transpose(1, 2).reshape(D, G, H // 16, 2, 4, 2)
    return ut.permute(0, 1, 2, 4, 3, 5).reshape(D, G, H).contiguous()


def _padded_units(H: int, dtype) -> int:
    """Hidden units per gate the shape's design runs: the tensor-core
    designs (every bf16 one, the f32 resident one) take a multiple of
    16 (mma tiles, core matrices); the ``"f32"`` design any H. A padded unit
    sees zero input and weights (and bias), so its state stays 0: for the
    GRU z = 1/2 and hh = 0; for the LSTM i = f = o = 1/2 and g = 0, so c
    stays 0 and h = tanh(0) / 2 = 0. It adds nothing to the real units'
    products."""
    if _resident(H, dtype):
        return -(-H // 16) * 16
    return H


def _pad_gates(x, H: int, hp: int):
    """Zero-pad the last axis (n gates of H units) to n * hp."""
    n = x.shape[-1] // H
    return F.pad(x.reshape(*x.shape[:-1], n, H), (0, hp - H)).reshape(
        *x.shape[:-1], n * hp)


def kernel_weights(u):
    """U (2, H, nH) -> the operand the card's kernel reads (n = 3 for the
    GRU, 4 for the LSTM): for bf16, the units padded to a multiple of 16 and
    the layout of :func:`mma_operand`; for the f32 resident design, the
    units padded the same way and U[d] transposed, (2, n hp, hp) as
    [d][n][k]; for the ``"f32"`` design, U itself. It depends on the weights
    only, so a caller that runs them often builds it once (``BiRNN`` does
    when its weights are loaded) and passes it to :func:`bigru` or
    :func:`bilstm`."""
    H, G = u.shape[1], u.shape[2]
    cell = "lstm" if G == 4 * H else "gru"
    if not _resident(H, u.dtype):
        return u.contiguous()
    hp = _padded_units(H, u.dtype)
    if hp != H:
        u = F.pad(_pad_gates(u, H, hp), (0, 0, 0, hp - H))
    if u.dtype == torch.bfloat16:
        return mma_operand(u)
    return u.transpose(1, 2).contiguous()


def _launch(cell: str, xw, u, rec_bias, u_kernel, stash: bool,
            design: Design = None):
    """Run K2 or K3 (``cell="gru"``), K4 or K5 (``"lstm"``) on the card:
    hs, and the stash for K3 and K5. Checks every operand; raises for a
    device without a kernel, and for a launch the card refuses (a resident
    cluster that cannot be scheduled): no other design stands in.
    ``design``: :func:`design_for`'s, unless a caller that compares designs
    on the same inputs names another (then ``u_kernel`` None, built here
    for that design)."""
    T, B, H = _check(xw, u, rec_bias, cell)
    if design is None:
        design = design_for(cell, stash, H, B, xw.dtype)
    name = f"bi{cell}_train" if stash else f"bi{cell}"
    if xw.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {xw.device}")
    if H > MAX_UNITS:
        raise ValueError(f"{name}: at most {MAX_UNITS} units, got {H}")
    dev = xw.device
    if u.device != dev or (rec_bias is not None and rec_bias.device != dev):
        raise RuntimeError(f"{name}: every operand must be on one device")
    bf16 = xw.dtype == torch.bfloat16
    takes = {"resident": _resident(H, xw.dtype), "streamed": bf16,
             "f32": not bf16}
    if not takes.get(design.name):
        raise ValueError(f"{name}: the {design.name} design does not take "
                         f"{xw.dtype}")
    n, sw = GATES[cell], STASH[cell]
    # every design but "f32" runs units padded to a multiple of 16
    hp = H if design.name == "f32" else -(-H // 16) * 16
    if u_kernel is None:
        u_kernel = u.contiguous() if design.name == "f32" else (
            kernel_weights(u))
    want = (2, H, n * H) if design.name == "f32" else (2, n * hp, hp)
    if (tuple(u_kernel.shape) != want or u_kernel.dtype != xw.dtype
            or u_kernel.device != dev or not u_kernel.is_contiguous()):
        raise ValueError(f"{name}: u_kernel must be {design.name}'s "
                         f"operand, {want} {xw.dtype} on {dev}; got "
                         f"{tuple(u_kernel.shape)} {u_kernel.dtype} on "
                         f"{u_kernel.device}")
    from crnn_ocr_torch.kernels import _build

    xw = xw.detach()
    if hp != H:
        xw = _pad_gates(xw, H, hp)
    operands = [xw.contiguous(), u_kernel]
    if cell == "gru":
        rb = rec_bias.detach().float()
        operands.append((_pad_gates(rb, H, hp) if hp != H else rb)
                        .contiguous())
    hs = torch.empty((T, 2, B, hp), dtype=xw.dtype, device=dev)
    gates = (torch.empty((T, 2, B, sw * hp), dtype=torch.float32, device=dev)
             if stash else None)
    lib = _build.load("bigru")
    ptrs = [t.data_ptr() for t in operands]
    out = [hs.data_ptr(), gates.data_ptr() if stash else None]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design.name == "resident":
            fn = lib.crnn_birnn_resident
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 5 + [ctypes.c_void_p]
            if cell == "lstm":
                ptrs.append(None)  # no recurrent bias
            # the training instance (K3, K5) when the stash pointer is set
            # the element size picks the bf16 or the f32 (3xTF32) instance
            err = fn(int(cell == "lstm"), xw.element_size(), *ptrs, *out, T,
                     B, hp, design.cluster, design.rows, stream)
        else:
            fn = getattr(lib, f"crnn_bi{cell}_{'bf16' if bf16 else 'f32'}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * (len(operands) + 2) + [
                ctypes.c_int] * 3 + [ctypes.c_void_p]
            err = fn(*ptrs, *out, T, B, hp, stream)
    _build.check(lib, err, f"{name} ({design.name} design)")
    design_launches[design] += 1
    if hp != H:
        hs = hs[..., :H].contiguous()
        if stash:
            gates = gates.reshape(T, 2, B, sw, hp)[..., :H].reshape(
                T, 2, B, sw * H)
    return hs, gates


def bigru_train(xw, u, rec_bias, u_kernel=None):
    """K3: ``(hs, gates)`` as :func:`bigru_train_plain` computes them. A CPU
    tensor goes through the plain version, a CUDA tensor through the
    kernel; no gradient flows through this call (see :func:`bigru`)."""
    _check(xw, u, rec_bias, "gru")
    if xw.device.type == "cpu":
        with torch.no_grad():
            return bigru_train_plain(xw, u, rec_bias)
    global train_launches
    out = _launch("gru", xw, u, rec_bias, u_kernel, stash=True)
    train_launches += 1
    return out


def bigru_backward_plain(g, u, hs, gates):
    """The analytic GRU backward (``bigru.py:214-265``) as a loop over T in
    plain PyTorch: :func:`bigru_backward`'s plain version.

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


DU_ROWS = 2048  # rows of h_prev and drec a chunk of dU's sum at least
DU_SPLITS = 32  # chunks at most


def du_splits(T: int, B: int) -> int:
    """The chunks of dU's sum over T B rows on the card: the most divisors
    of T up to DU_SPLITS whose chunk of T / S steps holds DU_ROWS rows,
    else 1. A pure function of the shape, so the sum's order is too."""
    return max((s for s in range(1, min(T, DU_SPLITS) + 1)
                if T % s == 0 and T // s * B >= DU_ROWS), default=1)


def _backward_launch(g, u, hs, gates, design: Design):
    """The card's backward on ``design``: the kernel writes dxw, drec (2, T,
    B, 3H) and h_prev (2, T, B, H) f32, then dU = h_prev^T drec is one
    batched f32 matmul over :func:`du_splits` chunks of steps, and db a sum
    of drec's rows. Units past a multiple
    of 16 are padded with zeros, which keep their dh at 0 (z = 0: da_z =
    da_r = 0, and U's padded rows and columns are 0). Checks the operands;
    raises for a launch the card refuses: no other design stands in."""
    T, D, B, H = hs.shape
    dev, dt = hs.device, hs.dtype
    if (D != 2 or tuple(g.shape) != (T, 2, B, H)
            or tuple(gates.shape) != (T, 2, B, 4 * H)
            or tuple(u.shape) != (2, H, 3 * H)):
        raise ValueError(f"bigru_backward: g {tuple(g.shape)}, u "
                         f"{tuple(u.shape)}, hs {tuple(hs.shape)}, gates "
                         f"{tuple(gates.shape)} do not fit")
    if (g.dtype != dt or u.dtype != dt or gates.dtype != torch.float32
            or dt not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"bigru_backward: g, u and hs must share a dtype, "
                        f"float32 or bfloat16, gates float32; got {g.dtype}, "
                        f"{u.dtype}, {dt}, {gates.dtype}")
    if any(t.device != dev for t in (g, u, gates)):
        raise RuntimeError("bigru_backward: every operand must be on one "
                           "device")
    from crnn_ocr_torch.kernels import _build

    hp = -(-H // 16) * 16
    if hp != H:
        g, hs = (F.pad(t, (0, hp - H)) for t in (g, hs))
        gates = _pad_gates(gates, H, hp)
        u = F.pad(_pad_gates(u, H, hp), (0, 0, 0, hp - H))
    operands = [t.detach().contiguous() for t in (g, hs, gates, u)]
    dxw = torch.empty((T, 2, B, 3 * hp), dtype=dt, device=dev)
    drec = torch.empty((2, T, B, 3 * hp), dtype=torch.float32, device=dev)
    h_prev = torch.empty((2, T, B, hp), dtype=torch.float32, device=dev)
    lib = _build.load("bigru")
    fn = lib.crnn_bigru_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dxw.element_size(), *(t.data_ptr() for t in operands),
                 dxw.data_ptr(), drec.data_ptr(), h_prev.data_ptr(), T, B,
                 hp, design.cluster, design.rows, stream)
    _build.check(lib, err, f"bigru_backward ({design.name} design)")
    backward_design_launches[design] += 1
    # dU over S chunks of whole steps, one batched matmul, the chunks'
    # products summed in order (a split of the long sum over T B rows:
    # 2.4 -> 1.0 ms at train-hard's shape on the H100, PERF.md)
    S = du_splits(T, B)
    du = torch.bmm(h_prev.view(2 * S, T * B // S, hp).transpose(1, 2),
                   drec.view(2 * S, T * B // S, 3 * hp)).view(
                       2, S, hp, 3 * hp).sum(1)
    db = drec.sum(dim=(1, 2))
    if hp != H:
        dxw = dxw.reshape(T, 2, B, 3, hp)[..., :H].reshape(T, 2, B, 3 * H)
        du = du.reshape(2, hp, 3, hp)[:, :H, :, :H].reshape(2, H, 3 * H)
        db = db.reshape(2, 3, hp)[..., :H].reshape(2, 3 * H)
    return dxw, du.to(dt), db


def bigru_backward(g, u, hs, gates):
    """The analytic GRU backward (JAX's ``_bwd``, ``bigru.py:214-265``):
    ``(dxw, du, db)`` in the dtypes of ``hs``, ``u`` and f32, from the
    cotangent ``g`` of ``hs`` and K3's stash ``gates``. A CUDA tensor at a
    shape :func:`backward_design_for` gives the kernel runs
    ``csrc/bigru.cu::bigru_bwd_kernel`` and one matmul; a CPU tensor, or a
    shape past the kernel's, :func:`bigru_backward_plain`. The
    ``bigru_backward`` span carries the design."""
    T, D, B, H = hs.shape
    design = (backward_design_for(H, B, hs.dtype)
              if hs.device.type == "cuda" else PLAIN)
    with span("bigru_backward",
              design=f"{design.name},{design.cluster},{design.rows}"):
        if design == PLAIN:
            return bigru_backward_plain(g, u, hs, gates)
        out = _backward_launch(g, u, hs, gates, design)
    global backward_launches
    backward_launches += 1
    return out


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
    _check(xw, u, rec_bias, "gru")
    if xw.device.type == "cpu":
        return bigru_plain(xw, u, rec_bias)
    global launches
    hs, _ = _launch("gru", xw, u, rec_bias, u_kernel, stash=False)
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


# ---- the LSTM ----


def bilstm_infer(xw, u, u_kernel=None):
    """K4: hs as :func:`bilstm_plain` computes it, with no gradient. A CPU
    tensor goes through the plain version, a CUDA tensor through the
    kernel."""
    _check(xw, u, None, "lstm")
    if xw.device.type == "cpu":
        return bilstm_plain(xw, u)
    global lstm_launches
    hs, _ = _launch("lstm", xw, u, None, u_kernel, stash=False)
    lstm_launches += 1
    return hs


def bilstm_train(xw, u, u_kernel=None):
    """K5: ``(hs, stash)`` as :func:`bilstm_train_plain` computes them. A
    CPU tensor goes through the plain version, a CUDA tensor through the
    kernel; no gradient flows through this call (see :func:`bilstm`)."""
    _check(xw, u, None, "lstm")
    if xw.device.type == "cpu":
        with torch.no_grad():
            return bilstm_train_plain(xw, u)
    global lstm_train_launches
    out = _launch("lstm", xw, u, None, u_kernel, stash=True)
    lstm_train_launches += 1
    return out


def bilstm_backward(g, u, hs, stash):
    """The analytic LSTM backward (``bigru.py:450-498``), in plain PyTorch.

    Per step, both directions at once, carrying ``(dh, dc)``::

        dh    = dh_carry + g_t
        da_o  = dh tanh(c) o (1 - o)
        dc    = dc_carry + dh o (1 - tanh(c)^2)
        da_i  = dc g i (1 - i)
        da_f  = dc c_prev f (1 - f)           c_prev = 0 at step 0
        da_g  = dc i (1 - g^2)
        drec  = dxw_t = [da_i, da_f, da_g, da_o]   (gates = xw + h_prev U)
        dh_prev = drec U^T,  dc_prev = dc f

    The factors that do not depend on the carries are formed for all steps
    at once, so the loop is two adds, three products and one batched
    matmul per step. Returns ``(dxw, du)`` in the dtypes of ``hs`` and
    ``u``: the LSTM's bias is folded into ``xw`` before the recurrence, so
    its gradient flows through the projection's autograd, not from here.
    """
    T, D, B, H = hs.shape
    with span("bilstm_backward"):
        i, f, gg, o, c = stash.reshape(T, D, B, 5, H).unbind(3)
        c_prev = torch.cat([c.new_zeros((1, D, B, H)), c[:-1]])
        h_prev = torch.cat([hs.new_zeros((1, D, B, H)), hs[:-1]]).float()
        tc = torch.tanh(c)
        f_o = tc * o * (1.0 - o)  # da_o = dh * f_o
        f_c = o * (1.0 - tc * tc)  # dc += dh * f_c
        # da_i, da_f, da_g = dc * f_dc
        f_dc = torch.stack([gg * i * (1.0 - i), c_prev * f * (1.0 - f),
                            i * (1.0 - gg * gg)], dim=3)
        g = g.float()
        ut = u.float().transpose(1, 2)  # (D, 4H, H)
        drec = torch.empty((T, D, B, 4, H), dtype=torch.float32,
                           device=hs.device)
        dh = torch.zeros((D, B, H), dtype=torch.float32, device=hs.device)
        dc = torch.zeros_like(dh)
        for t in range(T - 1, -1, -1):
            dh = dh + g[t]
            dc = torch.addcmul(dc, dh, f_c[t])
            torch.mul(dc[:, :, None], f_dc[t], out=drec[t, :, :, :3])
            torch.mul(dh, f_o[t], out=drec[t, :, :, 3])
            dh = torch.bmm(drec[t].reshape(D, B, 4 * H), ut)
            dc = dc * f[t]
        drec = drec.reshape(T, D, B, 4 * H)
        du = torch.einsum("tdbh,tdbg->dhg", h_prev, drec)
    return drec.to(hs.dtype), du.to(u.dtype)


class _BiLSTMTrain(torch.autograd.Function):
    """K5 forward, :func:`bilstm_backward` backward (JAX's ``bilstm_fused``
    custom VJP)."""

    @staticmethod
    def forward(ctx, xw, u, u_kernel):
        hs, stash = bilstm_train(xw, u, u_kernel)
        ctx.save_for_backward(u, hs, stash)
        return hs

    @staticmethod
    def backward(ctx, g):
        u, hs, stash = ctx.saved_tensors
        dxw, du = bilstm_backward(g, u, hs, stash)
        return dxw, du, None


def bilstm(xw, u, u_kernel=None):
    """Run the LSTM recurrence: xw (T, 2, B, 4H) (the input projections plus
    the bias), u (2, H, 4H) in the same dtype -> hs (T, 2, B, H) in xw's
    dtype, direction 1 still time-reversed. ``u_kernel``:
    ``kernel_weights(u)``, built here when not given. Differentiable in
    ``xw`` and ``u``: with a gradient needed it runs K5 and the analytic
    backward, else K4."""
    if torch.is_grad_enabled() and (xw.requires_grad or u.requires_grad):
        return _BiLSTMTrain.apply(xw, u, u_kernel)
    return bilstm_infer(xw, u, u_kernel)
