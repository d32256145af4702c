"""CTC loss from normalized log-probs, with an analytic gradient.

Replaces ``crnn_ocr_tpu/kernels/ctc_loss.py``: ``ctc_loss_pallas`` (:256)
and its two kernels, ``_run_fwd`` (K6, the alpha recursion) and
``_run_bwd`` (K7, the beta recursion). The CUDA kernels are in
``csrc/ctc_loss.cu`` (its header has the recursions, the designs and the
H100 bound); :func:`plan` picks the design from the shape alone:
``"pipelined"`` (one thread a state, the CTA's warps a pipeline handing
their edge states over through shared memory, the emissions staged in a
ring, the log-sum-exps on the MUFU in log2 units) wherever its shared
memory fits, else ``"block"`` (the first design, also kept for
comparison).
``ctc_alphas_plain`` and ``ctc_betas_plain`` are the same recursions as
Python loops over T. Blank is ``C - 1``.

Around the kernels, plain PyTorch on either device, as in the JAX package:

* ``_prep`` (``ctc_loss.py:133-183``): the extended labels, the skip,
  valid, init and end masks, and the emission gather, here one
  ``torch.gather`` (the JAX package's one-hot matmul is a TPU workaround);
* ``_loss_from_alphas`` (:239-252): ``-logsumexp`` of the two end states at
  the last frame (alpha is frozen past each sample's ``input_length``);
* the gradient (``_bwd_rule``, :278-313): ``-exp(alpha + beta - log p)``,
  zeroed on infeasible samples, frozen frames and invalid states, then
  summed back onto the classes by a matmul with the extended labels'
  one-hot, as the JAX package sums them. (``scatter_add_`` adds a class's
  states, every blank state among them, by atomics on the card, in an
  order that changes from run to run: two runs of one training step
  differed.)

``ctc_alphas`` and ``ctc_betas`` dispatch on the device of the emissions
and on nothing else: a CPU tensor goes through the plain version, a CUDA
tensor through the kernel (on the plan's design, or the one asked for),
or the call raises. ``ctc_loss`` is the
differentiable entry point (a ``torch.autograd.Function``: K6 forward, K7
plus the gradient assembly backward).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

NEG = -1e30  # stands for log 0; keeps every gradient finite
MAX_STATES = 1024  # one thread a state in a CTA

# flag bits per extended state, as csrc/ctc_loss.cu reads them
VALID, INIT, SKIP, END = 1, 2, 4, 8

# Kernel launches: K6 (ctc_alphas) and K7 (ctc_betas), and both by
# (kernel, design), e.g. ("alpha", "pipelined"). The plain versions are not
# counted.
alpha_launches = 0
beta_launches = 0
design_launches: collections.Counter = collections.Counter()


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=NEG)
    out = m_safe + torch.log(
        torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe))
    return torch.where(m > NEG / 2, out, torch.full_like(out, NEG))


def _shift_down(x, k):
    """x (B, S) -> x[:, s - k], NEG where s < k (also where S < k)."""
    B, S = x.shape
    return torch.cat([x.new_full((B, k), NEG), x[:, :S - k]], dim=1)[:, :S]


def _shift_up(x, k):
    """x (B, S) -> x[:, s + k], NEG where s + k >= S."""
    B, S = x.shape
    return torch.cat([x[:, k:], x.new_full((B, k), NEG)], dim=1)[:, :S]


def ctc_alphas_plain(emits, flags, lens):
    """K6's recursion as a loop over T: emits (B, T, S) f32, flags (B, S)
    int32, lens (B,) -> alphas (B, T, S) f32."""
    B, T, S = emits.shape
    valid = (flags & VALID) != 0
    skip = (flags & SKIP) != 0
    neg = torch.full_like(emits[:, 0], NEG)
    alphas = torch.empty_like(emits)
    a = torch.where((flags & INIT) != 0, emits[:, 0], neg)
    alphas[:, 0] = a
    for t in range(1, T):
        s2 = torch.where(skip, _shift_down(a, 2), neg)
        new = _lse3(a, _shift_down(a, 1), s2) + emits[:, t]
        new = torch.where(valid, new, neg)
        a = torch.where((t < lens)[:, None], new, a)
        alphas[:, t] = a
    return alphas


def ctc_betas_plain(emits, flags, lens):
    """K7's recursion as a loop over T, in reverse: the same inputs ->
    betas (B, T, S) f32, each excluding the emission at its frame."""
    B, T, S = emits.shape
    valid = (flags & VALID) != 0
    skip_up2 = _shift_up(((flags & SKIP) != 0).float(), 2) > 0
    end = (flags & END) != 0
    neg = torch.full_like(emits[:, 0], NEG)
    betas = torch.empty_like(emits)
    beta = neg
    for t in range(T - 1, -1, -1):
        seed = end & (t == lens - 1)[:, None]
        beta = torch.where(seed, torch.zeros_like(beta), beta)
        betas[:, t] = beta
        b_e = torch.where(valid, beta + emits[:, t], neg)
        up2 = torch.where(skip_up2, _shift_up(b_e, 2), neg)
        new = _lse3(b_e, _shift_up(b_e, 1), up2)
        beta = torch.where((t <= lens - 1)[:, None], new, beta)
    return betas


def _check(emits, flags, lens):
    if emits.dim() != 3 or emits.dtype != torch.float32:
        raise ValueError(f"emits must be (B, T, S) float32, got "
                         f"{tuple(emits.shape)} {emits.dtype}")
    B, T, S = emits.shape
    if tuple(flags.shape) != (B, S) or flags.dtype != torch.int32:
        raise ValueError(f"flags must be ({B}, {S}) int32, got "
                         f"{tuple(flags.shape)} {flags.dtype}")
    if tuple(lens.shape) != (B,) or lens.dtype != torch.int32:
        raise ValueError(f"lens must be ({B},) int32, got "
                         f"{tuple(lens.shape)} {lens.dtype}")
    return B, T, S


class Plan(NamedTuple):
    """How K6 and K7 launch (``csrc/ctc_loss.cu``): ``design``
    ``"pipelined"`` (one thread a state, ``warps`` warps a sample handing
    their edge states to each other through shared memory, the emissions
    staged in a ring of two chunks of ``ring_frames`` frames a warp) or
    ``"block"`` (one thread a state, a block barrier a frame);
    ``lane_states`` states a lane (1 in both), ``smem_bytes`` of shared
    memory a CTA, ``ctas`` CTAs (one a sample)."""

    design: str
    warps: int
    lane_states: int
    ring_frames: int
    smem_bytes: int
    ctas: int


DESIGNS = {"block": 0, "pipelined": 1}  # the C entries' design codes
CHUNK = 16  # ring frames: a chunk's, the next chunk's loads in flight
SMEM_MAX = 232_448  # a CTA's shared memory (the H100's, with the opt-in)


def pipelined_smem(W: int, T: int) -> int:
    """The pipelined design's shared memory: the hand-over slots (two
    floats a frame for each pair of neighbouring warps) and a ring of two
    chunks of CHUNK frames for each warp's 32 lanes."""
    return ((W - 1) * T * 2 + W * 2 * CHUNK * 32) * 4


def plan(B: int, T: int, S: int, design: str = "pipelined") -> Plan:
    """The launch of K6 or K7 at (B, T, S), a pure function of the shape:
    ``"pipelined"`` (the path's design wherever its shared memory fits a
    CTA) or ``"block"`` (the first design, kept for comparison and for the
    shapes whose hand-over slots do not fit: T past 400 at S near 1024)."""
    if not 1 <= S <= MAX_STATES:
        raise ValueError(f"ctc: 1 to {MAX_STATES} extended states (labels "
                         f"of up to {(MAX_STATES - 1) // 2}), got {S}")
    if design not in DESIGNS:
        raise ValueError(f"ctc: no design {design!r}")
    W = -(-S // 32)
    if design == "pipelined" and pipelined_smem(W, T) <= SMEM_MAX:
        return Plan("pipelined", W, 1, CHUNK, pipelined_smem(W, T), B)
    return Plan("block", W, 1, 0, 2 * (S + 2) * 4, B)


_entries: dict = {}  # name -> (library, C entry), bound once


def _entry(name):
    got = _entries.get(name)
    if got is None:
        from crnn_ocr_torch.kernels import _build

        lib = _build.load("ctc_loss")
        fn = getattr(lib, f"crnn_ctc_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        got = _entries[name] = (lib, fn)
    return got


def _launch(name, emits, flags, lens, design):
    B, T, S = emits.shape
    dev = emits.device
    if flags.device != dev or lens.device != dev:
        raise RuntimeError(f"ctc {name}: emits, flags and lens must be on "
                           "one device")
    p = plan(B, T, S, design)
    emits, flags, lens = emits.contiguous(), flags.contiguous(), \
        lens.contiguous()
    out = torch.empty_like(emits)
    lib, fn = _entry(name)
    args = (emits.data_ptr(), flags.data_ptr(), lens.data_ptr(),
            out.data_ptr(), B, T, S, DESIGNS[p.design], p.warps,
            p.ring_frames, p.smem_bytes)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        from crnn_ocr_torch.kernels import _build

        _build.check(lib, err, f"ctc {name} ({p})")
    global alpha_launches, beta_launches
    if name == "alpha":
        alpha_launches += 1
    else:
        beta_launches += 1
    design_launches[(name, p.design)] += 1
    return out


def _run(name, plain, emits, flags, lens, design):
    _check(emits, flags, lens)
    if emits.device.type == "cpu":
        return plain(emits, flags, lens)
    if emits.device.type != "cuda":
        raise RuntimeError(f"ctc {name}: no kernel for {emits.device}")
    return _launch(name, emits, flags, lens, design)


def ctc_alphas(emits, flags, lens, design: str = "pipelined"):
    """K6: alphas (B, T, S) of :func:`ctc_alphas_plain`, on ``design``
    (:func:`plan`) for a CUDA tensor."""
    return _run("alpha", ctc_alphas_plain, emits, flags, lens, design)


def ctc_betas(emits, flags, lens, design: str = "pipelined"):
    """K7: betas (B, T, S) of :func:`ctc_betas_plain`, on ``design``."""
    return _run("beta", ctc_betas_plain, emits, flags, lens, design)


def prepare(log_probs, labels, input_length, label_length):
    """``_prep``: (emits (B, T, S) f32, flags (B, S) int32, lens (B,) int32,
    ext (B, S) int64, label_length (B,) int64) from the loss's inputs.
    Labels are clipped to [0, C - 1]; the blank is C - 1."""
    B, T, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels = labels.to(device=dev, dtype=torch.int64).clamp(0, C - 1)
    lens = input_length.to(device=dev, dtype=torch.int32).reshape(B)
    lab_len = label_length.to(device=dev, dtype=torch.int64).reshape(B, 1)
    ext = torch.full((B, S), C - 1, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    ext_m2 = torch.cat([ext.new_full((B, 2), -1), ext[:, :-2]], dim=1)
    skip = (ext != C - 1) & (ext != ext_m2)
    s_idx = torch.arange(S, device=dev)[None, :]
    valid = s_idx < 2 * lab_len + 1
    init = valid & (s_idx < torch.where(lab_len > 0, 2, 1))
    end = (s_idx == 2 * lab_len) | ((s_idx == 2 * lab_len - 1) & (lab_len > 0))
    flags = (valid.int() * VALID + init.int() * INIT + skip.int() * SKIP
             + end.int() * END).to(torch.int32)
    emits = torch.gather(log_probs.float(), 2,
                         ext[:, None, :].expand(B, T, S)).contiguous()
    return emits, flags, lens, ext, lab_len[:, 0]


def loss_from_alphas(alphas, label_length):
    """``_loss_from_alphas``: -logsumexp of the final blank and final label
    states at the last frame -> (B,) loss; NEG (a loss of 1e30) where no
    alignment reaches them."""
    alpha_T = alphas[:, -1]  # (B, S), frozen past input_length
    idx_last = 2 * label_length
    idx_prev = torch.clamp(2 * label_length - 1, min=0)
    a_last = torch.gather(alpha_T, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha_T, 1, idx_prev[:, None])[:, 0]
    a_prev = torch.where(label_length > 0, a_prev,
                         torch.full_like(a_prev, NEG))
    m = torch.maximum(a_last, a_prev)
    m_safe = torch.clamp(m, min=NEG)
    tot = m_safe + torch.log(torch.exp(a_last - m_safe)
                             + torch.exp(a_prev - m_safe))
    tot = torch.where(m > NEG / 2, tot, torch.full_like(tot, NEG))
    return -tot


def grad_from_alphas_betas(alphas, betas, loss, flags, lens, ext, C):
    """``_bwd_rule``'s assembly: d loss / d log_probs (B, T, C) for a unit
    cotangent per sample."""
    B, T, S = alphas.shape
    log_total = -loss
    gamma = alphas + betas
    grad_emit = -torch.exp(torch.clamp(gamma - log_total[:, None, None],
                                       max=0.0))
    # an infeasible sample (its label needs more frames than it has) has
    # beta = NEG everywhere: zero its gradient, as autodiff of the scan
    # does, instead of the -1 per state the clamp above would leave
    feasible = (gamma > NEG / 2) & (log_total[:, None, None] > NEG / 2)
    t_idx = torch.arange(T, device=alphas.device)
    keep = (feasible & (t_idx[None, :, None] < lens[:, None, None])
            & ((flags & VALID) != 0)[:, None, :])
    grad_emit = torch.where(keep, grad_emit, torch.zeros_like(grad_emit))
    onehot = torch.nn.functional.one_hot(ext, C).to(grad_emit.dtype)
    return torch.bmm(grad_emit, onehot)  # (B, T, C), a fixed sum order


class _CTCLoss(torch.autograd.Function):
    """K6 forward; K7 and the gradient assembly backward
    (``ctc_loss_pallas``'s custom VJP)."""

    @staticmethod
    def forward(ctx, log_probs, labels, input_length, label_length):
        emits, flags, lens, ext, lab_len = prepare(
            log_probs, labels, input_length, label_length)
        alphas = ctc_alphas(emits, flags, lens)
        loss = loss_from_alphas(alphas, lab_len)
        ctx.save_for_backward(emits, flags, lens, ext, alphas, loss)
        ctx.num_classes = log_probs.shape[-1]
        return loss

    @staticmethod
    def backward(ctx, g):
        emits, flags, lens, ext, alphas, loss = ctx.saved_tensors
        with torch.profiler.record_function("ctc_loss_backward"):
            betas = ctc_betas(emits, flags, lens)
            grad = grad_from_alphas_betas(alphas, betas, loss, flags, lens,
                                          ext, ctx.num_classes)
            grad = grad * g[:, None, None]
        return grad, None, None, None


def ctc_loss(log_probs, labels, input_length, label_length):
    """(B,) CTC loss from normalized log-probs (B, T, C) f32, blank C - 1;
    ``labels`` (B, L) dense, ``input_length`` and ``label_length`` (B,).
    A sample with no valid alignment has loss 1e30 and zero gradient.
    Differentiable in ``log_probs``."""
    return _CTCLoss.apply(log_probs, labels, input_length, label_length)
