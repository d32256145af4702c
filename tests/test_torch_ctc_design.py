"""The pipelined design of K6 and K7 (``csrc/ctc_loss.cu::
ctc_alpha_pipelined_kernel``, ``ctc_beta_pipelined_kernel``), checked on the
CPU where it is plain Python or plain arithmetic.

* ``ctc_loss.plan``: for every odd S up to ``MAX_STATES`` and the frames of
  the training buckets, each state of a sample is one thread's (state s on
  lane s % 32 of warp s // 32), the CTA's shared memory (the hand-over
  slots and the warps' rings) stays within the H100's 232,448 bytes, and
  the grid has one CTA a sample.
* A numpy model of the kernels: one thread a state; the neighbours read
  from the lane each shuffle reads within the warp, and at a warp's edge
  from the hand-over slots of the neighbouring warp, read a frame ahead
  as ``Taken`` reads them, on a schedule the kernel allows (each warp
  after the warps it takes from: a slot it must wait for that no warp
  writes would hang the kernel, and fails the model); the emissions read
  through each warp's ring as ``stage`` fills it (a read of a chunk that
  has not landed, or of a stale chunk, fails); forwards for alpha and
  backwards for beta, in log2 units with
  ex2/lg2 as float32 ``np.exp2`` / ``np.log2``, the chain stopped at each
  sample's input length. It equals ``ctc_alphas_plain`` /
  ``ctc_betas_plain`` to phase 6's tolerance of ``chip_smoke.py`` (1e-4 +
  1e-5 * |plain| where finite, exactly NEG where the plain version is NEG)
  on repeated labels, empty labels (S = 1), infeasible samples, input
  lengths of 1, below T and past T, one chunk and several, at S 65 and
  S 1023. An off-by-one at a lane, warp or chunk edge shows here.
* On the CPU the wrappers take their plain versions and count no launch.
"""

import collections

import numpy as np
import pytest
import torch

from crnn_ocr_torch.kernels import ctc_loss as cl

LANES = 32
NEG = np.float32(cl.NEG)
LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)


def test_plan_covers_every_state_once():
    for T in (1, 2, 30, 62, 126, 254):
        for S in range(1, cl.MAX_STATES + 1, 2):
            p = cl.plan(7, T, S)
            assert p.design == "pipelined" and p.lane_states == 1, (T, S)
            held = collections.Counter(
                w * LANES + lane for w in range(p.warps)
                for lane in range(LANES))
            assert all(held[s] == 1 for s in range(S)), (T, S)
            assert (p.warps - 1) * LANES < S <= p.warps * LANES
            assert p.ring_frames == cl.CHUNK
            assert p.smem_bytes == cl.pipelined_smem(p.warps, T)
            assert p.smem_bytes <= cl.SMEM_MAX
            blk = cl.plan(7, T, S, "block")
            assert blk.warps == p.warps and blk.smem_bytes <= cl.SMEM_MAX
    for B in (1, 5, 128, 129, 256):
        # one CTA a sample: blockIdx.x is the sample
        for design in cl.DESIGNS:
            assert cl.plan(B, 62, 65, design).ctas == B


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        cl.plan(2, 5, cl.MAX_STATES + 1)
    with pytest.raises(ValueError):
        cl.plan(2, 5, 65, "thread")
    # hand-over slots past the shared memory: the block design
    assert cl.plan(2, 1000, 1023).design == "block"


# ---------------------------------------------------------------- the model

def _shfl(x, src_lane):
    """__shfl_sync within a warp: lane l reads lane ``src_lane[l]``."""
    return x[src_lane]


class _Ring:
    """A warp's ring of two chunks of CHUNK frames, as ``Ring``: ``stage``
    copies every lane's own emission of a chunk's frames (and tags the
    buffer with the chunk); ``chunk(c)`` refills the buffer of chunk c - 1
    with chunk c + 1, waits (every staged chunk but the newest lands) and
    returns chunk c's buffer, checking that it has landed and holds
    chunk c."""

    def __init__(self, e, states, S, n, t0, step):  # n frames staged
        self.e, self.states, self.n = e, states, n
        self.on = states < S
        self.t0, self.step = t0, step
        self.buf = np.full((2, cl.CHUNK, LANES), np.nan, np.float32)
        self.tag = [-1, -1]
        self.staged, self.landed = [], set()

    def stage(self, c):
        for i in range(c * cl.CHUNK, min(c * cl.CHUNK + cl.CHUNK, self.n)):
            row = self.e[self.t0 + self.step * i]
            self.buf[c & 1, i - c * cl.CHUNK, self.on] = \
                row[self.states[self.on]]
        self.tag[c & 1] = c
        self.staged.append(c)

    def chunk(self, c):
        if c > 0:
            self.stage(c + 1)
        self.landed = set(self.staged[:-1])
        assert c in self.landed and self.tag[c & 1] == c
        return self.buf[c & 1]


class _Slots:
    """The hand-over slots [W - 1][T][2]: each written once. ``take``
    needs a written slot (in the model's schedule, each warp after the
    ones it takes from: a slot not written by then would never be, and the
    kernel would wait for ever); ``peek`` may read an empty one."""

    def __init__(self, W, T):
        self.v = np.full((max(W - 1, 0), T, 2), np.nan, np.float32)

    def give(self, k, t, vals):
        assert np.isnan(self.v[k, t]).all()
        self.v[k, t] = vals

    def peek(self, k, t):
        return self.v[k, t].copy()

    def take(self, k, t):
        assert not np.isnan(self.v[k, t]).any(), (k, t)
        return self.v[k, t].copy()


class _Taken:
    """``Taken``: a frame's slots, read a frame ahead (maybe still empty,
    then taken when they are needed)."""

    def __init__(self, slots, k):
        self.slots, self.k = slots, k
        self.v = np.array([NEG, NEG], np.float32)

    def start(self, f0, f1):
        if self.k is not None:
            self.slots.take(self.k, f1)
            self.v = self.slots.take(self.k, f0)

    def at(self, f):
        if self.k is not None and np.isnan(self.v).any():
            self.v = self.slots.take(self.k, f)
        return self.v

    def read(self, f):
        if self.k is not None:
            self.v = self.slots.peek(self.k, f)


def _log2_sum3(a, b, c, ms):
    with np.errstate(over="ignore", under="ignore"):
        return np.log2(np.exp2(a - ms) + np.exp2(b - ms)
                       + np.exp2(c - ms)).astype(np.float32)


def _to_ln(y):
    return np.where(y > NEG / 2, y * LN2, NEG).astype(np.float32)


LANE = np.arange(LANES)


def _model_alphas(emits, flags, lens):
    """The kernel's schedule: warp w runs all its frames after warp w - 1
    (alpha flows up the states: warp w takes only from w - 1)."""
    B, T, S = emits.shape
    out = np.full((B, T, S), np.nan, np.float32)
    for b in range(B):
        W = -(-S // LANES)
        n = min(max(int(lens[b]), 1), T)
        slots = _Slots(W, T)
        for w in range(W):
            states = w * LANES + LANE
            on = states < S
            f = np.zeros(LANES, np.int64)
            f[on] = flags[b, states[on]]
            skip, valid = (f & cl.SKIP) != 0, (f & cl.VALID) != 0
            ring = _Ring(emits[b], states, S, T, 0, 1)  # staged up to T
            ring.stage(0), ring.stage(1)
            rows = np.full((T, LANES), np.nan, np.float32)
            a = np.where(f & cl.INIT, ring.chunk(0)[0] * LOG2E,
                         NEG).astype(np.float32)
            if w < W - 1:  # lanes 30, 31 hand over
                slots.give(w, 0, a[30:])
            h = _Taken(slots, w - 1 if w > 0 else None)
            h.start(0, min(1, n - 1))
            em = ring.chunk(0)
            c, t = 0, 1
            while True:
                while t < min(c * cl.CHUNK + cl.CHUNK, n):
                    r1 = _shfl(a, (LANE + 31) & 31)
                    r2 = _shfl(a, (LANE + 30) & 31)
                    h30, h31 = h.at(t - 1)
                    rows[t - 1] = _to_ln(a)
                    e = em[t - c * cl.CHUNK] * LOG2E
                    m1 = np.where(LANE >= 1, r1, h31)
                    m2 = np.where(LANE >= 2, r2,
                                  np.where(LANE == 1, h31, h30))
                    m2 = np.where(skip, m2, NEG)
                    h.read(t)
                    ms = np.maximum(np.maximum(a, NEG), np.maximum(m1, m2))
                    nx = (ms + e) + _log2_sum3(a, m1, m2, ms)
                    a = np.where(valid & (ms > NEG / 2), nx,
                                 NEG).astype(np.float32)
                    if w < W - 1:
                        slots.give(w, t, a[30:])
                    t += 1
                if t >= n:
                    break
                c += 1
                em = ring.chunk(c)
            rows[n - 1:] = _to_ln(a)
            out[b, :, states[on]] = rows[:, on].T
    return out


def _model_betas(emits, flags, lens):
    """The kernel's schedule: warp w runs all its frames after warp w + 1
    (beta flows down the states)."""
    B, T, S = emits.shape
    out = np.full((B, T, S), np.nan, np.float32)
    for b in range(B):
        W = -(-S // LANES)
        length = int(lens[b])
        n = max(min(length, T), 0)
        out[b, n:] = NEG
        if n == 0:
            continue
        slots = _Slots(W, T)
        for w in range(W - 1, -1, -1):
            states = w * LANES + LANE
            on = states < S
            f = np.zeros(LANES, np.int64)
            f[on] = flags[b, states[on]]
            up2 = states + 2
            skip2 = np.zeros(LANES, bool)
            skip2[up2 < S] = (flags[b, up2[up2 < S]] & cl.SKIP) != 0
            valid = (f & cl.VALID) != 0
            ring = _Ring(emits[b], states, S, n, n - 1, -1)
            ring.stage(0), ring.stage(1)
            rows = np.full((T, LANES), np.nan, np.float32)
            beta = np.where((n == length) & ((f & cl.END) != 0), 0,
                            NEG).astype(np.float32)
            be = np.where(valid, beta + ring.chunk(0)[0] * LOG2E,
                          NEG).astype(np.float32)
            h = _Taken(slots, w if w < W - 1 else None)
            if n > 1:
                h.start(n - 1, max(n - 2, 1))
            em = ring.chunk(0)
            c, i = 0, 0
            while True:
                while i < min(c * cl.CHUNK + cl.CHUNK, n) - 1:
                    t = n - 1 - i
                    if w > 0:  # lanes 0, 1 hand over
                        slots.give(w - 1, t, be[:2])
                    r1 = _shfl(be, (LANE + 1) & 31)
                    r2 = _shfl(be, (LANE + 2) & 31)
                    h0, h1 = h.at(t)
                    rows[t] = _to_ln(beta)
                    e = em[i + 1 - c * cl.CHUNK] * LOG2E
                    p1 = np.where(LANE <= 30, r1, h0)
                    p2 = np.where(LANE <= 29, r2,
                                  np.where(LANE == 30, h0, h1))
                    p2 = np.where(skip2, p2, NEG)
                    h.read(t - 1)
                    ms = np.maximum(np.maximum(be, NEG), np.maximum(p1, p2))
                    lg = _log2_sum3(be, p1, p2, ms)
                    live = ms > NEG / 2
                    beta = np.where(live, ms + lg, NEG).astype(np.float32)
                    be = np.where(valid & live, (ms + e) + lg,
                                  NEG).astype(np.float32)
                    i += 1
                if i >= n - 1:
                    break
                c += 1
                em = ring.chunk(c)
            rows[0] = _to_ln(beta)
            out[b, :n, states[on]] = rows[:n, on].T
    return out


def _operands(seed, B, T, C, L, repeat=False):
    """Seeded log-probs through ``prepare`` (L > 0), or for L = 0 (S = 1)
    the blank's emissions and the one state's flags; sample 0 infeasible,
    1 of input length 1, 2 past T, 3 below T."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, T, C)).astype(np.float32)), -1)
    il = torch.from_numpy(rng.integers(max(T // 2, 1), T + 1, (B,))
                          .astype(np.int32))
    il[0], il[1], il[2], il[3] = 2, 1, T + 3, max(T - 3, 1)
    if L == 0:
        flags = torch.full((B, 1), cl.VALID | cl.INIT | cl.END,
                           dtype=torch.int32)
        return lp[:, :, -1:].contiguous(), flags, il
    labels = rng.integers(0, C - 1, (B, L))
    if repeat:  # runs of one class: skip false between them
        labels[:, 1::2] = labels[:, 0::2][:, :labels[:, 1::2].shape[1]]
    ll = torch.from_numpy(rng.integers(1, L + 1, (B,)).astype(np.int32))
    ll[0] = L  # with input length 2: infeasible
    emits, flags, lens, _, _ = cl.prepare(lp, torch.from_numpy(labels), il,
                                          ll)
    return emits, flags, lens


CASES = {
    "training shape S 65": (0, 6, 62, 63, 32, False),
    "repeated labels": (1, 5, 24, 9, 6, True),
    "empty labels S 1": (2, 5, 17, 9, 0, False),
    "one chunk T 9": (3, 5, 9, 12, 3, False),
    "chunk edges T 33": (7, 6, 33, 12, 5, False),
    "S 1023": (4, 4, 21, 40, 511, False),
    "S 129 over 5 warps' edges": (6, 5, 40, 20, 64, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_of_the_pipelined_design_matches_plain(case):
    seed, B, T, C, L, repeat = CASES[case]
    emits, flags, lens = _operands(seed, B, T, C, L, repeat)
    if repeat:
        assert not bool(((flags & cl.SKIP) != 0)[:, 1:].all())
    for model, plain in ((_model_alphas, cl.ctc_alphas_plain),
                         (_model_betas, cl.ctc_betas_plain)):
        got = model(emits.numpy(), flags.numpy(), lens.numpy())
        want = plain(emits, flags, lens).numpy()
        live = want > NEG / 2
        assert live.any()
        np.testing.assert_array_equal(got[~live], want[~live])
        err = np.abs(got[live] - want[live])
        assert (err <= 1e-4 + 1e-5 * np.abs(want[live])).all(), err.max()


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    emits, flags, lens = _operands(5, 4, 12, 9, 3)
    counts = (cl.alpha_launches, cl.beta_launches,
              dict(cl.design_launches))
    for design in cl.DESIGNS:
        assert torch.equal(cl.ctc_alphas(emits, flags, lens, design),
                           cl.ctc_alphas_plain(emits, flags, lens))
        assert torch.equal(cl.ctc_betas(emits, flags, lens, design),
                           cl.ctc_betas_plain(emits, flags, lens))
    assert (cl.alpha_launches, cl.beta_launches,
            dict(cl.design_launches)) == counts
