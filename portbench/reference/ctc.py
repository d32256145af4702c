"""CTC on the reference's posteriors, in numpy: the greedy path, the best
path of a given labelling (Viterbi), a labelling's log-likelihood (the
forward recursion), and TF's beam search (``beam``, a frozen copy of the
sequential decoder TF's ``CTCBeamSearchDecoder`` runs, which
``K.ctc_decode(greedy=False)`` calls). The blank is the last class.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

KLOG_ZERO = -float("inf")


def greedy(lp: np.ndarray) -> Tuple[List[int], float]:
    """(T, C) log-probabilities -> (labels, the best path's log-prob)."""
    best = lp.argmax(1)
    blank = lp.shape[1] - 1
    labels = [int(c) for k, c in enumerate(best)
              if c != blank and (k == 0 or c != best[k - 1])]
    return labels, float(lp.max(1).sum())


def _extended(labels: Sequence[int], blank: int) -> np.ndarray:
    ext = np.full(2 * len(labels) + 1, blank, np.int64)
    ext[1::2] = labels
    return ext


def _recursion(lp: np.ndarray, labels: Sequence[int], combine) -> float:
    """The CTC lattice over (T, C) log-probs ``lp`` for ``labels``;
    ``combine`` is ``np.maximum`` (best path) or ``np.logaddexp`` (sum)."""
    T, C = lp.shape
    ext = _extended(labels, C - 1)
    S = len(ext)
    skip = np.zeros(S, bool)
    skip[2:] = (ext[2:] != C - 1) & (ext[2:] != ext[:-2])
    a = np.full(S, -np.inf)
    a[0] = lp[0, ext[0]]
    if S > 1:
        a[1] = lp[0, ext[1]]
    for t in range(1, T):
        prev1 = np.concatenate([[-np.inf], a[:-1]])
        prev2 = np.where(skip, np.concatenate([[-np.inf, -np.inf], a[:-2]]),
                         -np.inf)
        with np.errstate(invalid="ignore"):
            a = combine(combine(a, prev1), prev2) + lp[t, ext]
    tail = a[-2:] if S > 1 else a[-1:]
    with np.errstate(invalid="ignore"):
        return float(combine.reduce(tail))


def best_path(lp: np.ndarray, labels: Sequence[int]) -> float:
    """The log-prob of the best path that collapses to ``labels``."""
    return _recursion(lp, labels, np.maximum)


def log_likelihood(lp: np.ndarray, labels: Sequence[int]) -> float:
    """log P(labels): the sum over every path that collapses to them."""
    return _recursion(lp, labels, np.logaddexp)


class _Entry:
    __slots__ = ("parent", "label", "children", "oldp", "newp")

    def __init__(self, parent, label):
        self.parent = parent
        self.label = label
        self.children = {}
        # prob triplets: [total, blank, label]
        self.oldp = [KLOG_ZERO, KLOG_ZERO, KLOG_ZERO]
        self.newp = [KLOG_ZERO, KLOG_ZERO, KLOG_ZERO]

    def active(self) -> bool:
        return self.newp[0] != KLOG_ZERO

    def child(self, label: int) -> "_Entry":
        c = self.children.get(label)
        if c is None:
            c = _Entry(self, label)
            self.children[label] = c
        return c

    def label_seq(self, merge_repeated: bool) -> List[int]:
        out: List[int] = []
        prev = -1
        node = self
        while node.parent is not None:
            if not merge_repeated or node.label != prev:
                out.append(node.label)
            prev = node.label
            node = node.parent
        out.reverse()
        return out


def _lse(a: float, b: float) -> float:
    if a == KLOG_ZERO:
        return b
    if b == KLOG_ZERO:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def beam(
    logits: np.ndarray,
    seq_len: int,
    beam_width: int,
    top_paths: int,
    merge_repeated: bool,
) -> Tuple[List[List[int]], List[float]]:
    """TF's beam search of one (T, C) example: the top paths and their log-probs."""
    T, C = logits.shape
    blank = C - 1

    root = _Entry(None, -1)
    root.newp = [0.0, 0.0, KLOG_ZERO]
    leaves: List[_Entry] = [root]

    for t in range(seq_len):
        inp = logits[t]
        max_c = float(inp.max())
        norm = max_c + math.log(float(np.exp(inp - max_c).sum()))

        branches = sorted(leaves, key=lambda e: -e.newp[0])
        leaves = []
        for b in branches:
            b.oldp = list(b.newp)

        # Phase 1: update stays (current beams), fold parent mass for
        # still-active parents, push all back.
        for b in branches:
            if b.parent is not None:
                if b.parent.active():
                    prev = (
                        b.parent.oldp[1]
                        if b.label == b.parent.label
                        else b.parent.oldp[0]
                    )
                    b.newp[2] = _lse(b.newp[2], prev)
                b.newp[2] += float(inp[b.label]) - norm
            b.newp[1] = b.oldp[0] + float(inp[blank]) - norm
            b.newp[0] = _lse(b.newp[1], b.newp[2])
            leaves.append(b)
        leaves.sort(key=lambda e: -e.newp[0])

        def is_cand(p):
            return p[0] > KLOG_ZERO and (
                len(leaves) < beam_width or p[0] > leaves[-1].newp[0]
            )

        # Phase 2: sequential child creation with in-step eviction.
        for b in branches:
            if not is_cand(b.oldp):
                continue
            for label in range(C - 1):  # blank excluded
                c = b.child(label)
                if c.active():
                    continue  # active children were folded in phase 1
                prev = b.oldp[1] if label == b.label else b.oldp[0]
                c.newp = [KLOG_ZERO, KLOG_ZERO, float(inp[label]) - norm + prev]
                c.newp[0] = c.newp[2]
                if is_cand(c.newp):
                    if len(leaves) == beam_width:
                        evicted = leaves.pop()
                        evicted.newp = [KLOG_ZERO, KLOG_ZERO, KLOG_ZERO]
                    # insert keeping descending order; ties after incumbents
                    lo, hi = 0, len(leaves)
                    key = -c.newp[0]
                    while lo < hi:
                        mid = (lo + hi) // 2
                        if -leaves[mid].newp[0] <= key:
                            lo = mid + 1
                        else:
                            hi = mid
                    leaves.insert(lo, c)
                else:
                    c.oldp = [KLOG_ZERO, KLOG_ZERO, KLOG_ZERO]
                    c.newp = [KLOG_ZERO, KLOG_ZERO, KLOG_ZERO]

    leaves.sort(key=lambda e: -e.newp[0])
    paths = [e.label_seq(merge_repeated) for e in leaves[:top_paths]]
    scores = [e.newp[0] for e in leaves[:top_paths]]
    while len(paths) < top_paths:  # beam collapsed below top_paths
        paths.append([])
        scores.append(KLOG_ZERO)
    return paths, scores


