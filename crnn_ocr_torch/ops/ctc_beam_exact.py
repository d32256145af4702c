"""TF's CTC beam-search decoder semantics on the host
(``crnn_ocr_tpu/ops/ctc_beam_exact.py``, the port's own copy).

The reference decodes via ``K.ctc_decode(greedy=False)`` -> TF's C++
``CTCBeamSearchDecoderOp``, whose per-step candidate insertion is
*sequential with in-step mutation*, which changes results on near-tie
inputs (the JAX package pinned these by differential testing against
tf_keras 2.21 and TF's ``ctc_beam_search.h``):

  1. Stays (updated current beams) are pushed first; new children are then
     tried one at a time in (branch-rank, label) order against the *current*
     bottom, evicting it on strict improvement.
  2. An evicted entry is deactivated immediately (``newp.Reset()``). If a
     later (branch, label) pair regenerates the same prefix, it is recreated
     *fresh* with only the parent-route mass.
  3. A recreated-and-rejected entry has ``oldp`` zeroed as well, which gates
     it out of spawning its own children later in the same step.
  4. The parent->child "stay" fold happens only while the parent is still an
     active beam.
  5. Output sequences collapse adjacent duplicate labels when
     ``merge_repeated`` (``K.ctc_decode``'s default).

``_decode_one`` is that spec in numpy: the plain twin of the C++ decoder
(``native/ctc_beam_tf.cc``), which ``ctc_beam_search_decode_exact`` runs,
and the oracle of the device beam (``ops/ctc_beam_device.py``).

Scoring conventions (as ``K.ctc_decode``): inputs are post-softmax
probabilities; scores accumulate ``log_softmax(log(probs + 1e-7))``; the
returned ``log_prob`` is the beam's total log probability.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

KLOG_ZERO = -float("inf")
KERAS_EPSILON = 1e-7


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


def _decode_one(
    logits: np.ndarray,
    seq_len: int,
    beam_width: int,
    top_paths: int,
    merge_repeated: bool,
) -> Tuple[List[List[int]], List[float]]:
    """Decode a single (T, C) example with TF-sequential semantics."""
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


def ctc_beam_search_decode_exact(
    y_pred: np.ndarray,
    input_length: Sequence[int],
    beam_width: int = 10,
    top_paths: int = 1,
    merge_repeated: bool = True,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """``K.ctc_decode(..., greedy=False)`` on the host, through the C++
    decoder (built with g++ at first use; a failed build raises).

    Args:
      y_pred: (B, T, C) post-softmax probabilities.
      input_length: (B,) valid frame counts.
      beam_width, top_paths, merge_repeated: as in K.ctc_decode/TF kernel.

    Returns:
      (decoded, log_probs): list of ``top_paths`` dense (B, L_max) int32
      arrays padded with -1 (L_max the longest decoded path, at least 1),
      and (B, top_paths) float32 scores: the layout K.ctc_decode returns.
    """
    from crnn_ocr_torch import native

    y_pred = np.asarray(y_pred, dtype=np.float32)
    B = y_pred.shape[0]
    paths, lens, scores = native.ctc_beam_decode_tf(
        y_pred, np.asarray(input_length).reshape(B), beam_width=beam_width,
        top_paths=top_paths, merge_repeated=merge_repeated)
    decoded = []
    for p in range(top_paths):
        width = max(1, int(lens[:, p].max(initial=0)))
        decoded.append(np.ascontiguousarray(paths[:, p, :width]))
    return decoded, scores
