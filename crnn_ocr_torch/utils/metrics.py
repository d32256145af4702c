"""Evaluation metrics: edit distance, CER, WER and sequence accuracy.

A copy of ``crnn_ocr_tpu/utils/metrics.py``. ``levenshtein`` runs the C++
``native/editdistance.cc`` (built with g++ at first use; a failed build
raises, with no quiet fallback); ``levenshtein_plain`` is the same DP in
numpy, the oracle the tests hold it to.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def levenshtein_plain(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)
            )
        prev = cur
    return int(prev[-1])


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Unit-cost edit distance of two strings, int sequences or token
    lists, in C++ (``native.editdistance``)."""
    from crnn_ocr_torch.native import editdistance

    return editdistance(a, b)


def cer(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Character error rate: total edit distance / total reference chars."""
    dist = sum(levenshtein(p, r) for p, r in zip(predictions, references))
    total = sum(len(r) for r in references)
    return dist / max(total, 1)


def wer(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Word error rate over whitespace tokens."""
    dist = sum(
        levenshtein(p.split(), r.split())
        for p, r in zip(predictions, references)
    )
    total = sum(len(r.split()) for r in references)
    return dist / max(total, 1)


def sequence_accuracy(
    predictions: Sequence[str], references: Sequence[str]
) -> float:
    hits = sum(p == r for p, r in zip(predictions, references))
    return hits / max(len(references), 1)
