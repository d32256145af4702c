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


def _char_sums(predictions, references) -> tuple:
    """(total edit distance, total reference chars)."""
    return (sum(levenshtein(p, r) for p, r in zip(predictions, references)),
            sum(len(r) for r in references))


def _word_sums(predictions, references) -> tuple:
    """(total edit distance over whitespace tokens, total reference
    words)."""
    return (sum(levenshtein(p.split(), r.split())
                for p, r in zip(predictions, references)),
            sum(len(r.split()) for r in references))


def _line_sums(predictions, references) -> tuple:
    """(exact lines, lines)."""
    return (sum(p == r for p, r in zip(predictions, references)),
            len(references))


def _rate(num, den) -> float:
    return num / max(den, 1)


def cer(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Character error rate: total edit distance / total reference chars."""
    return _rate(*_char_sums(predictions, references))


def wer(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Word error rate over whitespace tokens."""
    return _rate(*_word_sums(predictions, references))


def sequence_accuracy(
    predictions: Sequence[str], references: Sequence[str]
) -> float:
    return _rate(*_line_sums(predictions, references))


def error_sums(predictions: Sequence[str],
               references: Sequence[str]) -> np.ndarray:
    """The sums behind ``cer``, ``wer`` and ``sequence_accuracy``: (char
    distance, reference chars, word distance, reference words, exact
    lines, lines), float64. Shards' sums add up to the whole's (a
    data-parallel evaluation all-reduces them); ``rates_from_sums`` turns
    them into the three rates, equal to the functions' on the whole."""
    return np.array([*_char_sums(predictions, references),
                     *_word_sums(predictions, references),
                     *_line_sums(predictions, references)], np.float64)


def rates_from_sums(sums) -> dict:
    """``{"cer", "wer", "seq_acc"}`` of ``error_sums``'s (summed) sums."""
    s = [float(v) for v in sums]
    return {"cer": _rate(s[0], s[1]), "wer": _rate(s[2], s[3]),
            "seq_acc": _rate(s[4], s[5])}
