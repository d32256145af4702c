"""Greedy CTC decoding (``crnn_ocr_tpu/ops/ctc.py:199-256,798-803``).

Blank is the last class, ``C - 1``. Greedy alignment and the pixel-span
mapping come with the slice that ports beam search and alignment.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

KERAS_EPSILON = 1e-7


def ctc_greedy_decode(
    y_pred: torch.Tensor,
    input_length: torch.Tensor,
    merge_repeated: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy CTC decode matching ``K.ctc_decode(..., greedy=True)``.

    Argmax per frame of ``log(y_pred + 1e-7)`` over the frames
    ``t < input_length``; adjacent repeats merge, blanks drop, and the kept
    labels are left-packed. The score is ``neg_sum_logits``: minus the sum
    of the per-frame max logits over the valid frames.

    Returns:
      decoded: (B, T) int32, padded with -1.
      neg_sum_logits: (B, 1) float32.
    """
    B, T, C = y_pred.shape
    blank = C - 1
    logits = torch.log(y_pred.float() + KERAS_EPSILON)
    input_length = input_length.to(device=logits.device,
                                   dtype=torch.int64).reshape(B)
    best = torch.argmax(logits, dim=-1)  # first maximum, as jnp.argmax
    maxval = torch.gather(logits, 2, best[..., None])[..., 0]

    t_idx = torch.arange(T, device=logits.device)[None, :]
    valid = t_idx < input_length[:, None]
    neg_sum = -torch.where(valid, maxval, torch.zeros_like(maxval)).sum(
        dim=-1, keepdim=True)

    keep = valid & (best != blank)
    if merge_repeated:
        prev = torch.cat([torch.full_like(best[:, :1], -1), best[:, :-1]], 1)
        keep = keep & ((best != prev) | (t_idx == 0))
    # left-pack: kept labels go to the exclusive prefix count of kept
    # frames; dropped ones all land on a dump column T, cut off after
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1,
                       torch.full_like(best, T))
    out = torch.full((B, T + 1), -1, dtype=torch.int64, device=logits.device)
    out.scatter_(1, dest, torch.where(keep, best, torch.full_like(best, -1)))
    return out[:, :T].to(torch.int32), neg_sum


def trim_dense(decoded) -> List[List[int]]:
    """Strip -1 padding: dense (B, T) -> list of label lists."""
    rows = decoded.tolist() if isinstance(decoded, torch.Tensor) else decoded
    return [[int(v) for v in row if v != -1] for row in rows]
