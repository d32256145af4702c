"""Batched edit distance on the device (``crnn_ocr_tpu/ops/editdistance.py``).

An evaluation pass then returns two scalars (the summed distances and the
summed reference lengths) instead of every decoded line.

The row-by-row DP serializes each row on ``D[i, j - 1]``, so the sweep goes
by anti-diagonals, as JAX's does: ``D[i, j]`` on diagonal ``d = i + j``
depends only on diagonals ``d - 1`` and ``d - 2``, and all cells of a
diagonal are independent. ``La + Lb - 1`` steps, each an elementwise min
over a ``(B, La + 1)`` block of int32, plain PyTorch on the tensors'
device. Each row's distance is taken at its own diagonal with a gather, so
the loop never reads a value on the host (``.item()`` in the loop would
wait for the card every diagonal); a step is ~14 small launches.

The semantics are ``utils.metrics.levenshtein``'s (unit-cost insert,
delete and substitute), and the outputs equal JAX's. On a process mesh
(``parallel/mesh.py``) each rank takes the distances of its own rows and
``cer_sums_on_device`` all-reduces the two sums, which then equal the
unsharded ones (integers: the order of the adds does not matter).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crnn_ocr_torch.parallel.mesh import all_reduce_

_BIG = 1 << 29  # an unreachable distance, far from int32's end


def batched_levenshtein(a: torch.Tensor, length_a: torch.Tensor,
                        b: torch.Tensor, length_b: torch.Tensor
                        ) -> torch.Tensor:
    """Unit-cost edit distance per row: ``out[k] = lev(a[k, :la[k]],
    b[k, :lb[k]])``.

    Args:
      a: (B, La) int labels; entries past ``length_a`` are ignored.
      length_a: (B,) valid lengths into ``a``.
      b: (B, Lb) int labels; entries past ``length_b`` are ignored.
      length_b: (B,) valid lengths into ``b``.

    Returns:
      (B,) int32 distances on ``a``'s device.
    """
    dev = a.device
    a = a.to(torch.int32)
    b = b.to(device=dev, dtype=torch.int32)
    la = length_a.to(device=dev, dtype=torch.int64).reshape(-1)
    lb = length_b.to(device=dev, dtype=torch.int64).reshape(-1)
    B, La = a.shape
    Lb = b.shape[1]

    # cell i of diagonal d compares a[i - 1] with b[d - 1 - i], which is
    # rev_b[Lb - d + i]: a contiguous slice of reversed b, padded at both
    # ends so the slice's start stays in range for every d
    pad = La + 1
    rev_b_pad = F.pad(b.flip(1), (pad, pad), value=-7)
    a_shift = F.pad(a, (1, 0), value=-9)[:, :La + 1]

    # a diagonal is held with a sentinel column 0 of _BIG before its La + 1
    # cells, so "cell i - 1" is a slice and needs no pad (scalar fills
    # only: a copy from host memory would wait for the card)
    prev2 = torch.full((B, La + 2), _BIG, dtype=torch.int32, device=dev)
    prev1 = torch.full_like(prev2, _BIG)
    prev2[:, 1] = 0  # diagonal 0: D[0, 0] = 0
    prev1[:, 1:3] = 1  # diagonal 1: D[0, 1] = D[1, 0] = 1
    # totals 0 and 1 are decided before the sweep starts
    total = la + lb
    res = torch.where(total == 0, 0, torch.where(total == 1, 1, -1)).to(
        torch.int32)
    sentinel = torch.full((B, 1), _BIG, dtype=torch.int32, device=dev)
    col = la[:, None]
    for d in range(2, La + Lb + 1):
        bcol = rev_b_pad[:, pad + Lb - d:pad + Lb - d + La + 1]
        sub = a_shift != bcol
        cur = torch.minimum(torch.minimum(prev1[:, :La + 1] + 1,
                                          prev1[:, 1:] + 1),
                            prev2[:, :La + 1] + sub)
        # the DP table's edges: D[0, d] = D[d, 0] = d
        cur[:, 0] = d
        if d <= La:
            cur[:, d] = d
        cur.clamp_(max=_BIG)  # keeps the cells past either end from growing
        res = torch.where(total == d, cur.gather(1, col)[:, 0], res)
        prev2, prev1 = prev1, torch.cat([sentinel, cur], dim=1)
    return res


def cer_sums_on_device(decoded: torch.Tensor, ref_labels: torch.Tensor,
                       ref_length: torch.Tensor, mesh=None):
    """The CER's two sums over a batch, as device scalars: the summed edit
    distances between each line's decoded labels (``decoded`` (B, T) int,
    left-packed, padded with -1: the greedy decoder's dense output) and its
    reference ``ref_labels[:ref_length]``, and the summed reference
    lengths. The CER over any number of batches is their sums' ratio (over
    at least 1); the codec maps labels to characters one to one, so it
    equals the text CER. On a process ``mesh`` (a ``parallel.mesh.Mesh``;
    the arguments the rank's rows) the sums are the global batch's."""
    dec_len = (decoded >= 0).sum(dim=1)
    ref_length = ref_length.to(decoded.device).reshape(-1)
    d = batched_levenshtein(decoded, dec_len, ref_labels, ref_length)
    sums = torch.stack([d.sum().to(torch.int64),
                        ref_length.sum().to(torch.int64)])
    sums = all_reduce_(sums, mesh)
    return sums[0], sums[1]
