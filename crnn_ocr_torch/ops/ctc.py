"""CTC loss, decoders and alignment (``crnn_ocr_tpu/ops/ctc.py``).

Blank is the last class, ``C - 1``, everywhere but in
``ctc_forward_log_loss``, which takes any blank index. The loss from
normalized log-probs is ``kernels.ctc_loss.ctc_loss``: K6 and K7 on the
card, their plain versions on the CPU, so its gradient is the kernels'
analytic one; ``NEG = -1e30`` stands for log 0 there, and a sample with no
valid alignment gets a loss of 1e30 and a zero gradient.
``ctc_loss_from_log_probs`` is that loss; ``ctc_forward_log_loss`` with
another blank first moves the blank's column to the end (a reordering of
values, so the loss and the gradient are exact) and renumbers the labels
to match.

Decoding and alignment are plain PyTorch on the tensors' device: greedy
decode, greedy alignment (the argmax runs) and forced alignment (the
max-product CTC recursion with backpointers) here; beam requests route to
the TF-exact device beam, ``ops/ctc_beam_device.py``. Every function keeps
the JAX layout: (B, T) or (B, L) left-packed, padded with -1 (labels,
frames) or 0 (confidences).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from crnn_ocr_torch.kernels.ctc_loss import ctc_loss

KERAS_EPSILON = 1e-7
NEG = -1e30  # finite stand-in for log 0


def ctc_batch_cost(labels, y_pred, input_length, label_length):
    """``K.ctc_batch_cost``: post-softmax ``y_pred`` (B, T, C) -> (B, 1)
    loss. As Keras, the log-probs are ``log_softmax(log(y_pred + 1e-7))``."""
    logits = torch.log(y_pred.float() + KERAS_EPSILON)
    return ctc_loss(torch.log_softmax(logits, dim=-1), labels, input_length,
                    label_length)[:, None]


def ctc_loss_from_log_probs(log_probs, labels, input_length, label_length):
    """(B,) CTC loss from normalized log-probs (B, T, C) f32, blank
    ``C - 1`` (``crnn_ocr_tpu/ops/ctc.py:176``): K6 forward, K7 backward on
    the card."""
    return ctc_loss(log_probs, labels, input_length, label_length)


def ctc_forward_log_loss(log_probs, labels, input_length, label_length,
                         blank: int):
    """(B,) CTC loss with blank class ``blank`` (``crnn_ocr_tpu/ops/
    ctc.py:59``): ``log_probs`` (B, T, C) normalized, ``labels`` (B, L)
    dense (values past ``label_length`` are ignored), ``input_length`` and
    ``label_length`` (B,). Differentiable in ``log_probs``.

    For ``blank != C - 1`` the classes are reordered so that the blank
    comes last: class c < blank keeps its index, the blank becomes C - 1,
    class c > blank becomes c - 1. The labels (clipped to [0, C - 1] first,
    as JAX clips them) are renumbered by the same map, and the loss runs
    ``ctc_loss_from_log_probs``; autograd carries the gradient back through
    the reordering."""
    C = log_probs.shape[-1]
    if not 0 <= blank < C:
        raise ValueError(f"blank must be in [0, {C - 1}], got {blank}")
    if blank == C - 1:
        return ctc_loss_from_log_probs(log_probs, labels, input_length,
                                       label_length)
    b = blank
    lp = torch.cat([log_probs[..., :b], log_probs[..., b + 1:],
                    log_probs[..., b:b + 1]], dim=-1)
    lab = labels.to(device=log_probs.device, dtype=torch.int64).clamp(0, C - 1)
    lab = torch.where(lab == b, C - 1, lab - (lab > b).long())
    return ctc_loss_from_log_probs(lp, lab, input_length, label_length)


def _pack_left(values: torch.Tensor, keep: torch.Tensor, pad_value):
    """Left-pack the kept elements of each row of ``values`` (B, T), the
    tail padded with ``pad_value``: kept elements go to the exclusive
    prefix count of kept ones, dropped ones all land on a dump column T,
    cut off after."""
    B, T = values.shape
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1,
                       torch.full_like(keep, T, dtype=torch.int64))
    out = torch.full((B, T + 1), pad_value, dtype=values.dtype,
                     device=values.device)
    out.scatter_(1, dest, torch.where(keep, values,
                                      torch.full_like(values, pad_value)))
    return out[:, :T]


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
    return _pack_left(best, keep, -1).to(torch.int32), neg_sum


def _segment_reduce(src, seg, n: int, reduce: str):
    """Per row, ``reduce`` ("amax" or "amin") of ``src`` over each of the
    ``n`` segments ``seg`` names. An empty segment holds 0; callers mask
    it (``jax.ops.segment_max`` would hold the dtype's minimum there)."""
    out = torch.zeros(src.shape[0], n, dtype=src.dtype, device=src.device)
    return out.scatter_reduce(1, seg, src, reduce, include_self=False)


def ctc_greedy_alignment(
    y_pred: torch.Tensor, input_length: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-character frame extent of the greedy path
    (``crnn_ocr_tpu/ops/ctc.py:260``).

    For each character that ``ctc_greedy_decode`` (merge_repeated=True)
    emits: the first and last frame of its argmax run (the maximal block of
    consecutive valid frames sharing that argmax label) and the peak
    softmax probability inside the run.

    Returns (labels, starts, ends, confs), all (B, T), left-packed as
    ``ctc_greedy_decode``'s output: labels, starts and ends int32 padded
    with -1, confs float32 padded with 0.
    """
    B, T, C = y_pred.shape
    blank = C - 1
    y_pred = y_pred.float()
    dev = y_pred.device
    input_length = input_length.to(device=dev, dtype=torch.int64).reshape(B)

    best = torch.argmax(y_pred, dim=-1)  # first maximum, as jnp.argmax
    pmax = torch.amax(y_pred, dim=-1)
    t_idx = torch.arange(T, device=dev)[None, :].expand(B, T)
    valid = t_idx < input_length[:, None]

    # invalid frames get an impossible label, so they never extend a run
    best_eff = torch.where(valid, best, torch.full_like(best, -2))
    prev = torch.cat([torch.full_like(best[:, :1], -3), best_eff[:, :-1]], 1)
    newrun = best_eff != prev  # frame 0 always starts a run
    seg_id = torch.cumsum(newrun, dim=1) - 1  # in [0, T)
    # every segment read back holds at least the frame that reads it
    run_end = _segment_reduce(t_idx, seg_id, T, "amax").gather(1, seg_id)
    run_conf = _segment_reduce(pmax, seg_id, T, "amax").gather(1, seg_id)

    keep = valid & (best != blank) & newrun  # one emission per run
    return (_pack_left(best, keep, -1).to(torch.int32),
            _pack_left(t_idx, keep, -1).to(torch.int32),
            _pack_left(run_end, keep, -1).to(torch.int32),
            _pack_left(run_conf, keep, 0.0))


def ctc_forced_alignment(
    y_pred: torch.Tensor,
    input_length: torch.Tensor,
    labels: torch.Tensor,
    label_length: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Viterbi alignment of a given label sequence
    (``crnn_ocr_tpu/ops/ctc.py:326``).

    The max-product CTC recursion over the blank-interleaved states
    (blank, l1, blank, ..., lL, blank): ``delta[t, s] = emit[t, s] +
    max(delta[t-1, s], delta[t-1, s-1], delta[t-1, s-2] if the skip is
    allowed)``, one loop forward with backpointers (ties: stay > diagonal >
    skip), one reversed loop for the state path, then per-label segment
    reductions.

    Args:
      y_pred: (B, T, C) post-softmax probabilities, blank = C-1.
      input_length: (B,) valid frame counts.
      labels: (B, L) label ids (values past ``label_length`` ignored).
      label_length: (B,) valid label counts (may be 0).

    Returns (starts, ends, confs, feasible): starts/ends (B, L) int32, the
    first/last frame the path spends in each label's state, -1 past
    ``label_length`` and on infeasible rows; confs (B, L) float32, the peak
    probability of the label in its span, 0 padded; feasible (B,) bool,
    False when no path exists.
    """
    B, T, C = y_pred.shape
    L = labels.shape[1]
    S = 2 * L + 1
    blank = C - 1
    y_pred = y_pred.float()
    dev = y_pred.device
    logp = torch.log(y_pred + KERAS_EPSILON)
    input_length = input_length.to(device=dev, dtype=torch.int64).reshape(B)
    label_length = label_length.to(device=dev, dtype=torch.int64).reshape(B)
    labels = labels.to(device=dev, dtype=torch.int64).clamp(0, C - 1)

    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)[:, :S]
    allow_skip = (ext != blank) & (ext != ext_m2)
    s_idx = torch.arange(S, device=dev)[None, :]
    valid_s = s_idx < (2 * label_length[:, None] + 1)
    emits = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S))

    init_mask = s_idx < torch.where(label_length > 0, 2, 1)[:, None]
    neg = torch.full((B, S), NEG, device=dev)
    delta = torch.where(init_mask & valid_s, emits[:, 0], neg)
    bps = torch.zeros((T, B, S), dtype=torch.int8, device=dev)
    for t in range(1, T):
        shift1 = torch.cat([neg[:, :1], delta[:, :-1]], dim=1)
        shift2 = torch.cat([neg[:, :2], delta[:, :-2]], dim=1)[:, :S]
        shift2 = torch.where(allow_skip, shift2, neg)
        best = torch.maximum(torch.maximum(delta, shift1), shift2)
        bp = torch.where(delta >= best, 0,
                         torch.where(shift1 >= best, 1, 2)).to(torch.int8)
        new = torch.where(valid_s, best + emits[:, t], neg)
        active = (t < input_length)[:, None]
        delta = torch.where(active, new, delta)
        bps[t] = torch.where(active, bp, torch.zeros_like(bp))

    # end state: the better of the final blank (2 len) and label (2 len - 1)
    idx_last = 2 * label_length
    idx_prev = torch.clamp(2 * label_length - 1, min=0)
    d_last = delta.gather(1, idx_last[:, None])[:, 0]
    d_prev = delta.gather(1, idx_prev[:, None])[:, 0]
    d_prev = torch.where(label_length > 0, d_prev, torch.full_like(d_prev,
                                                                   NEG))
    end_state = torch.where(d_prev > d_last, idx_prev, idx_last)
    feasible = torch.maximum(d_last, d_prev) > NEG / 2

    # backtrace: the carried state is the path's state at frame t (seeded
    # at t = input_length - 1; frames past it keep the end state)
    states = torch.empty((B, T), dtype=torch.int64, device=dev)
    cur = end_state
    for t in range(T - 1, -1, -1):
        cur = torch.where(t == input_length - 1, end_state, cur)
        states[:, t] = cur
        if t > 0:
            cur = cur - bps[t].gather(1, cur[:, None])[:, 0].to(torch.int64)

    t_idx = torch.arange(T, device=dev)[None, :].expand(B, T)
    valid_t = t_idx < input_length[:, None]
    # each frame's label position: odd states s -> (s - 1) // 2; blanks and
    # invalid frames -> the dump segment L
    is_label = (states % 2 == 1) & valid_t & feasible[:, None]
    pos = torch.where(is_label, (states - 1) // 2, torch.full_like(states, L))
    p_state = torch.gather(
        y_pred, 2, ext.gather(1, states.clamp(0, S - 1))[..., None])[..., 0]

    starts = _segment_reduce(t_idx, pos, L + 1, "amin")[:, :L]
    ends = _segment_reduce(t_idx, pos, L + 1, "amax")[:, :L]
    confs = _segment_reduce(p_state, pos, L + 1, "amax")[:, :L]
    # a label position with no frame (only past label_length or on an
    # infeasible row) pads with -1 / 0
    has = torch.zeros(B, L + 1, device=dev).scatter_add_(
        1, pos, torch.ones_like(p_state))[:, :L] > 0
    l_idx = torch.arange(L, device=dev)[None, :]
    keep = has & (l_idx < label_length[:, None]) & feasible[:, None]
    return (torch.where(keep, starts, -1).to(torch.int32),
            torch.where(keep, ends, -1).to(torch.int32),
            torch.where(keep, confs, torch.zeros_like(confs)),
            feasible)


def _lse(a, b):
    """log(exp(a) + exp(b)) with ``NEG`` as log 0 (both beams')."""
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(m > NEG / 2, out, NEG)


def ctc_beam_search_decode(
    y_pred: torch.Tensor,
    input_length: torch.Tensor,
    beam_width: int = 10,
    top_paths: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The admissible (textbook) prefix beam search
    (``crnn_ocr_tpu/ops/ctc.py:489``), kept beside the TF-exact decoder
    that ``ctc_decode`` routes to: it never returns a lower-probability
    path than TF's, whose in-step eviction loses mass on near-ties.

    A loop over frames of a (B, W, T) prefix buffer and (B, W) blank- and
    label-ending log-probs. Each frame expands every beam by every symbol,
    folds each grown candidate that equals a carried beam into it (found
    by a uint32 rolling hash, carried in int64), and keeps the top W of
    the W stays and W * C grown candidates (ties: lower pool index, stays
    first). Output labels merge adjacent repeats, as TF's default.

    Returns:
      decoded: (top_paths, B, T) int32, padded with -1.
      log_probs: (B, top_paths) float32 total prefix log-probabilities.
    """
    if top_paths > beam_width:
        raise ValueError(
            f"top_paths ({top_paths}) must be <= beam_width ({beam_width})"
        )
    B, T, C = y_pred.shape
    blank = C - 1
    W = beam_width
    dev = y_pred.device
    log_probs = torch.log_softmax(
        torch.log(y_pred.float() + KERAS_EPSILON), dim=-1)
    input_length = input_length.to(device=dev, dtype=torch.int64).reshape(B)
    hash_p = 1000003
    c_idx = torch.arange(C, device=dev)

    prefixes = torch.full((B, W, T), -1, dtype=torch.int64, device=dev)
    lengths = torch.zeros((B, W), dtype=torch.int64, device=dev)
    p_b = torch.full((B, W), NEG, device=dev)
    p_b[:, 0] = 0.0  # only the empty prefix is alive
    p_nb = torch.full((B, W), NEG, device=dev)
    hashes = torch.zeros((B, W), dtype=torch.int64, device=dev)

    for t in range(T):
        lp = log_probs[:, t]
        total = _lse(p_b, p_nb)
        last_sym = prefixes.gather(
            2, torch.clamp(lengths - 1, min=0)[:, :, None])[:, :, 0]
        last_sym = torch.where(lengths > 0, last_sym, -1)

        # stays: blank ending from the total, label ending from p_nb
        new_p_b = total + lp[:, blank][:, None]
        lp_last = lp.gather(1, torch.clamp(last_sym, min=0))
        new_p_nb_same = torch.where(lengths > 0, p_nb + lp_last,
                                    torch.full_like(p_nb, NEG))

        # grown candidates: from blank-ending mass always, from label-ending
        # mass only for another symbol; blank never extends
        ext_from_b = p_b[:, :, None] + lp[:, None, :]
        not_same = c_idx[None, None, :] != last_sym[:, :, None]
        ext_from_nb = torch.where(not_same, p_nb[:, :, None] + lp[:, None, :],
                                  torch.full_like(ext_from_b, NEG))
        ext_p_nb = _lse(ext_from_b, ext_from_nb)
        ext_p_nb[:, :, blank] = NEG

        # grown (i, sym_j) equal to carried beam j: fold its mass into j
        tgt = (hashes[:, :, None] * hash_p
               + (last_sym + 1)[:, None, :]) & 0xFFFFFFFF
        child = ((tgt == hashes[:, None, :])
                 & (lengths[:, None, :] == lengths[:, :, None] + 1)
                 & (lengths[:, None, :] > 0))  # (B, W_i, W_j)
        sym_j = torch.clamp(last_sym, min=0)[:, None, :].expand(B, W, W)
        grow_mass_to_j = torch.where(child, ext_p_nb.gather(2, sym_j),
                                     torch.full_like(child, NEG,
                                                     dtype=torch.float32))
        fold_max = grow_mass_to_j.amax(dim=1)
        fold_sum = torch.exp(
            grow_mass_to_j - torch.clamp(fold_max, min=NEG)[:, None, :]
        ).sum(dim=1)
        fold = torch.where(fold_max > NEG / 2, fold_max + torch.log(fold_sum),
                           torch.full_like(fold_max, NEG))
        new_p_nb_same = _lse(new_p_nb_same, fold)
        # kill (i, c) when some carried beam j is its child with symbol c
        kill = (child[:, :, :, None]
                & (last_sym[:, None, :, None] == c_idx[None, None, None, :])
                ).any(dim=2)
        ext_p_nb = torch.where(kill, torch.full_like(ext_p_nb, NEG), ext_p_nb)

        stay_total = _lse(new_p_b, new_p_nb_same)
        grow_total = ext_p_nb.reshape(B, W * C)
        all_total = torch.cat([stay_total, grow_total], dim=1)
        # top W, ties to the lower pool index (lax.top_k's order)
        topk_val, topk_idx = torch.sort(all_total, dim=1, descending=True,
                                        stable=True)
        topk_idx = topk_idx[:, :W]

        is_stay = topk_idx < W
        src_beam = torch.where(is_stay, topk_idx, (topk_idx - W) // C)
        sym = torch.where(is_stay, -1, (topk_idx - W) % C)
        sel_prefix = prefixes.gather(1, src_beam[:, :, None].expand(B, W, T))
        sel_len = lengths.gather(1, src_beam)
        app_pos = torch.clamp(sel_len, max=T - 1)
        t_ar = torch.arange(T, device=dev)[None, None, :]
        new_prefixes = torch.where(
            (t_ar == app_pos[:, :, None]) & (~is_stay)[:, :, None],
            sym[:, :, None], sel_prefix)
        new_lengths = torch.where(is_stay, sel_len, sel_len + 1)
        sel_p_b = torch.where(is_stay, new_p_b.gather(1, src_beam),
                              torch.full_like(p_b, NEG))
        stay_p_nb = new_p_nb_same.gather(1, src_beam)
        grow_p_nb = grow_total.gather(
            1, torch.clamp(topk_idx - W, 0, W * C - 1))
        sel_p_nb = torch.where(is_stay, stay_p_nb, grow_p_nb)
        sel_hash = hashes.gather(1, src_beam)
        new_hashes = torch.where(
            is_stay, sel_hash, (sel_hash * hash_p + (sym + 1)) & 0xFFFFFFFF)

        # frames past input_length: state frozen
        active = (t < input_length)[:, None]
        prefixes = torch.where(active[:, :, None], new_prefixes, prefixes)
        lengths = torch.where(active, new_lengths, lengths)
        p_b = torch.where(active, sel_p_b, p_b)
        p_nb = torch.where(active, sel_p_nb, p_nb)
        hashes = torch.where(active, new_hashes, hashes)

    total = torch.logaddexp(p_b, p_nb)
    order = torch.sort(-total, dim=1, stable=True)[1][:, :top_paths]
    P = top_paths
    out_prefix = prefixes.gather(1, order[:, :, None].expand(B, P, T))
    out_scores = total.gather(1, order)
    # TF's default merge_repeated: adjacent duplicate labels merge on output
    flat = out_prefix.reshape(B * P, T)
    prev = torch.cat([torch.full_like(flat[:, :1], -2), flat[:, :-1]], dim=1)
    keep = (flat != -1) & (flat != prev)
    merged = _pack_left(flat, keep, -1).reshape(B, P, T)
    return merged.permute(1, 0, 2).to(torch.int32), out_scores


def ctc_decode(
    y_pred: torch.Tensor,
    input_length: torch.Tensor,
    greedy: bool = True,
    beam_width: int = 10,
    top_paths: int = 1,
    merge_repeated: bool = True,
):
    """``K.ctc_decode`` (``crnn_ocr_tpu/ops/ctc.py:756``). Beam requests go
    to the TF-exact device beam (``ops/ctc_beam_device.py``).
    ``merge_repeated=True`` is ``K.ctc_decode``'s TF-V1 output merge (double
    letters collapse); False is standard CTC; the search and the scores are
    the same in both.

    Returns ``(decoded_list, log_prob)``: ``top_paths`` dense (B, T) int32
    tensors padded with -1 (greedy: one), and (B, top_paths) scores
    (greedy: (B, 1) ``neg_sum_logits``).
    """
    if greedy:
        decoded, score = ctc_greedy_decode(y_pred, input_length)
        return [decoded], score
    from crnn_ocr_torch.ops.ctc_beam_device import ctc_beam_search_decode_tf

    decoded, scores = ctc_beam_search_decode_tf(
        y_pred, input_length, beam_width=beam_width, top_paths=top_paths,
        merge_repeated=merge_repeated,
    )
    return [decoded[p] for p in range(top_paths)], scores


def trim_dense(decoded) -> List[List[int]]:
    """Strip -1 padding: dense (B, T) -> list of label lists."""
    rows = decoded.tolist() if isinstance(decoded, torch.Tensor) else decoded
    return [[int(v) for v in row if v != -1] for row in rows]
