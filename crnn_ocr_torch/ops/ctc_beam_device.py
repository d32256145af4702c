"""TF-exact CTC beam search on the device
(``crnn_ocr_tpu/ops/ctc_beam_device.py``).

TF's ``CTCBeamSearchDecoderOp`` inserts each step's candidates one at a
time against the current bottom of the beam, evicting it, and an evicted
beam regenerated later in the step comes back fresh (the behavioural spec
is ``ops/ctc_beam_exact.py``). The JAX module's docstring derives how that
sequential process decomposes into batched passes; in short:

  1. streaming insertion equals the top W of {stays} u {candidates} with
     ties in priority order (stays in score order, then candidates in
     (branch rank, label) order): a stable descending sort;
  2. a carried stay is never re-inserted by its parent's branch, so every
     (branch, label) pair whose child is a carried stay leaves the pool;
  3. which branches spawn children (their gates) resolves in one
     left-to-right pass over the W branches.

Each frame is answered by the first of three tiers whose proof holds for
every sample: a syntactic proof that the all-open top W is exact (fast),
an eviction bound (bound), or the exact sequential gating (exact). Each
tier's predicate implies that the next tier would agree, so the result is
the same whichever answers. A sample past its length passes every test
(the freeze discards its step; JAX's ladder tests it too, to the same
result). The ladder is a host ``if`` on one device bool
per tier (a sync per frame, two where the fast proof fails); the JAX
package's per-sub-block ladders (``DISPATCH_BLOCK > 0``) are not ported,
and both entry points refuse a non-zero ``DISPATCH_BLOCK``.

Conventions, as the JAX module: inputs are post-softmax probabilities,
per-frame scores ``log_softmax(log(p + 1e-7))`` in f32 whatever the input
dtype, ``NEG = -1e30`` a finite log 0 (only the score of a collapsed beam's
padding path is ``-inf``), returned scores total prefix log-probabilities,
dense outputs padded with -1. Prefix identities are two independent uint32
rolling hashes (both must match for a parent link), carried in int64 and
wrapped mod 2^32 after each multiply-add. ``lax.top_k`` returns ties in
index order and the semantics depend on it: every top-k here is a stable
descending sort, sliced. Frames are a Python loop; prefixes are rebuilt
after it from per-frame backpointers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crnn_ocr_torch.ops.ctc import KERAS_EPSILON, NEG, _lse, _pack_left
from crnn_ocr_torch.utils.profiling import span

HASH_P = 1000003
HASH_P2 = 16777619  # FNV-32 prime; the second, independent rolling hash
ROOT_SENTINEL = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF
# The JAX package's tier-dispatch block (samples a ladder; 0: one ladder
# for the batch). The port has only the batch-global ladder, JAX's default;
# ``_batch_global_ladder`` refuses any other value.
DISPATCH_BLOCK = 0


def _batch_global_ladder() -> None:
    if DISPATCH_BLOCK:
        raise NotImplementedError(
            f"DISPATCH_BLOCK = {DISPATCH_BLOCK}: the port runs one tier "
            "ladder for the whole batch (DISPATCH_BLOCK = 0); per-sub-block "
            "ladders are not ported")


def _sel1(onehot, vals):
    """``vals[b, j]`` at each row's one hit of ``onehot`` (B, K, W), 0 where
    the row has none: a select-reduce, exact since at most one term is
    non-zero."""
    return torch.where(onehot, vals[:, None, :], 0).sum(dim=2)


def _topk(x, k: int):
    """``lax.top_k`` along the last axis: values descending, ties to the
    lower index (a stable sort; ``torch.topk`` documents no tie order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# Tier machinery. Each function takes ``p``: the per-sample tensors that
# ``_beam_step`` builds (keys: total, s_total, stay_total, inv_perm, cv_b,
# pool_idx_b, last_label, lp, lp_label, par_total, par_p_b, par_label,
# parent_found, parent_idx, alive, eligible, topv1, topi1, cheap_s,
# cheap_safe, bsel, ok_a, ok_c).
# ---------------------------------------------------------------------------


def _evict_counts(p, W: int, C: int):
    """Eviction counts shared by the bound and exact tiers
    (``ctc_beam_device.py:142``): the stays above each stay, each branch's
    top-(W+1) candidates above each stay (capped at W+1, which is
    decision-exact under the ``>= W`` threshold), and the parent's
    candidates before the regeneration label, counted exactly over its
    full candidate row (the total-route lanes plus +/-1 corrections for the
    patched lanes)."""
    iW, c_ar = p["iW"], p["iC"][None, None, :]
    stay_total, inv_perm = p["stay_total"], p["inv_perm"]
    cv_b = p["cv_b"]
    sv_j = stay_total[:, :, None]
    sv_k = stay_total[:, None, :]
    # priority: value desc; ties -> stays in stay sort order
    stays_above = ((sv_k > sv_j)
                   | ((sv_k == sv_j)
                      & (inv_perm[:, None, :] < inv_perm[:, :, None]))
                   ).sum(2)
    cgt = cv_b[:, None, :, :] > stay_total[:, :, None, None]
    above_cnt = cgt.sum(3)  # (B, Wj, Wi), capped at K1
    pj = torch.where(p["parent_found"], p["parent_idx"], W)
    pj_onehot = pj[:, :, None] == iW[None, None, :]
    lab_lt = c_ar < torch.clamp(p["last_label"], min=0)[:, :, None]
    nonblank = c_ar != (C - 1)
    base = ((p["lp"][:, None, :] + p["par_total"][:, :, None] > sv_j)
            & lab_lt & nonblank).sum(2)
    par_label = p["par_label"]
    par_lp_lab = _sel1(pj_onehot, p["lp_label"])
    kappa = torch.clamp(p["last_label"], min=0)
    patch_in = (par_label < kappa) & (par_label >= 0)
    v_total = p["par_total"] + par_lp_lab
    v_patch = p["par_p_b"] + par_lp_lab
    child_lab = p["last_label"]
    child_of_par = (p["parent_found"][:, None, :]
                    & (p["parent_idx"][:, None, :] == pj[:, :, None]))
    patch_excl = (child_of_par
                  & (child_lab[:, None, :] == par_label[:, :, None])).any(2)
    gt_total = (v_total > stay_total).to(torch.int64)
    gt_patch = (v_patch > stay_total).to(torch.int64)
    corr = torch.where(
        patch_in,
        -gt_total + torch.where(patch_excl, 0, gt_patch), 0)
    excl_sub = (
        child_of_par
        & (child_lab[:, None, :] != par_label[:, :, None])
        & (child_lab[:, None, :] < kappa[:, :, None])
        & (p["lp_label"][:, None, :] + p["par_total"][:, :, None] > sv_j)
    ).sum(2)
    partial_pj = base + corr - excl_sub
    return stays_above, above_cnt, partial_pj, pj, pj_onehot


def _bound_safe(p, counts, W: int, C: int):
    """Per sample: the eviction bound proves the all-open top W exact
    (``ctc_beam_device.py:238``). A stay provably never evicted before its
    parent's regeneration cannot be zeroed; branches provably closed (their
    total under the W-th best of {stays} u {branch 0's candidates} while
    branch 0 is open) add no candidates to the count."""
    iW = p["iW"]
    stays_above, above_cnt, partial_pj, pj, pj_onehot = counts
    s_total, total = p["s_total"], p["total"]
    n_finite_stays = (s_total > NEG / 2).sum(1)
    bottom_start = s_total[:, W - 1]
    b0_open = p["eligible"][:, 0] & ((n_finite_stays < W)
                                     | (total[:, 0] > bottom_start))
    union0 = torch.cat([s_total, p["cv_b"][:, 0, :]], dim=1)
    bottom_lb = _topk(union0, W)[0][:, W - 1]
    notclosed = ~(b0_open[:, None] & (iW[None, :] >= 1)
                  & (total <= bottom_lb[:, None]))
    full = torch.where(
        (iW[None, None, :] < pj[:, :, None]) & notclosed[:, None, :],
        above_cnt, 0).sum(2)
    par_notclosed = (pj_onehot & notclosed[:, None, :]).any(2)
    prior = stays_above + full + torch.where(
        par_notclosed, partial_pj, 0)
    safe_zero = p["cheap_safe"] | (prior < W)
    ok_b = (~p["bsel"] | safe_zero).all(1)
    return p["ok_a"] & ok_b & p["ok_c"]


def _exact_gates(p, counts, W: int, C: int):
    """The exact sequential gates, one left-to-right pass over the W sweeps
    (``ctc_beam_device.py:295``): sweep j's gate and zeroing depend only on
    sweeps < j; a running top-W value buffer (its last lane the bottom) is
    merged with each opened branch's top-(W+1) candidates. What does not
    depend on earlier sweeps is computed for all j before the loop."""
    dev, iW = p["iW"].device, p["iW"]
    stays_above, above_cnt, partial_pj, pj, pj_onehot = counts
    s_total, cv_b = p["s_total"], p["cv_b"]
    B = s_total.shape[0]
    # finite candidates per branch, capped at K1 (the underfull test only)
    cand_fin = (cv_b > NEG / 2).sum(2)
    # branch j's candidates before its parent, and whether its stay can be
    # zeroed at all (a parent that sweeps before it)
    above_lt = torch.where(iW[None, None, :] < pj[:, :, None], above_cnt, 0)
    can_zero = p["alive"] & p["parent_found"] & (p["parent_idx"] < iW)
    open_ = torch.zeros((B, W), dtype=torch.bool, device=dev)
    zeroed_acc = torch.zeros((B, W), dtype=torch.bool, device=dev)
    R = s_total
    n_inc = (s_total > NEG / 2).sum(1)
    for j, (par_oh, above_j, sa_j, ppj_j, cz_j, el_j, tot_j, fin_j,
            cand_j) in enumerate(zip(
                pj_onehot.unbind(1), above_lt.unbind(1), stays_above.unbind(1),
                partial_pj.unbind(1), can_zero.unbind(1),
                p["eligible"].unbind(1), p["total"].unbind(1),
                cand_fin.unbind(1), cv_b.unbind(1))):
        par_open_j = (par_oh & open_).any(1)
        prior_j = sa_j + (above_j * open_).sum(1) + ppj_j * par_open_j
        zeroed_j = cz_j & par_open_j & (prior_j >= W)
        open_j = el_j & ~zeroed_j & ((n_inc < W) | (tot_j > R[:, W - 1]))
        open_[:, j] = open_j
        zeroed_acc[:, j] = zeroed_j
        n_inc = n_inc + fin_j * open_j
        R = _topk(torch.cat([R, torch.where(open_j[:, None], cand_j, NEG)],
                            dim=1), W)[0]
    return open_, zeroed_acc


def _slow_path(p, counts, W: int, C: int):
    """The gated top W off the per-branch prefilter
    (``ctc_beam_device.py:384``): a top W of the open branches' candidates,
    then a top W of the stays and those, stays first on ties."""
    s_total, cv_b = p["s_total"], p["cv_b"]
    B, _, K1 = cv_b.shape
    open_, _ = _exact_gates(p, counts, W, C)
    cand_r = torch.where(open_[:, :, None], cv_b, NEG).reshape(B, W * K1)
    cv, ci = _topk(cand_r, W)
    ci_full = p["pool_idx_b"].reshape(B, W * K1).gather(1, ci)
    tv, mpos = _topk(torch.cat([s_total, cv], dim=1), W)
    cpick = ci_full.gather(1, torch.clamp(mpos - W, min=0))
    ti = torch.where(mpos < W, mpos, cpick)
    return tv, ti


def _all_on_host(ok) -> bool:
    """One host read of a device bool: the host waits for the card here."""
    with span("crnn.beam.sync"):
        return bool(ok.all())


def _tier_dispatch(p, W: int, C: int):
    """The three-tier ladder over the batch: the cheap syntactic proof,
    then the eviction bound, then the exact gating. Each test is one device
    bool read on the host. A frozen sample (``p["frozen"]``, past its
    length) passes every test: the freeze discards its step, so any tier's
    answer is exact for it. Returns ``(values, pool indices)`` of the new
    beam."""
    fast = p["topv1"][:, :W], p["topi1"][:, :W]
    frozen = p["frozen"]
    if _all_on_host(p["cheap_s"] | frozen):
        return fast
    with span("crnn.beam.bound"):
        counts = _evict_counts(p, W, C)
        safe = _bound_safe(p, counts, W, C) | frozen
    if _all_on_host(safe):
        return fast
    with span("crnn.beam.exact"):
        return _slow_path(p, counts, W, C)


def _aranges(W: int, C: int, device) -> dict:
    """The index vectors a step compares against, made once a decode
    (``iK``: the per-branch shared top's ``Ks = min(W + 1, C - 1)`` lanes
    and the patch lane)."""
    return {"iW": torch.arange(W, device=device),
            "iC": torch.arange(C, device=device),
            "iK": torch.arange(min(W + 1, C - 1) + 1, device=device)}


def _beam_step(state, lp, ar: dict, frozen, *, W: int, C: int,
               diag: bool = False):
    """One TF-exact beam step (``ctc_beam_device.py:442``). ``frozen``
    (B,) bool: the samples whose step the caller discards (False: none).
    With ``diag`` it also returns the per-sample dispatch predicates (see
    :func:`ctc_beam_tier_stats`)."""
    (total, p_b, p_nb, hashes, hashes2, parent_hash, parent_hash2,
     last_label, length, alive) = state
    B = lp.shape[0]
    blank = C - 1
    iW = ar["iW"]

    # ---- phase 1: the stays ----
    # parent of slot j: the alive slot k with both hashes equal to j's
    # parent hashes and one label shorter (at most one)
    pmatch = ((hashes[:, None, :] == parent_hash[:, :, None])
              & (hashes2[:, None, :] == parent_hash2[:, :, None])
              & (length[:, None, :] == length[:, :, None] - 1)
              & alive[:, None, :] & alive[:, :, None]
              & (length[:, :, None] > 0))
    parent_found = pmatch.any(2)
    parent_idx = pmatch.to(torch.int32).argmax(2)  # first hit, 0 for none
    par_total = _sel1(pmatch, total)
    par_p_b = _sel1(pmatch, p_b)
    par_label = _sel1(pmatch, last_label)
    prev_route = torch.where(last_label == par_label, par_p_b, par_total)
    fold = torch.where(parent_found, prev_route, NEG)

    # lp at each slot's last label (0 for the root's -1, unused there)
    lp_label = torch.where(
        last_label >= 0, lp.gather(1, torch.clamp(last_label, min=0)), 0.0)
    has_label = length > 0
    new_p_nb = torch.where(has_label, _lse(p_nb, fold) + lp_label, p_nb)
    new_p_b = total + lp[:, blank][:, None]
    stay_total = torch.where(alive, _lse(new_p_b, new_p_nb), NEG)
    new_p_b = torch.where(alive, new_p_b, NEG)
    new_p_nb = torch.where(alive, new_p_nb, NEG)

    # stays sorted descending, ties in carried order (TF's stable re-sort);
    # inv_perm[j]: the sorted position of slot j's stay
    neg_s, perm = torch.sort(-stay_total, dim=1, stable=True)
    s_total = -neg_s
    sv_j = stay_total[:, :, None]
    sv_k = stay_total[:, None, :]
    inv_perm = ((sv_k > sv_j)
                | ((sv_k == sv_j) & (iW[None, None, :] < iW[None, :, None]))
                ).sum(2)

    # ---- phase 2: the candidate pool, per branch its top (W+1) ----
    # cand[i, l] = total_i + lp[l], except branch i's own last label (the
    # blank route: p_b_i + lp), its child-stay exclusions, blank and dead
    # branches. Per-branch top from one shared top M of lp (labels
    # ascending, so positional ties are label order) plus the patch lane,
    # inserted at its exact (value desc, label asc) position.
    eligible = alive & (total > NEG / 2)
    K1 = min(W + 1, C)
    M = min(C - 1, K1 + W + 1)
    lp_nb = torch.where(ar["iC"][None, :] == blank, NEG, lp)
    glv, gli = _topk(lp_nb, M)
    gli_s, order = torch.sort(gli, dim=1)  # labels ascending (distinct)
    glv_s = glv.gather(1, order)
    child_of = ((parent_hash[:, None, :] == hashes[:, :, None])
                & (parent_hash2[:, None, :] == hashes2[:, :, None])
                & (length[:, None, :] == length[:, :, None] + 1)
                & alive[:, None, :] & alive[:, :, None])  # (B, i, k)
    sh_excl = (child_of[:, :, :, None]
               & (last_label[:, None, :, None] == gli_s[:, None, None, :])
               ).any(2)
    sh_own = gli_s[:, None, :] == last_label[:, :, None]
    sh_vals = glv_s[:, None, :] + total[:, :, None]
    sh_vals = torch.where(sh_excl | sh_own | ~alive[:, :, None], NEG,
                          sh_vals)
    Ks = min(K1, M)
    sv_k1, sp_k1 = _topk(sh_vals, Ks)  # (B, W, Ks)
    sl_k1 = gli_s[:, None, :].expand(B, W, M).gather(2, sp_k1)
    patch_excl = (child_of
                  & (last_label[:, None, :] == last_label[:, :, None])).any(2)
    patch_ok = has_label & alive & ~patch_excl
    patch_val = torch.where(patch_ok, p_b + lp_label, NEG)[:, :, None]
    patch_lab = torch.where(patch_ok, last_label, blank)[:, :, None]
    beats = (sv_k1 > patch_val) | ((sv_k1 == patch_val)
                                   & (sl_k1 < patch_lab))
    pos = beats.sum(2)[:, :, None]
    iK = ar["iK"][None, None, :]
    prev_v = torch.cat([sv_k1[:, :, :1], sv_k1], dim=2)
    prev_l = torch.cat([sl_k1[:, :, :1], sl_k1], dim=2)
    here_v = torch.cat([sv_k1, sv_k1[:, :, -1:]], dim=2)
    here_l = torch.cat([sl_k1, sl_k1[:, :, -1:]], dim=2)
    cv_b = torch.where(iK < pos, here_v, torch.where(
        iK == pos, patch_val.expand_as(here_v), prev_v))[:, :, :K1]
    ci_b = torch.where(iK < pos, here_l, torch.where(
        iK == pos, patch_lab.expand_as(here_l), prev_l))[:, :, :K1]
    pool_idx_b = W + iW[None, :, None] * C + ci_b  # index in [stays | cand]
    small_idx = torch.cat([iW[None, :].expand(B, W),
                           pool_idx_b.reshape(B, W * K1)], dim=1)

    # ---- the fast path: all gates open == one top (W+1) ----
    small_pool = torch.cat([s_total, cv_b.reshape(B, W * K1)], dim=1)
    topv1, sp = _topk(small_pool, W + 1)
    topi1 = small_idx.gather(1, sp)
    bottom_final = topv1[:, W - 1]
    sel_idx = topi1[:, :W]
    sel_is_cand = sel_idx >= W
    sel_branch = torch.clamp((sel_idx - W) // C, 0, W - 1)
    bsel = (sel_is_cand[:, :, None]
            & (sel_branch[:, :, None] == iW[None, None, :])).any(1)
    stay_in_top = ((~sel_is_cand[:, :, None])
                   & (sel_idx[:, :, None] == inv_perm[:, None, :])).any(1)
    ok_a = (~bsel | (total > bottom_final[:, None])).all(1)
    ok_c = (topv1[:, W - 1] > topv1[:, W]) | (topv1[:, W] <= NEG / 2)
    cheap_safe = stay_in_top | ~parent_found | (parent_idx >= iW[None, :])
    cheap_s = ok_a & (~bsel | cheap_safe).all(1) & ok_c

    per = dict(
        iW=iW, iC=ar["iC"], total=total, s_total=s_total,
        stay_total=stay_total,
        inv_perm=inv_perm, cv_b=cv_b, pool_idx_b=pool_idx_b,
        last_label=last_label, lp=lp, lp_label=lp_label,
        par_total=par_total, par_p_b=par_p_b, par_label=par_label,
        parent_found=parent_found, parent_idx=parent_idx, alive=alive,
        eligible=eligible, topv1=topv1, topi1=topi1, cheap_s=cheap_s,
        cheap_safe=cheap_safe, bsel=bsel, ok_a=ok_a, ok_c=ok_c,
        frozen=frozen,
    )
    top_vals, top_idx = _tier_dispatch(per, W, C)

    is_stay = top_idx < W
    stay_branch = perm.gather(1, torch.clamp(top_idx, max=W - 1))
    cand_branch = torch.clamp((top_idx - W) // C, 0, W - 1)
    cand_label = (top_idx - W) % C
    src = torch.where(is_stay, stay_branch, cand_branch)  # carried slot

    def gather(a):
        return a.gather(1, src)

    src_hash, src_hash2 = gather(hashes), gather(hashes2)
    lab1 = cand_label + 1
    src_len = gather(length)
    n_alive = top_vals > NEG / 2
    new_state = (
        top_vals,
        torch.where(is_stay, gather(new_p_b), NEG),
        torch.where(is_stay, gather(new_p_nb), top_vals),
        torch.where(is_stay, src_hash, (src_hash * HASH_P + lab1) & MASK32),
        torch.where(is_stay, src_hash2,
                    (src_hash2 * HASH_P2 + lab1) & MASK32),
        torch.where(is_stay, gather(parent_hash), src_hash),
        torch.where(is_stay, gather(parent_hash2), src_hash2),
        torch.where(is_stay, gather(last_label), cand_label),
        torch.where(is_stay, src_len, src_len + 1),
        n_alive,
    )
    bp_label = torch.where(is_stay | ~n_alive, -1, cand_label)
    if diag:
        dcounts = _evict_counts(per, W, C)
        ex_open, ex_zeroed = _exact_gates(per, dcounts, W, C)
        diag_out = (cheap_s, _bound_safe(per, dcounts, W, C), ok_a, ok_c,
                    (~bsel | cheap_safe).all(1), bsel, cheap_safe, ex_open,
                    ex_zeroed)
        return new_state, (src, bp_label), diag_out
    return new_state, (src, bp_label)


def _init_state(B: int, W: int, device):
    """The initial beam: the root (empty prefix) alone in slot 0."""
    def neg():
        return torch.full((B, W), NEG, device=device)

    total, p_b = neg(), neg()
    total[:, 0] = 0.0
    p_b[:, 0] = 0.0
    alive = torch.zeros((B, W), dtype=torch.bool, device=device)
    alive[:, 0] = True
    zeros = torch.zeros((B, W), dtype=torch.int64, device=device)
    root = torch.full((B, W), ROOT_SENTINEL, dtype=torch.int64,
                      device=device)
    return (total, p_b, neg(), zeros, zeros.clone(), root, root.clone(),
            torch.full((B, W), -1, dtype=torch.int64, device=device),
            zeros.clone(), alive)


def _log_probs(y_pred, input_length):
    """``log_softmax(log(p + 1e-7))`` in f32, and the lengths as int64 on
    the probabilities' device."""
    B = y_pred.shape[0]
    lp = torch.log_softmax(torch.log(y_pred.float() + KERAS_EPSILON), dim=-1)
    return lp, input_length.to(device=lp.device,
                               dtype=torch.int64).reshape(B)


def _freeze(state, new_state, frozen):
    return tuple(torch.where(frozen, old, new)
                 for old, new in zip(state, new_state))


@torch.inference_mode()
def ctc_beam_tier_stats(
    y_pred: torch.Tensor,
    input_length: torch.Tensor,
    beam_width: int = 10,
) -> Tuple[torch.Tensor, ...]:
    """Per-(frame, sample) tier admission of the exact decoder
    (``ctc_beam_device.py:776``): a 9-tuple stacked over the T frames,
    ``(cheap, bound, ok_a, ok_c, ok_zero_cheap)`` each (T, B) and
    ``(bsel, cheap_safe, exact_open, exact_zeroed)`` each (T, B, W); a
    frozen sample (t >= its input length) reads True. The state advances
    through the normal dispatch; every frame also pays the exact tier's
    gates."""
    _batch_global_ladder()
    B, T, _ = y_pred.shape
    C = y_pred.shape[2]
    W = beam_width
    lp_all, input_length = _log_probs(y_pred, input_length)
    state = _init_state(B, W, lp_all.device)
    ar = _aranges(W, C, lp_all.device)
    out = []
    for t in range(T):
        frozen = t >= input_length
        new_state, _, diag_out = _beam_step(state, lp_all[:, t], ar, frozen,
                                            W=W, C=C, diag=True)
        state = _freeze(state, new_state, frozen[:, None])
        out.append(tuple(d | (frozen[:, None] if d.dim() == 2 else frozen)
                         for d in diag_out))
    return tuple(torch.stack(ds) for ds in zip(*out))


@torch.inference_mode()
def ctc_beam_search_decode_tf(
    y_pred: torch.Tensor,
    input_length: torch.Tensor,
    beam_width: int = 10,
    top_paths: int = 1,
    merge_repeated: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TF-exact batched beam search on ``y_pred``'s device
    (``ctc_beam_device.py:828``).

    Args:
      y_pred: (B, T, C) post-softmax probabilities; blank = C-1.
      input_length: (B,) valid frame counts.

    Returns:
      decoded: (top_paths, B, T) int32, padded with -1 (adjacent duplicates
        merged when ``merge_repeated``).
      log_probs: (B, top_paths) float32 total prefix log-probabilities
        (-inf for a collapsed beam's padding paths, as the host oracle).
    """
    if top_paths > beam_width:
        raise ValueError(
            f"top_paths ({top_paths}) must be <= beam_width ({beam_width})"
        )
    _batch_global_ladder()
    B, T, C = y_pred.shape
    W = beam_width
    lp_all, input_length = _log_probs(y_pred, input_length)
    dev = lp_all.device
    ar = _aranges(W, C, dev)
    # the lengths on the host (one sync): no sample freezes before the
    # shortest, and frames past the longest freeze the whole batch and
    # leave identity backpointers, so they are not run
    with span("crnn.beam.sync"):
        lengths = input_length.tolist()
    n_frames = max(0, min(T, max(lengths, default=0)))
    n_free = min(lengths, default=0)
    state = _init_state(B, W, dev)
    bps, bpl = [], []
    for t in range(n_frames):
        frozen = (t >= input_length) if t >= n_free else False
        with span("crnn.beam.frame"):
            new_state, (bp_src, bp_label) = _beam_step(
                state, lp_all[:, t], ar, frozen, W=W, C=C)
        if t < n_free:
            state = new_state
        else:
            state = _freeze(state, new_state, frozen[:, None])
            bp_src = torch.where(frozen[:, None], ar["iW"], bp_src)
            bp_label = torch.where(frozen[:, None], -1, bp_label)
        bps.append(bp_src)
        bpl.append(bp_label)

    # the final beam is in TF's final order (descending, stable) already
    P = top_paths
    total, alive = state[0], state[-1]
    alive_sel = alive[:, :P]
    scores = torch.where(alive_sel, total[:, :P], float("-inf"))

    # prefixes from the backpointers, walked back from the last frame
    with span("crnn.beam.backtrack"):
        labs = torch.full((B, P, T), -1, dtype=torch.int64, device=dev)
        cur = torch.arange(P, device=dev)[None, :].expand(B, P)
        for t in range(n_frames - 1, -1, -1):
            labs[:, :, t] = bpl[t].gather(1, cur)
            cur = bps[t].gather(1, cur)
        labs = labs.reshape(B * P, T)
        labs = torch.where(alive_sel.reshape(B * P, 1), labs, -1)
        packed = _pack_left(labs, labs != -1, -1)
        if merge_repeated:
            prev = torch.cat([torch.full_like(packed[:, :1], -2),
                              packed[:, :-1]], dim=1)
            packed = _pack_left(packed, (packed != -1) & (packed != prev),
                                -1)
        decoded = packed.reshape(B, P, T).permute(1, 0, 2).to(torch.int32)
    return decoded, scores
