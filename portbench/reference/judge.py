"""The comparison that decides ``correct``: the program's outputs judged by
the plain reference (``model.py``) on the same inputs.

Serving: for each sampled line the reference computes its posteriors on
the line's own canvas and bucket, then

* ``text_gap`` (nats): how far the served text lies below the reference's
  own answer. Greedy: the reference's best path log-prob less that of the
  best path collapsing to the served text. Beam: the log-likelihood of the
  reference's beam text less that of the served text. 0 where they agree;
  a near tie costs little, a wrong character a lot. The widest over the
  lines.
* ``score_gap`` (nats): the widest ``|served score - reference score|``:
  greedy, minus the summed per-frame maxima of ``log(p + 1e-7)``; beam,
  the beam's log-prob, on the lines whose texts agree.
* ``text_gap_mean``, ``score_gap_mean``: the same gaps' means over the
  lines, steady from seed to seed where a widest gap rides on the one
  line of the sample that rounding flips the most.

Training: the program's first three steps against the reference's on the
same batches and dropout seeds: ``loss_gap``, the widest relative gap of a
step's loss (``loss_gap_first``: the first step's); ``line_gap_median``
(nats), the median line's gap between its CTC loss under the logits of
the program's first step and under the reference's (``line_gap``: the
widest line's); ``grad_gap``, the worst leaf's gap between the norms of
the first clipped gradient, over the larger of the reference leaf's norm
and the median leaf's; ``change_gap``, the same of the parameters' change
after the three steps, over the leaves whose reference gradient is at
least a thousandth of the median leaf's (the others move under Adam by
round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.reference import ctc, model

UNREADABLE = 1e9  # a gap that no sound run reaches: text the classes lack


def _posteriors(samples, conf, W, device, q, rows: int = 64):
    """Per sample the (frames, C) float64 log-softmax of the reference's
    logits after the time slice."""
    out: List[np.ndarray] = [None] * len(samples)  # type: ignore
    by_bucket: Dict[int, List[int]] = {}
    for i, s in enumerate(samples):
        by_bucket.setdefault(s["bucket"], []).append(i)
    sl = conf["ctc_time_slice"]
    for bucket, idx in by_bucket.items():
        for k in range(0, len(idx), rows):
            part = idx[k:k + rows]
            x = torch.stack([model.preprocess(
                samples[i]["crop"], samples[i]["canvas_hw"], conf["height"],
                bucket, device) for i in part])
            with torch.no_grad():
                lp = torch.log_softmax(model.forward(W, x, conf, q=q)[:, sl:],
                                       dim=-1).double().cpu().numpy()
            for j, i in enumerate(part):
                h, w = samples[i]["crop"].shape
                out[i] = lp[j, :model.frames(h, w, conf, bucket)]
    return out


def _labels(text: str, classes: Dict[str, int]):
    try:
        return [classes[ch] for ch in text]
    except KeyError:
        return None


def _keras_lp(lp: np.ndarray) -> np.ndarray:
    """log(p + 1e-7), the decoders' input."""
    return np.log(np.exp(lp) + model.KERAS_EPS)


def reference_answers(samples, conf, decode, W, classes, device,
                      q: Callable = model.identity):
    """The reference's own (text, score) per sample, decoded as ``decode``
    asks: the control puts these in the program's place."""
    inv = {v: k for k, v in classes.items()}
    out = []
    for lp in _posteriors(samples, conf, W, device, q):
        klp = _keras_lp(lp)
        if decode.get("greedy", True):
            labels, _ = ctc.greedy(lp)
            score = -float(klp.max(1).sum())
        else:
            paths, scores = ctc.beam(klp, len(klp), decode["beam_width"], 1,
                                     conf["beam"]["merge_repeated"])
            labels, score = paths[0], scores[0]
        out.append(("".join(inv[c] for c in labels), score))
    return out


def judge_serve(samples, conf, decode, W, classes, device) -> dict:
    """``samples``: dicts of ``crop``, ``canvas_hw``, ``bucket`` and the
    served ``text`` and ``score``. Besides the numbers: ``_worst``, the
    line of the widest ``text_gap`` with the reference's own text."""
    inv = {v: k for k, v in classes.items()}
    lines, worst = [], None
    for s, lp in zip(samples, _posteriors(samples, conf, W, device,
                                          model.identity)):
        served = _labels(s["text"], classes)
        klp = _keras_lp(lp)
        if decode.get("greedy", True):
            gap = (float(lp.max(1).sum()) - ctc.best_path(lp, served)
                   if served is not None else UNREADABLE)
            sgap = abs(s["score"] + float(klp.max(1).sum()))
        else:
            paths, scores = ctc.beam(klp, len(klp), decode["beam_width"], 1,
                                     conf["beam"]["merge_repeated"])
            norm = klp - np.logaddexp.reduce(klp, axis=1, keepdims=True)
            gap = (ctc.log_likelihood(norm, paths[0])
                   - ctc.log_likelihood(norm, served)
                   if served is not None else UNREADABLE)
            sgap = abs(s["score"] - scores[0]) if served == paths[0] else 0.0
        gap = UNREADABLE if not np.isfinite(gap) else gap
        sgap = UNREADABLE if not np.isfinite(sgap) else sgap
        if worst is None or gap > worst["text_gap"]:
            own = (ctc.greedy(lp)[0] if decode.get("greedy", True)
                   else paths[0])
            worst = {"text_gap": gap, "served": s["text"],
                     "reference": "".join(inv[c] for c in own),
                     "bucket": s["bucket"], "frames": len(lp)}
        lines.append((gap, sgap))
    return {"text_gap": max(g for g, _ in lines),
            "score_gap": max(g for _, g in lines),
            "text_gap_mean": float(np.mean([g for g, _ in lines])),
            "score_gap_mean": float(np.mean([g for _, g in lines])),
            "_worst": worst}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names):
    """Per leaf |program norm - reference norm| over the larger of the
    reference leaf's norm and the median leaf's."""
    med = statistics.median(ref[k] for k in names)
    out = {}
    for k in names:
        p = prog.get(k)
        out[k] = 1.0 if p is None or not np.isfinite(p) else \
            abs(p - ref[k]) / max(ref[k], med, 1e-30)
    return out


def judge_train(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``model.train_steps``'s readings. The worst
    leaf's gaps and the median leaf's."""
    loss_gap = max(
        abs(p - r) / abs(r) if np.isfinite(p) else UNREADABLE
        for p, r in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][k] for k in names)
    moved = [k for k in names if ref["grad1"][k] >= 1e-3 * med]
    grad = _leaf_gaps(prog["grad1"], ref["grad1"], names)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    lines = prog.get("lines1")
    line = (np.abs(np.subtract(lines, ref["lines1"])) if lines is not None
            else np.array([UNREADABLE]))
    line = np.where(np.isfinite(line), line, UNREADABLE)
    return {"loss_gap": loss_gap,
            "line_gap_median": float(np.median(line)),
            "line_gap": float(line.max()),
            "loss_gap_first": abs(
                prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": grad[worst_g],
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap": change[worst_c],
            "change_gap_median": statistics.median(change.values()),
            "_grad_leaf": worst_g, "_change_leaf": worst_c,
            "_norms": [prog.get("norms"), ref.get("norms")],
            "_losses": [prog["losses"], ref["losses"]],
            "_left_out": [k for k in names if k not in moved],
            "__grad_leaves": grad, "__change_leaves": change,
            "__raw": {"prog": prog, "ref": ref}}
