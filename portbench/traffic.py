"""The one traffic generator: a mix file of ``traffic/`` plus a seed -> the
inputs of a run.

Every input is built from the 64 frozen ``fonts-hard`` text lines in
``data/fonts_hard_lines.npz`` (each line's crop, height, width and text).
A crop is rescaled to a seeded height with the bilinear ``resize`` below,
so two runs of one seed get the same bytes and two seeds the same sizes.

Serving mixes (``"driver": "serve"``) are documents: lists of grayscale
uint8 crops, each crop of one width class. The classes are fixed by the
normalized width ``round(w * 32 / h)`` the predictor routes by:

* ``short``: a prefix of a line cut at a light column, normalized width in
  ``[16, 64]``;
* ``b128``, ``b192``, ``b256``: a whole line whose normalized width falls
  in ``(64, 128]``, ``(128, 192]`` or ``(192, 256]``;
* ``long``: 2-3 whole lines joined with a white gap, wider than 256 (the
  predictor squeezes them into its last bucket).

A document holds a fixed count of each class (the mix's ``shares`` of
``doc_lines``, the rest to the last class), in a seeded order, so every
seed gives the same buckets and the same partial batches.

Training mixes (``"driver": "train"``) are raw host batches as the port's
``produce_batch`` takes them: a white-padded uint8 canvas, heights, widths,
labels padded to ``max_label`` and their lengths, from whole lines whose
frame count holds their labels. The first ``checked_steps`` batches share
no (line, height) pair.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LINES = os.path.join(HERE, "data", "fonts_hard_lines.npz")
HEIGHT = 32  # the model's input height: the width classes are normalized to it
CLASS_BOUNDS = {"short": (16, 64), "b128": (65, 128), "b192": (129, 192),
                "b256": (193, 256), "long": (257, 10 ** 6)}


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def source_lines():
    """(crops, texts): the 64 lines as (h, w) uint8 arrays and strings."""
    d = np.load(LINES)
    crops = [d["canvas"][i, :h, :w] for i, (h, w) in
             enumerate(zip(d["heights"], d["widths"]))]
    return crops, [str(t) for t in d["truth"]]


def _axis_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear weights, pixel centres aligned (half-pixel)."""
    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0, n_in - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (pos - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m


def resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of a uint8 image to (h, w)."""
    out = _axis_weights(img.shape[0], h) @ img.astype(np.float32) \
        @ _axis_weights(img.shape[1], w).T
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def norm_width(h: int, w: int) -> int:
    return int(round(w * HEIGHT / h))


def light_columns(img: np.ndarray) -> np.ndarray:
    """Columns where a prefix may be cut: local minima of the column's ink
    (within two columns each side) below the line's 30th percentile."""
    ink = (255.0 - img.astype(np.float32)).sum(0)
    pad = np.pad(ink, 2, constant_values=np.inf)
    win = np.stack([pad[k:k + len(ink)] for k in range(5)])
    keep = (ink <= win.min(0)) & (ink <= np.percentile(ink, 30))
    return np.nonzero(keep)[0]


def _join(parts: List[np.ndarray], gap: int) -> np.ndarray:
    hmax = max(p.shape[0] for p in parts)
    cols = []
    for i, p in enumerate(parts):
        if i:
            cols.append(np.full((hmax, gap), 255, np.uint8))
        cols.append(np.pad(p, ((0, hmax - p.shape[0]), (0, 0)),
                           constant_values=255))
    return np.concatenate(cols, axis=1)


def _crop_of_class(cls: str, rng, crops, cuts, mix) -> np.ndarray:
    """One crop of width class ``cls``, drawn by rejection from ``rng``;
    ``cuts[i]`` are line ``i``'s light columns."""
    lo, hi = CLASS_BOUNDS[cls]
    h_lo, h_hi = mix["height"]
    for _ in range(10_000):
        h = int(rng.integers(h_lo, h_hi + 1))
        i = int(rng.integers(len(crops)))
        if cls == "short":
            if len(cuts[i]) == 0:
                continue
            src = crops[i][:, :int(cuts[i][rng.integers(len(cuts[i]))]) + 1]
        elif cls == "long":
            n = int(rng.integers(mix["join"][0], mix["join"][1] + 1))
            parts = [crops[i]] + [crops[int(rng.integers(len(crops)))]
                                  for _ in range(n - 1)]
            src = _join(parts, int(rng.integers(mix["join_gap"][0],
                                                mix["join_gap"][1] + 1)))
        else:
            src = crops[i]
        w = max(1, int(round(src.shape[1] * h / src.shape[0])))
        if lo <= norm_width(h, w) <= hi:
            return resize(src, h, w)
    raise RuntimeError(f"no crop of class {cls} found")


def class_counts(mix: dict) -> Dict[str, int]:
    """The fixed number of crops of each class in one document."""
    n = mix["doc_lines"]
    names = list(mix["shares"])
    counts = {c: int(round(mix["shares"][c] * n)) for c in names[:-1]}
    counts[names[-1]] = n - sum(counts.values())
    return counts


def documents(mix: dict, seed: int) -> List[List[np.ndarray]]:
    """``mix["docs"]`` documents of ``mix["doc_lines"]`` crops each."""
    crops, _ = source_lines()
    rng = np.random.default_rng([seed, 1])
    counts = class_counts(mix)
    cuts = [light_columns(c) for c in crops]
    docs = []
    for _ in range(mix["docs"]):
        doc = [_crop_of_class(c, rng, crops, cuts, mix)
               for c, k in counts.items() for _ in range(k)]
        order = rng.permutation(len(doc))
        docs.append([doc[j] for j in order])
    return docs


def encode(texts: List[str], classes: Dict[str, int], max_len: int):
    labels = np.zeros((len(texts), max_len), np.int32)
    lens = np.zeros(len(texts), np.int32)
    for b, t in enumerate(texts):
        ids = [classes[ch] for ch in t]
        labels[b, :len(ids)] = ids
        lens[b] = len(ids)
    return labels, lens


def _frames_needed(text: str) -> int:
    """CTC's least frame count for ``text``: a frame a label, plus a blank
    between two equal neighbours."""
    return len(text) + sum(a == b for a, b in zip(text, text[1:]))


def train_batches(mix: dict, seed: int, classes: Dict[str, int],
                  downsample: int, time_slice: int) -> List[dict]:
    """``mix["pool_batches"]`` raw host batches of ``mix["batch"]`` lines at
    ``mix["bucket"]``. A row is a (line, height) pair whose normalized width
    fits the bucket and whose frames (``min(w_norm // downsample, T) -
    time_slice``) hold its labels."""
    crops, texts = source_lines()
    bucket, B = mix["bucket"], mix["batch"]
    T = bucket // downsample
    pairs = []
    for i, img in enumerate(crops):
        for h in range(mix["height"][0], mix["height"][1] + 1):
            w = max(1, int(round(img.shape[1] * h / img.shape[0])))
            wn = min(norm_width(h, w), bucket)
            frames = min(wn // downsample, T) - time_slice
            if (norm_width(h, w) <= bucket
                    and len(texts[i]) <= mix["max_label"]
                    and frames >= _frames_needed(texts[i])):
                pairs.append((i, h, w))
    rng = np.random.default_rng([seed, 2])
    n_first = mix["checked_steps"] * B
    if len(pairs) < n_first:
        raise RuntimeError(f"{len(pairs)} distinct rows for {n_first}")
    first = rng.permutation(len(pairs))[:n_first]
    picks = [first[k * B:(k + 1) * B] for k in range(mix["checked_steps"])]
    picks += [rng.choice(len(pairs), B, replace=False)
              for _ in range(mix["pool_batches"] - len(picks))]
    out = []
    for rows in picks:
        imgs = [resize(crops[pairs[r][0]], pairs[r][1], pairs[r][2])
                for r in rows]
        hs = np.array([im.shape[0] for im in imgs], np.int32)
        ws = np.array([im.shape[1] for im in imgs], np.int32)
        canvas = np.full((B, int(hs.max()), int(ws.max())), 255, np.uint8)
        for b, im in enumerate(imgs):
            canvas[b, :im.shape[0], :im.shape[1]] = im
        row_texts = [texts[pairs[r][0]] for r in rows]
        labels, lens = encode(row_texts, classes, mix["max_label"])
        out.append({"the_input": canvas, "heights": hs, "widths": ws,
                    "the_labels": labels, "label_length": lens,
                    "bucket": bucket, "texts": row_texts})
    return out
