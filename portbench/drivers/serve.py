"""The serving driver: a closed loop of one caller, each call the program's
``Predictor.predict_many`` over one document of the mix.

Set-up loads a predictor as ``load_pretrained`` does (the configuration's
bundled weights, its dtype, its buckets), builds the mix's documents from
the seed and runs ``warmup_calls`` documents: every bucket and partial
batch the window will see. The window calls document after document until
its time is up, and closes when the last call returns.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts, traffic


def quantize_dim(n: int, base: int = 16) -> int:
    """The canvas ladder the predictor packs a batch on: 16, 24, 32, 48,
    64, 96, ... (powers of two of ``base`` and their 1.5x midpoints)."""
    q = base
    while q < n:
        q = q * 3 // 2 if (q & (q - 1)) == 0 else q * 4 // 3
    return q


def batches_of(doc, buckets, height: int, batch_size: int):
    """``predict_many``'s grouping of a document: per line its bucket (the
    smallest that holds ``round(w * height / h)``, else the last) and the
    canvas of its chunk of ``batch_size`` lines of that bucket, in the
    order the lines came. Returns [(bucket, canvas_hw)] per line."""
    groups: Dict[int, List[int]] = {}
    for i, im in enumerate(doc):
        need = int(round(im.shape[1] * height / im.shape[0]))
        groups.setdefault(next((b for b in buckets if need <= b),
                               buckets[-1]), []).append(i)
    out = [None] * len(doc)
    for bucket in sorted(groups):
        idx = groups[bucket]
        for k in range(0, len(idx), batch_size):
            chunk = idx[k:k + batch_size]
            hw = (quantize_dim(max(doc[i].shape[0] for i in chunk)),
                  quantize_dim(max(doc[i].shape[1] for i in chunk)))
            for i in chunk:
                out[i] = (bucket, hw)
    return out


def quarters(done, t0: float, wall: float) -> list:
    """Lines a second in each quarter of the window, by when each unit of
    work (end time, lines) returned: whether the window warms up or
    stalls."""
    out = [0.0] * 4
    for t, n in done:
        out[min(3, int(4 * (t - t0) / wall))] += n
    return [n * 4 / wall for n in out]


class Driver:
    """One run's program, its traffic and its loop."""

    def __init__(self, conf, mix, seed: int, device, hooks=None):
        from crnn_ocr_torch.infer.pretrained import load_pretrained

        self.conf, self.mix, self.seed = conf, mix, seed
        self.device = torch.device(device)
        self.hooks = hooks or {}
        self.predictor = load_pretrained(
            conf["program"]["pretrained"], device=self.device,
            dtype=conf["dtype"], buckets=tuple(conf["buckets"]))
        counts.check_config(self.predictor.cfg, conf)
        self.docs = traffic.documents(mix, seed)
        self.decode = dict(mix["decode"])
        # per recorded call: (doc index, ms, end time, texts, scores), kept
        # compact so the window's garbage collector has little to walk
        self.calls: List[tuple] = []
        self.n_calls = 0
        for _ in range(mix["warmup_calls"]):
            self.call(record=False)
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, record: bool = True) -> int:
        k = self.n_calls % len(self.docs)
        t0 = time.perf_counter()
        preds = self.predictor.predict_many(
            self.docs[k], batch_size=self.mix["batch_size"], **self.decode)
        t1 = time.perf_counter()
        self.n_calls += 1
        if "predictions" in self.hooks:
            preds = self.hooks["predictions"](preds)
        if record:
            self.calls.append((k, (t1 - t0) * 1e3, t1,
                               [getattr(p, "text", None) for p in preds],
                               np.array([getattr(p, "score", np.nan)
                                         for p in preds], np.float64)))
        return len(preds)

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; the window closes when the
        last call returns, so every line it started counts, over all its
        time."""
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            self.call()
        wall = self.calls[-1][2] - t0
        lines = sum(len(c[3]) for c in self.calls)
        key = "serve" if self.decode.get("greedy", True) else "beam"
        return {f"{key}_lines_per_s": lines / wall,
                f"{key}_call_p95_ms": float(np.percentile(
                    [c[1] for c in self.calls], 95)),
                "_quarters": quarters([(c[2], len(c[3])) for c in self.calls],
                                      t0, wall)}

    def attempted_failed(self):
        n = sum(len(c[3]) for c in self.calls)
        bad = sum(sum(not isinstance(t, str) for t in c[3])
                  + int((~np.isfinite(c[4])).sum()) for c in self.calls)
        return n, bad

    def traced_work(self) -> dict:
        """Lines and model FLOPs of the recorded calls (the traced
        window's)."""
        flops = lines = 0
        for k, _, _, texts, _ in self.calls:
            for bucket, _ in batches_of(self.docs[k], self.conf["buckets"],
                                        self.conf["height"],
                                        self.mix["batch_size"]):
                flops += counts.model_flops(self.conf, bucket)
            lines += len(texts)
        return {"lines": lines, "flops": flops}

    def install_spans(self, rec) -> None:
        """Ranges of the benchmark's own around each ``predict`` call, the
        predictor's stages and each recurrent layer's forward."""
        p = self.predictor
        p.predict = rec.wrap("predict", p.predict)
        p.preprocess = rec.wrap("preprocess", p.preprocess)
        p.decode_dense = rec.wrap("decode", p.decode_dense)
        p._predictions = rec.wrap("decode", p._predictions)
        rec.wrap_rnns(p.model, self.conf)

    def release(self) -> None:
        del self.predictor
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def samples(self, n: int) -> List[dict]:
        """``n`` served lines drawn from the seed among the calls' lines,
        the line with the longest served text among them."""
        flat = [(c, i) for c, call in enumerate(self.calls)
                for i in range(len(call[3]))]
        rng = np.random.default_rng([self.seed, 4])
        pick = rng.choice(len(flat), min(n, len(flat)), replace=False)
        longest = max(range(len(flat)), key=lambda j: len(
            self.calls[flat[j][0]][3][flat[j][1]]))
        pick = sorted(set(int(j) for j in pick) | {longest})
        layout = {}
        out = []
        for j in pick:
            c, i = flat[j]
            k, _, _, texts, scores = self.calls[c]
            if k not in layout:
                layout[k] = batches_of(self.docs[k], self.conf["buckets"],
                                       self.conf["height"],
                                       self.mix["batch_size"])
            bucket, hw = layout[k][i]
            out.append({"crop": self.docs[k][i], "bucket": bucket,
                        "canvas_hw": hw, "text": texts[i],
                        "score": float(scores[i])})
        return out

    def check(self, W, classes) -> dict:
        from portbench.reference import judge

        return judge.judge_serve(self.samples(self.mix["check_lines"]),
                                 self.conf, self.decode, W, classes,
                                 self.device)
