"""The STN model's training driver: ``drivers/train.py``'s loop (fine-tuning
as the port's ``fit`` runs it on one device, ``produce_batch`` then
``train_step``, each step's dropout generator seeded anew) on the STN
task's own lines, judged by the STN's plain reference
(``reference/stn.py``).

The host batches follow ``traffic.train_batches``'s rule over the lines
the mix names (``"lines"``, a file of ``data/`` in
``fonts_hard_lines.npz``'s layout; ``warp_batches`` below): warped lines,
on which the model's theta departs from the identity, so K11 and K12
sample for real.

The check adds one number to ``judge.judge_train``'s: ``warp_grad_gap``,
the first step's gradient of the loss at theta (B, 6), which K12 and the
affine grid's backward make from the plain stem's image gradient, against
the reference warp's backward (``reference/stn.py::warp``, float32) at the
program's own operands: the frames and theta the warp read and the
gradient at its output; ``|dtheta - ref| / |ref|``. The gradient norms and
the change the judge reads are blind to that gradient's sign and scale
(Adam's first step is ``lr * sign(g)``), and the whole model's gradient at
theta differs from the float32 reference's by most of its norm in
bfloat16 (theta's rounding moves the sampling points by up to half a
pixel, across the text's edges); on the program's own operands it differs
by the rounding of dtheta alone.

A traced run also counts K11's and K12's launches over its window (the
kernels' own counters), and counts the STN's operations in the step's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from portbench import counts, traffic
from portbench.drivers import train
from portbench.reference import judge, model, stn

KERNEL = 5  # the localization convolutions' 5x5
THETA = 6


def stn_flops(conf: dict) -> int:
    """Forward operations of the STN for one line (a multiply-add counts
    2): its convolutions and Dense layers; the pools, the grid and the
    bilinear sample are left out, as ``counts.layer_flops`` leaves out
    pools and activations."""
    H, W, c = conf["height"] // 2, conf["width"] // 2, 1
    ops = 0
    for f in conf["stn_loc_filters"]:
        ops += 2 * KERNEL * KERNEL * c * f * H * W
        c, H, W = f, H // 2, W // 2
    d = conf["stn_loc_dense"]
    return ops + 2 * c * H * W * d + 2 * d * THETA


def lines_of(mix: dict):
    """(crops, texts) of the mix's lines file."""
    d = np.load(os.path.join(traffic.HERE, "data", mix["lines"]))
    crops = [d["canvas"][i, :h, :w] for i, (h, w) in
             enumerate(zip(d["heights"], d["widths"]))]
    return crops, [str(t) for t in d["truth"]]


def warp_batches(mix: dict, seed: int, classes, downsample: int,
                 time_slice: int) -> List[dict]:
    """``traffic.train_batches`` over the mix's lines: the same rows, draws
    and batch layout."""
    crops, texts = lines_of(mix)
    bucket, B = mix["bucket"], mix["batch"]
    T = bucket // downsample
    pairs = []
    for i, img in enumerate(crops):
        for h in range(mix["height"][0], mix["height"][1] + 1):
            w = max(1, int(round(img.shape[1] * h / img.shape[0])))
            wn = traffic.norm_width(h, w)
            frames = min(min(wn, bucket) // downsample, T) - time_slice
            if (wn <= bucket and len(texts[i]) <= mix["max_label"]
                    and frames >= traffic._frames_needed(texts[i])):
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
        imgs = [traffic.resize(crops[pairs[r][0]], pairs[r][1], pairs[r][2])
                for r in rows]
        hs = np.array([im.shape[0] for im in imgs], np.int32)
        ws = np.array([im.shape[1] for im in imgs], np.int32)
        canvas = np.full((B, int(hs.max()), int(ws.max())), 255, np.uint8)
        for b, im in enumerate(imgs):
            canvas[b, :im.shape[0], :im.shape[1]] = im
        row_texts = [texts[pairs[r][0]] for r in rows]
        labels, lens = traffic.encode(row_texts, classes, mix["max_label"])
        out.append({"the_input": canvas, "heights": hs, "widths": ws,
                    "the_labels": labels, "label_length": lens,
                    "bucket": bucket, "texts": row_texts})
    return out


def warp_grad_gap(warp1) -> float:
    """``|dtheta - ref| / |ref|``, ``ref`` the reference warp's backward
    at ``warp1``'s frames, theta and output gradient."""
    if warp1 is None or not all(bool(torch.isfinite(t).all())
                                for t in warp1.values()):
        return judge.UNREADABLE
    theta = warp1["theta"].clone().requires_grad_(True)
    (want,) = torch.autograd.grad(stn.warp(warp1["x"], theta), theta,
                                  warp1["g"])
    return float((warp1["dtheta"] - want).norm()
                 / want.norm().clamp_min(1e-30))


def judge_stn(prog: dict, ref: dict) -> dict:
    """``judge.judge_train``'s numbers and ``warp_grad_gap``."""
    return dict(judge.judge_train(prog, ref),
                warp_grad_gap=warp_grad_gap(prog.get("warp1")))


def check_stn(model_, conf: dict) -> None:
    """Raise unless the program's STN has the file's widths."""
    s = getattr(model_, "stn", None)
    got = None if s is None else {
        "stn_loc_filters": [c.out_channels for c in s.convs],
        "stn_loc_dense": s.dense.out_features}
    want = {k: conf[k] for k in ("stn_loc_filters", "stn_loc_dense")}
    if got != want:
        raise RuntimeError(f"the program's STN {got} is not the "
                           f"benchmark's {want}")


class Driver(train.Driver):
    """``train.Driver`` on the STN model and its lines."""

    def __init__(self, conf, mix, seed: int, device, hooks=None):
        from crnn_ocr_torch.data.pipeline import produce_batch
        from crnn_ocr_torch.infer.pretrained import model_weights
        from crnn_ocr_torch.infer.weights import params_from_jax
        from crnn_ocr_torch.train.state import create_train_state
        from crnn_ocr_torch.train.step import make_train_step

        self.conf, self.mix, self.seed = conf, mix, seed
        self.device = torch.device(device)
        hooks = hooks or {}
        cfg, params, stats, _ = model_weights(conf["program"]["pretrained"],
                                              conf["dtype"])
        self.cfg = dataclasses.replace(cfg,
                                       dropout_rate=conf["dropout_rate"])
        counts.check_config(self.cfg, conf)
        self.state = create_train_state(
            self.cfg, params_from_jax(params, stats), device=self.device,
            optimizer=mix["optimizer"], learning_rate=mix["learning_rate"],
            clipnorm=mix["clipnorm"])
        check_stn(self.state.model, conf)
        step_fn = make_train_step(self.cfg)
        self.train_step = hooks.get("train_step", lambda f: f)(step_fn)
        self.produce_batch = produce_batch
        self.host = warp_batches(
            mix, seed, model.load_classes(conf, conf["_root"]),
            counts.downsample(conf), conf["ctc_time_slice"])
        self.gen = torch.Generator(device=self.device)
        self.n_steps = 0
        self.losses: List[torch.Tensor] = []
        self.norms: List[torch.Tensor] = []
        self.warp0 = (0, 0)
        self.warp1: dict = {}
        self.readings = self._checked_steps(mix["checked_steps"])
        self.readings["warp1"] = (self.warp1 if len(self.warp1) == 4
                                  else None)

    def step(self, batch: dict) -> int:
        """``train.Driver.step``; the first step also keeps its warp's
        operands and the loss's gradients at the warp's output and at theta
        (the model's STN's ``warp``, wrapped for that step alone)."""
        if self.n_steps:
            return super().step(batch)
        stn_, kept = self.state.model.stn, self.warp1

        def host(name):
            return lambda g: kept.__setitem__(name,
                                              g.detach().float().cpu())

        def warp(x, theta):
            out = type(stn_).warp(x, theta)
            kept.update(x=x.detach().float().cpu(),
                        theta=theta.detach().float().cpu())
            if out.requires_grad:
                out.register_hook(host("g"))
                theta.register_hook(host("dtheta"))
            return out

        stn_.warp = warp
        try:
            return super().step(batch)
        finally:
            del stn_.warp

    @staticmethod
    def _warp_launches():
        from crnn_ocr_torch.kernels import grid_sample

        return grid_sample.launches, grid_sample.bwd_launches

    def install_spans(self, rec) -> None:
        super().install_spans(rec)
        self.warp0 = self._warp_launches()

    def traced_work(self) -> dict:
        lines = len(self.losses) * self.mix["batch"]
        k11, k12 = self._warp_launches()
        per_line = (counts.model_flops(self.conf, self.mix["bucket"])
                    + stn_flops(self.conf))
        return {"lines": lines, "flops": lines * counts.TRAIN_FACTOR
                * per_line, "k11_launches": k11 - self.warp0[0],
                "k12_launches": k12 - self.warp0[1]}

    def check(self, W, classes) -> dict:
        n = self.mix["checked_steps"]
        W = dict(W, **stn.leaves(self.conf, self.conf["_root"], self.device))
        ref = stn.train_steps(
            W, self.host[:n], [train.step_seed(self.seed, k)
                               for k in range(n)],
            self.conf, self.mix, self.device)
        prog = dict(self.readings, lines1=model.line_losses(
            self.readings.pop("logits1"), self.host[0], self.conf,
            self.device))
        return judge_stn(prog, ref)
