"""The plain reference of the CRNN: its weights, preprocessing, forward pass
(eval and training) and training step, in float32 PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the Keras ``.h5`` with its own frozen reader (``h5.py``), rebuilds a
seeded BiLSTM from the configuration's seed, and preprocesses the raw
uint8 crops itself. Each layer follows the configuration file
(``configs/<name>.json``):

* preprocess: each crop on its white canvas, resized to height 32 by
  triangle (linear) weights with half-pixel centres, its width to
  ``min(round(w * 32 / h), bucket)`` and padded white to the bucket, /255,
  standardized per image (population std, +1e-7);
* stem: conv 3x3 (1 -> 64, no bias), BatchNorm, ReLU, max-pool 2x2;
* four blocks: depthwise 3x3, pointwise 1x1 (no biases), BatchNorm, ReLU,
  max-pool, then dropout in training;
* the height axis folded into the features, (B, T, H' * C);
* ``time_dense`` + ReLU, then per layer a BiGRU (Keras ``reset_after``,
  gates z|r|h, input and recurrent biases) or BiLSTM (gates i|f|c|o, one
  bias), the backward direction run over the reversed frames, then a
  BatchNorm over the features;
* the logits layer.

BatchNorm is Keras's: eps 1e-3; in training the batch's moments
``E[x^2] - E[x]^2`` (clamped at 0), in eval the moving ones. Dropout keeps
an element where a uniform draw of the caller's generator is below
``1 - rate`` and scales it by ``1 / (1 - rate)``; the draws are one
``torch.rand`` of each block's output shape, blocks in order.

``q`` rounds every operand of a convolution, a dense layer and a
recurrence step and every activation a layer hands on, where the program
rounds to its compute dtype, and the gradient that flows back through each
of those points; the identity is the float32 reference, ``fp8`` the
control one precision below the configuration's bfloat16 (e4m3 values and
e5m2 gradients, per-tensor scaled), ``bf16`` a witness at the
configuration's own precision.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.h5 import H5File

BN_EPS = 1e-3
NORM_EPS = 1e-7
KERAS_EPS = 1e-7


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to the format's ``top``."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class _Round(torch.autograd.Function):
    """Round a value on the way forward and its gradient on the way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 both ways: the configuration's own precision, a witness of
    what rounding alone does to a number."""
    return _Round.apply(x, _to_bf16, _to_bf16)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 as fp8 training computes: e4m3 values forward, e5m2
    gradients back, each under a per-tensor scale."""
    return _Round.apply(
        x, lambda v: _scaled(v, torch.float8_e4m3fn, 448.0),
        lambda g: _scaled(g, torch.float8_e5m2, 57344.0))


def float32_exact() -> None:
    """TF32 off for matmuls and convolutions: the reference is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- weights ----

def _h5_layers(path: str) -> Dict[str, List[np.ndarray]]:
    f = H5File(path)
    g = "model_weights" if f.has("model_weights") else "/"
    out = {}
    for lname in f.attrs(g)["layer_names"]:
        wnames = f.attrs(f"{g}/{lname}").get("weight_names", [])
        if wnames:
            out[lname] = [np.asarray(f.dataset(f"{g}/{lname}/{w}"),
                                     np.float32) for w in wnames]
    return out


def seeded_lstm(conf: dict) -> Dict[str, np.ndarray]:
    """The configuration's seeded BiLSTM layers: per layer a kernel (2, F,
    4H) glorot-uniform with fans (2F, 2 * 4H), a recurrent kernel (2, H, 4H)
    uniform on [-1, 1) over sqrt(H), drawn in that order from
    ``np.random.default_rng(seed)``, and the bias (2, 4H), 1 on the forget
    gate's [H, 2H) and 0 elsewhere."""
    rng = np.random.default_rng(conf["seeded_rnn"]["seed"])
    H, feat = conf["n_units"], conf["time_dense_size"]
    out = {}
    for i in range(conf["rnn_layers"]):
        limit = np.sqrt(6.0 / (2 * feat + 2 * 4 * H))
        out[f"birnn{i}.kernel"] = rng.uniform(-limit, limit, (2, feat, 4 * H))
        out[f"birnn{i}.recurrent_kernel"] = (
            rng.uniform(-1.0, 1.0, (2, H, 4 * H)) / np.sqrt(H))
        bias = np.zeros((2, 4 * H))
        bias[:, H:2 * H] = 1.0
        out[f"birnn{i}.bias"] = bias
        feat = 2 * H
    return {k: v.astype(np.float32) for k, v in out.items()}


def load_weights(conf: dict, root: str, device) -> Dict[str, torch.Tensor]:
    """The trained leaves and the BatchNorms' moving moments of ``conf``,
    named as the port names its parameters (so the judge pairs leaves by
    name), in this module's layouts."""
    L = _h5_layers(os.path.join(root, conf["weights"]))
    w: Dict[str, np.ndarray] = {}

    def bn(key, layer):
        g, b, m, v = L[layer]
        w.update({f"{key}.weight": g, f"{key}.bias": b,
                  f"{key}.running_mean": m, f"{key}.running_var": v})

    w["stem_conv.weight"] = L["stem_conv"][0].transpose(3, 2, 0, 1)  # OIHW
    bn("stem_bn", "stem_bn")
    for i in range(len(conf["block_filters"])):
        w[f"block{i}.depthwise.weight"] = (
            L[f"block{i}_depthwise"][0][..., 0].transpose(2, 0, 1)[:, None])
        w[f"block{i}.pointwise.weight"] = (
            L[f"block{i}_pointwise"][0].transpose(3, 2, 0, 1))
        bn(f"block{i}.bn", f"block{i}_bn")
    w["time_dense.weight"], w["time_dense.bias"] = L["time_dense"]
    for i in range(conf["rnn_layers"]):
        fk, fr, fb, bk, br, bb = L[f"birnn{i}"]
        w[f"birnn{i}.kernel"] = np.stack([fk, bk])
        w[f"birnn{i}.recurrent_kernel"] = np.stack([fr, br])
        w[f"birnn{i}.bias"] = np.stack([fb, bb])
        bn(f"rnn_bn{i}", f"rnn_bn{i}")
    w["logits.weight"], w["logits.bias"] = L["logits"]
    if conf["rnn_cell"] == "lstm":
        w.update(seeded_lstm(conf))
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=device) for k, v in w.items()}


def trained(weights: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in weights if not k.endswith(("running_mean",
                                                  "running_var"))]


# ---- preprocessing ----

def _tri(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) triangle-kernel sampling weights, each row normalized,
    rows whose sample falls outside the input zero."""
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) / np.float32(scale) \
        - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None]
                                    - np.arange(n_in, dtype=np.float32)))
    total = w.sum(1, keepdims=True)
    w = np.where(total > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0).astype(np.float32)


def content_width(h: int, w: int, height: int, bucket: int) -> int:
    return int(min(np.round(np.float32(w) * height / np.float32(h)), bucket))


def preprocess(crop: np.ndarray, canvas_hw, height: int, bucket: int,
               device) -> torch.Tensor:
    """One crop on a white canvas of ``canvas_hw`` -> (height, bucket) f32."""
    hc, wc = canvas_hw
    h, w = crop.shape
    canvas = np.full((hc, wc), 255.0, np.float32)
    canvas[:h, :w] = crop
    wn = content_width(h, w, height, bucket)
    wy = _tri(hc, height, height / h)
    wx = _tri(wc, bucket, wn / w)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    frame = t(wy) @ t(canvas) @ t(wx).T
    frame[:, wn:] = 255.0
    x = frame / 255.0
    return (x - x.mean()) / (x.std(correction=0) + NORM_EPS)


def frames(h: int, w: int, conf: dict, bucket: int) -> int:
    """The frames a line covers after the downsample and the time slice."""
    ds = 2
    for _, pw in conf["block_pools"]:
        ds *= pw
    wn = content_width(h, w, conf["height"], bucket)
    return max(1, min(wn // ds, bucket // ds) - conf["ctc_time_slice"])


# ---- forward ----

def _bn(x, W, key, dim, train):
    shape = [1] * x.dim()
    shape[dim] = -1
    if train:
        axes = [a for a in range(x.dim()) if a != dim % x.dim()]
        mean = x.mean(dim=axes)
        var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
    else:
        mean, var = W[f"{key}.running_mean"], W[f"{key}.running_var"]
    mul = torch.rsqrt(var + BN_EPS) * W[f"{key}.weight"]
    return (x - mean.view(shape)) * mul.view(shape) + \
        W[f"{key}.bias"].view(shape)


def _birnn(x, W, i, cell, q):
    """(B, T, F) -> (B, T, 2H)."""
    K, U, bias = (W[f"birnn{i}.kernel"], W[f"birnn{i}.recurrent_kernel"],
                  W[f"birnn{i}.bias"])
    H = U.shape[1]
    xd = torch.stack([x, x.flip(1)])  # (2, B, T, F)
    b_in = bias[:, 0] if cell == "gru" else bias
    xw = q(torch.einsum("dbtf,dfg->dbtg", q(xd), q(K))
           + b_in[:, None, None, :])
    Uq = q(U)
    B, T = x.shape[0], x.shape[1]
    h = x.new_zeros((2, B, H))
    c = x.new_zeros((2, B, H))
    outs = []
    for t in range(T):
        rec = torch.einsum("dbh,dhg->dbg", q(h), Uq)
        g = xw[:, :, t]
        if cell == "gru":
            rec = rec + bias[:, 1][:, None, :]
            z = torch.sigmoid(g[..., :H] + rec[..., :H])
            r = torch.sigmoid(g[..., H:2 * H] + rec[..., H:2 * H])
            hh = torch.tanh(g[..., 2 * H:] + r * rec[..., 2 * H:])
            h = z * h + (1.0 - z) * hh
        else:
            a = g + rec
            c = (torch.sigmoid(a[..., H:2 * H]) * c
                 + torch.sigmoid(a[..., :H]) * torch.tanh(a[..., 2 * H:3 * H]))
            h = torch.sigmoid(a[..., 3 * H:]) * torch.tanh(c)
        outs.append(h)
    hs = torch.stack(outs, dim=2)  # (2, B, T, H)
    return torch.cat([hs[0], hs[1].flip(1)], dim=-1)


def forward(W, x, conf: dict, train: bool = False,
            generator: Optional[torch.Generator] = None,
            q: Callable = identity) -> torch.Tensor:
    """(B, height, W) standardized frames -> (B, T, C) f32 logits. ``q``
    rounds each operand of a product and each activation a layer hands on
    (the stem's pooled output, each convolution's and BatchNorm's output,
    the dense layers' and the recurrences' outputs)."""
    z = F.conv2d(q(x)[:, None], q(W["stem_conv.weight"]), padding=1)
    y = q(F.max_pool2d(torch.relu(_bn(z, W, "stem_bn", 1, train)), 2))
    rate = conf["dropout_rate"]
    for i, pool in enumerate(conf["block_pools"]):
        y = q(F.conv2d(y, q(W[f"block{i}.depthwise.weight"]), padding=1,
                       groups=y.shape[1]))
        y = q(F.conv2d(y, q(W[f"block{i}.pointwise.weight"])))
        y = torch.relu(q(_bn(y, W, f"block{i}.bn", 1, train)))
        if tuple(pool) != (1, 1):
            y = F.max_pool2d(y, tuple(pool))
        if train and rate > 0:
            keep = torch.rand(y.shape, generator=generator,
                              device=y.device) < 1.0 - rate
            y = q(torch.where(keep, y / (1.0 - rate), torch.zeros_like(y)))
    B, C, Hp, T = y.shape
    f = y.permute(0, 3, 2, 1).reshape(B, T, Hp * C)
    f = q(torch.relu(f @ q(W["time_dense.weight"]) + W["time_dense.bias"]))
    for i in range(conf["rnn_layers"]):
        f = q(_birnn(f, W, i, conf["rnn_cell"], q))
        f = q(_bn(f, W, f"rnn_bn{i}", -1, train))
    return f @ q(W["logits.weight"]) + W["logits.bias"]


# ---- the training step ----

def ctc_losses(logits, labels, label_len, input_len, conf):
    """(B,) CTC negative log-likelihoods after the time slice; blank last."""
    lp = torch.log_softmax(logits[:, conf["ctc_time_slice"]:], dim=-1)
    return F.ctc_loss(lp.transpose(0, 1), labels.long(), input_len.long(),
                      label_len.long(), blank=lp.shape[-1] - 1,
                      reduction="none", zero_infinity=False)


def train_steps(W0, batches, seeds, conf, mix, device,
                q: Callable = identity, loss_clip: float = 1e4):
    """The configuration's first ``len(batches)`` fine-tuning steps from
    ``W0``: per step the batch's frames (this module's preprocessing), the
    training forward with the dropout generator seeded ``seeds[k]``, the
    clipped CTC losses' mean, its gradients, the global-norm clip at
    ``mix["clipnorm"]`` (scale by ``clip / norm`` when ``norm >= clip``) and
    Adam (betas 0.9 / 0.999, eps 1e-8 added to the bias-corrected root).

    Returns ``{"losses": [...], "norms": [global gradient norms before the
    clip], "lines1": [the first step's CTC loss of each line], "grad1":
    {leaf: norm of the first clipped gradient}, "change": {leaf: norm of
    the change after the steps}}``."""
    names = trained(W0)
    W = dict(W0)
    P = {k: W0[k].clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v = {k: torch.zeros_like(t) for k, t in P.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, mix["learning_rate"]
    losses, norms, grad1, lines1 = [], [], {}, []
    for step, (batch, seed) in enumerate(zip(batches, seeds), start=1):
        W.update(P)
        x, in_len = batch_frames(batch, conf, device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        logits = forward(W, x, conf, train=True, generator=gen, q=q)
        lab = torch.as_tensor(batch["the_labels"], device=device)
        lab_len = torch.as_tensor(batch["label_length"], device=device)
        per_line = ctc_losses(logits, lab, lab_len, in_len, conf)
        if step == 1:
            lines1 = per_line.detach().tolist()
        loss = torch.clamp(per_line, max=loss_clip).mean()
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if float(norm) >= mix["clipnorm"]:
            grads = [g / norm * mix["clipnorm"] for g in grads]
        losses.append(float(loss.detach()))
        norms.append(float(norm))
        with torch.no_grad():
            for k, g in zip(names, grads):
                if step == 1:
                    grad1[k] = float(g.norm())
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                denom = (v[k] / (1 - b2 ** step)).sqrt() + eps
                P[k] -= lr * (m[k] / (1 - b1 ** step)) / denom
    change = {k: float((P[k].detach() - W0[k]).norm()) for k in names}
    return {"losses": losses, "norms": norms, "lines1": lines1,
            "grad1": grad1, "change": change}


def line_losses(logits, batch, conf, device):
    """Each line's CTC loss of a raw host ``batch`` under ``logits``
    (B, T, C) that another side computed for it, with this module's labels
    and frame counts; None where ``logits`` has another number of lines."""
    B = int(batch["the_labels"].shape[0])
    if logits is None or int(logits.shape[0]) != B:
        return None
    bucket = int(batch["bucket"])
    in_len = torch.as_tensor([frames(int(h), int(w), conf, bucket) for h, w
                              in zip(batch["heights"], batch["widths"])],
                             device=device)
    lab = torch.as_tensor(batch["the_labels"], device=device)
    lab_len = torch.as_tensor(batch["label_length"], device=device)
    return ctc_losses(logits.to(device=device, dtype=torch.float32), lab,
                      lab_len, in_len, conf).tolist()


def batch_frames(batch, conf, device):
    """A raw host batch -> (frames (B, height, bucket), frame counts (B,))."""
    bucket = int(batch["bucket"])
    canvas = batch["the_input"]
    hc, wc = canvas.shape[1], canvas.shape[2]
    xs, lens = [], []
    for b in range(canvas.shape[0]):
        h, w = int(batch["heights"][b]), int(batch["widths"][b])
        xs.append(preprocess(canvas[b, :h, :w], (hc, wc), conf["height"],
                             bucket, device))
        lens.append(frames(h, w, conf, bucket))
    return torch.stack(xs), torch.as_tensor(lens, device=device)


def load_classes(conf: dict, root: str) -> Dict[str, int]:
    with open(os.path.join(root, conf["classes"])) as f:
        return json.load(f)
