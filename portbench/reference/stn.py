"""The plain reference of the STN model (``configs/fonts-warp-stn.json``): a
spatial transformer in front of ``model.py``'s CRNN, in float32 PyTorch.

Like ``model.py`` it imports nothing of the program and takes nothing the
program made: the STN's leaves come from the configuration's Keras ``.h5``
through ``model._h5_layers``, named as the port names its parameters
(``stn.convs.0.weight``, ...) so the judge pairs leaves by name.

The layers (Jaderberg et al., "Spatial Transformer Networks",
arXiv:1506.02025, as gasparian/CRNN-OCR-lite's ``use_stn`` puts one before
its CRNN), on the standardized (B, height, width) frame:

* localize: max-pool 2x2; per localization convolution (``stn_conv0`` 1 ->
  16, ``stn_conv1`` 16 -> 32) a 5x5 convolution zero-padded to its input's
  size, with bias, ReLU, max-pool 2x2; the (B, H/8, W/8, 32) activation
  flattened in (H, W, C) order; Dense ``stn_dense`` (-> 50) + ReLU; Dense
  ``stn_theta`` (-> 6): theta, row-major ``[[a, b, c], [d, e, f]]``;
* warp, at the frame's own size: output pixel (i, j) reads the normalized
  point ``x = a * gx[j] + b * gy[i] + c``, ``y = d * gx[j] + e * gy[i] +
  f``, where ``gx`` and ``gy`` are ``jnp.linspace(-1, 1, n)``'s float32
  points (``linspace`` below), at pixel ``(x + 1) * (W - 1) / 2``, ``(y +
  1) * (H - 1) / 2``; the bilinear sample there takes its weights from the
  unclamped position and its four corners' indices clamped to the border;
* then ``model.forward`` on the warped frame (the plain stem in training:
  the warped frame's gradient flows back to theta and into the
  localization net).

Departures from the published description, all as the bundled model was
trained (the JAX package's ``models/stn.py`` and ``ops/grid_sample.py``):

* the paper's sampling kernel reads zeros outside the image; here corners
  clamp to the border, and -1 and 1 are the outermost pixels' centres
  (torch's ``align_corners=True``);
* the localization net's widths (16, 32, 50) are the JAX package's
  defaults; upstream's README does not fix them;
* the weights are this repository's own (``"provenance": "native"``):
  the STN arm of its A/B on warped lines, not upstream's.

``q`` rounds as ``model.py``'s does: the frame the STN reads, every operand
of a convolution and a dense layer, each layer's output, theta, and the
warped frame, and the gradient back through each of those points.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model

N_CONVS = 2


def leaves(conf: dict, root: str, device) -> Dict[str, torch.Tensor]:
    """The STN's leaves: each convolution's OIHW kernel and bias, each
    Dense's (in, out) kernel and bias."""
    L = model._h5_layers(os.path.join(root, conf["weights"]))
    w: Dict[str, np.ndarray] = {}
    for i in range(N_CONVS):
        k, b = L[f"stn_conv{i}"]
        w[f"stn.convs.{i}.weight"] = k.transpose(3, 2, 0, 1)
        w[f"stn.convs.{i}.bias"] = b
    for name, layer in (("dense", "stn_dense"), ("theta", "stn_theta")):
        w[f"stn.{name}.weight"], w[f"stn.{name}.bias"] = L[layer]
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=device) for k, v in w.items()}


def load_weights(conf: dict, root: str, device) -> Dict[str, torch.Tensor]:
    """``model.load_weights``'s leaves and the STN's."""
    return dict(model.load_weights(conf, root, device),
                **leaves(conf, root, device))


def localize(W, x: torch.Tensor, q: Callable = model.identity,
             keep: Optional[dict] = None) -> torch.Tensor:
    """(B, H, W) frames -> theta (B, 6); ``keep``, where given, gets theta
    before its rounding (``"theta_pre"``)."""
    h = F.max_pool2d(q(x)[:, None], 2)
    for i in range(N_CONVS):
        h = q(F.conv2d(h, q(W[f"stn.convs.{i}.weight"]), padding=2)
              + W[f"stn.convs.{i}.bias"][:, None, None])
        h = F.max_pool2d(torch.relu(h), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # (H, W, C) order
    h = torch.relu(q(h @ q(W["stn.dense.weight"]) + W["stn.dense.bias"]))
    theta = h @ q(W["stn.theta.weight"]) + W["stn.theta.bias"]
    if keep is not None:
        keep["theta_pre"] = theta
    return q(theta)


def linspace(n: int) -> np.ndarray:
    """``jnp.linspace(-1, 1, n, dtype=float32)``'s points as XLA computes
    them: ``step = i * f32(1 / (n - 1))``, then ``-(1 - step) + step`` with
    the product of the last term fused into the sum (one rounding: exact
    in float64 here, then one cast), and the end point 1. An ulp off at an
    integer pixel position moves ``floor``, and with it the coordinate's
    gradient."""
    if n == 1:
        return np.full(1, -1.0, np.float32)
    i = np.arange(n - 1, dtype=np.float32)
    r = np.float32(1.0) / np.float32(n - 1)
    sub = np.float32(1.0) - i * r
    fused = i.astype(np.float64) * np.float64(r) - sub.astype(np.float64)
    return np.append(fused.astype(np.float32), np.float32(1.0))


def warp(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(B, H, W) frames warped by theta (B, 6) at their own size."""
    B, H, Wd = x.shape
    t = theta.float().reshape(B, 6)[:, :, None, None]
    gy = torch.as_tensor(linspace(H), device=x.device)[:, None]
    gx = torch.as_tensor(linspace(Wd), device=x.device)[None, :]
    px = (t[:, 0] * gx + t[:, 1] * gy + t[:, 2] + 1.0) * ((Wd - 1) / 2.0)
    py = (t[:, 3] * gx + t[:, 4] * gy + t[:, 5] + 1.0) * ((H - 1) / 2.0)
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx1, wy1 = px - x0f, py - y0f
    flat = x.float().reshape(B, H * Wd)
    out = torch.zeros_like(px)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        yi = (y0f.long() + dy).clamp(0, H - 1)
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            xi = (x0f.long() + dx).clamp(0, Wd - 1)
            v = torch.gather(flat, 1, (yi * Wd + xi).reshape(B, -1))
            out = out + wy * wx * v.reshape(B, H, Wd)
    return out


def forward(W, x, conf: dict, train: bool = False,
            generator: Optional[torch.Generator] = None,
            q: Callable = model.identity,
            keep: Optional[dict] = None) -> torch.Tensor:
    """(B, height, width) standardized frames -> (B, T, C) f32 logits;
    ``keep``, where given, gets the warp's operands (``"x"``, ``"theta"``),
    theta before its rounding and the warped frame before its rounding."""
    xq = q(x)
    theta = localize(W, xq, q, keep)
    warped = warp(xq, theta)
    if keep is not None:
        keep.update(x=xq, theta=theta, warped=warped)
    return model.forward(W, q(warped), conf, train, generator, q)


def train_steps(W0, batches, seeds, conf, mix, device,
                q: Callable = model.identity, loss_clip: float = 1e4):
    """``model.train_steps`` with this module's ``forward``: the STN's
    leaves are trained with the rest. Same readings, and ``"warp1"``: the
    first step's warp on the host, as the program's STN driver reads its
    own: the frames and theta it read, the loss's gradient at its output
    (``"g"``) and at theta (``"dtheta"``), each where ``q`` rounds it, as
    the program's bfloat16 tensors hold theirs."""
    names = model.trained(W0)
    W = dict(W0)
    P = {k: W0[k].clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v = {k: torch.zeros_like(t) for k, t in P.items()}
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, mix["learning_rate"]
    losses, norms, grad1, lines1, warp1 = [], [], {}, [], None
    for step, (batch, seed) in enumerate(zip(batches, seeds), start=1):
        W.update(P)
        x, in_len = model.batch_frames(batch, conf, device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        keep: dict = {}
        logits = forward(W, x, conf, train=True, generator=gen, q=q,
                         keep=keep)
        lab = torch.as_tensor(batch["the_labels"], device=device)
        lab_len = torch.as_tensor(batch["label_length"], device=device)
        per_line = model.ctc_losses(logits, lab, lab_len, in_len, conf)
        if step == 1:
            lines1 = per_line.detach().tolist()
        loss = torch.clamp(per_line, max=loss_clip).mean()
        at = [keep["theta_pre"], keep["warped"]] if step == 1 else []
        grads = torch.autograd.grad(loss, [P[k] for k in names] + at)
        if step == 1:
            warp1 = {"x": keep["x"], "theta": keep["theta"],
                     "g": grads[-1], "dtheta": grads[-2]}
            warp1 = {k: t.detach().float().cpu() for k, t in warp1.items()}
            grads = grads[:-2]
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
            "grad1": grad1, "change": change, "warp1": warp1}
