#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero. It needs one CUDA card and refuses to run without one.

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   then the nvcc build of every kernel (``crnn_ocr_torch/kernels/csrc``),
   timed, with ptxas's register and spill report.
2. Each kernel against its plain PyTorch version on the card, at the
   main-path shapes and on the main path's own tensors (``fonts-hard``,
   256 lines, bucket 256), with TF32 off: max error against the stated
   tolerance, and the median times of the kernel, the plain version and a
   PyTorch yardstick the port never calls, beside the kernel's bound.
3. Golden texts: ``load_pretrained`` on the card against the JAX
   predictor's texts and scores in ``crnn_ocr_torch/testdata/
   greedy_goldens.npz`` (written by ``tools/gen_torch_goldens.py``).
4. The main path, counted: ``fonts-hard`` serving at full width, B = 256,
   bucket 256, bf16, from uint8 images to texts through
   ``Predictor.predict``. The kernels' launch counts are set to 0 just
   before its timed calls and read just after: each call must launch K1
   once and K2 twice (one per BiGRU layer). Throughput, then a per-stage
   breakdown through the Predictor's own steps and a profiler trace.
5. Per kernel: its launches in phase 4's timed calls, error, times and
   bound.

Slice 2, training ``fonts-hard`` (bf16, B = 128, bucket 256: the 64 golden
lines repeated, labels padded to 32):

6. K3 (BiGRU forward with the gate stash), K6 and K7 (CTC alpha and beta)
   against their plain versions on the training path's own activations and
   log-probs, in bf16 and f32, TF32 off, with K2 timed on K3's inputs (the
   stash's cost) and ``nn.GRU`` / ``F.ctc_loss`` as yardsticks.
7. One f32 train step (dropout 0) through the kernels against the same
   step through the plain versions on the card (loss, grad_norm, every
   parameter's gradient and every updated parameter), and against the JAX package's step
   (``crnn_ocr_torch/testdata/train_goldens.npz``).
8. The training path, counted: 30 timed steps of ``produce_batch`` plus
   ``fit``'s train step (dropout 0.2, learning rate 1e-4) with the launch
   counts set to 0 just before and read just after: each step must launch
   K3 twice, K6 and K7 once, K1 and K2 never; the mean loss of the last 5
   steps must be below the first step's. Then lines/s over the timed
   steps' whole time, the p50 step, a
   per-stage breakdown, a profiler trace, and ``fit`` with an evaluation.

The last lines are the card's ``name, power.limit``, the kernels' JSON
line (K1 and K2 with phase 4's launches, K3, K6 and K7 with phase 8's) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 MMA, f32 FMA
BATCH, BUCKET = 256, 256


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median of ``reps`` single-call CUDA-event timings, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def plain_kernels():
    """Run every kernel call site (K1, K2, K3, K6, K7) through its plain
    version, on the card, for the comparison runs of phases 3 and 7: the
    autograd Functions, the BiGRU backward and the CTC gradient assembly
    stay as they are."""
    import torch
    import crnn_ocr_torch.models.crnn as crnn_mod
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem

    def gru_train(xw, u, rec_bias, u_kernel=None):
        with torch.no_grad():
            return bigru.bigru_train_plain(xw, u, rec_bias)

    sites = [(crnn_mod, "fused_stem_serve", fused_stem.fused_stem_plain),
             (bigru, "bigru_infer",
              lambda xw, u, rb, u_kernel=None: bigru.bigru_plain(xw, u, rb)),
             (bigru, "bigru_train", gru_train),
             (ctc_loss, "ctc_alphas", ctc_loss.ctc_alphas_plain),
             (ctc_loss, "ctc_betas", ctc_loss.ctc_betas_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, fn in sites:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def reset_launches() -> None:
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem

    fused_stem.launches = bigru.launches = bigru.train_launches = 0
    ctc_loss.alpha_launches = ctc_loss.beta_launches = 0


def read_launches() -> dict:
    from crnn_ocr_torch.kernels import bigru, ctc_loss, fused_stem

    return {"fused_stem": fused_stem.launches, "bigru": bigru.launches,
            "bigru_train": bigru.train_launches,
            "ctc_alpha": ctc_loss.alpha_launches,
            "ctc_beta": ctc_loss.beta_launches}


def golden_lines(g, key: str):
    c, hs, ws = g[f"{key}_canvas"], g[f"{key}_heights"], g[f"{key}_widths"]
    return [c[i, :h, :w] for i, (h, w) in enumerate(zip(hs, ws))]


def phase_build(card: str):
    import torch
    from crnn_ocr_torch.kernels import _build

    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         python=sys.version.split()[0])
    t0 = time.perf_counter()
    built = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in rep.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, rep in _build.ptxas_reports.items()
    }
    emit("build", seconds=round(secs, 3), built=built, ptxas=ptxas)


def check_stem(model, x_img, dtype_name: str):
    """K1 on the main path's stem input and the model's stem weights."""
    import torch
    from crnn_ocr_torch.kernels import fused_stem as fs

    bf16 = dtype_name == "bfloat16"
    dt = torch.bfloat16 if bf16 else torch.float32
    img = x_img.to(dt)[..., None].contiguous()
    bn = model.stem_bn
    scale, bias = fs.fold_bn(bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, 1e-3)
    w = model.stem_conv.weight.permute(2, 3, 1, 0).contiguous()
    got = fs.fused_stem_serve(img, w, scale, bias)
    want = fs.fused_stem_plain(img, w, scale, bias)
    torch.cuda.synchronize()
    g, p = got.float(), want.float()
    err = (g - p).abs()
    if bf16:
        # one bf16 ulp of the output (ulp(x) <= |x| * 2^-7), plus 1e-6 for
        # values that the f32 sums' order puts on either side of the ReLU
        tol = p.abs() * 2.0 ** -7 + 1e-6
        tol_text = "1 bf16 ulp of the output (+1e-6)"
    else:
        tol = torch.full_like(p, 1e-5)
        tol_text = "1e-5 abs"
    ok = bool((err <= tol).all())
    B, H, W, _ = img.shape
    C = w.shape[-1]
    bytes_moved = nbytes(img, got) + 11 * C * 4
    ops = 2 * 9 * B * H * W * C + 3 * B * H * W * C
    b_ms, b_by = bound_ms(bytes_moved, ops, dtype_name)
    x_nchw = img.permute(0, 3, 1, 2)
    w_nchw = w.permute(3, 2, 0, 1).to(dt)
    s4, b4 = scale.to(dt)[:, None, None], bias.to(dt)[:, None, None]

    def library():
        z = torch.nn.functional.conv2d(x_nchw, w_nchw, padding=1)
        return torch.nn.functional.max_pool2d(torch.relu(z * s4 + b4), 2)

    res = dict(
        kernel="fused_stem", dtype=dtype_name, shape=list(img.shape), C=C,
        max_abs_err=float(err.max()), tolerance=tol_text, ok=ok,
        kernel_ms=time_ms(lambda: fs.fused_stem_serve(img, w, scale, bias)),
        plain_ms=time_ms(lambda: fs.fused_stem_plain(img, w, scale, bias)),
        library_ms=time_ms(library),
        library="cudnn conv2d + affine + relu + max_pool2d",
        bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, ops=ops,
    )
    emit("kernel_check", **res)
    require(ok, f"fused_stem {dtype_name}: max error {res['max_abs_err']} "
                f"beyond {tol_text}")
    return res


def torch_gru_from(rnn, dtype):
    """torch.nn.GRU (bidirectional, batch_first) with a BiRNN's weights,
    gates reordered from Keras z|r|h to PyTorch r|z|n."""
    import torch

    H = rnn.units
    F = rnn.kernel.shape[1]
    order = torch.cat([torch.arange(H, 2 * H), torch.arange(0, H),
                       torch.arange(2 * H, 3 * H)]).to(rnn.kernel.device)
    # made on the card in its dtype, so cuDNN lays the weights out in one
    # block once; copy_ writes into that block
    gru = torch.nn.GRU(F, H, batch_first=True, bidirectional=True,
                       device=rnn.kernel.device, dtype=dtype)
    with torch.no_grad():
        for d, sfx in ((0, "l0"), (1, "l0_reverse")):
            getattr(gru, f"weight_ih_{sfx}").copy_(rnn.kernel[d].T[order])
            getattr(gru, f"weight_hh_{sfx}").copy_(
                rnn.recurrent_kernel[d].T[order])
            getattr(gru, f"bias_ih_{sfx}").copy_(rnn.bias[d, 0][order])
            getattr(gru, f"bias_hh_{sfx}").copy_(rnn.bias[d, 1][order])
    return gru.eval()


def check_bigru(model, feat, dtype_name: str):
    """K2 on layer 0's input projections of the main path (fonts-hard)."""
    import torch
    from crnn_ocr_torch.kernels import bigru as bg

    rnn = model.birnn0
    dt = rnn.dtype
    xw = rnn.project(feat)
    u = rnn.recurrent_kernel.to(dt).contiguous()
    rb = rnn.bias[:, 1].contiguous()
    uk = rnn.u_kernel  # as the main path passes it

    def kernel():
        return bg.bigru(xw, u, rb, uk)

    got = kernel()
    want = bg.bigru_plain(xw, u, rb)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = 2e-2 if dtype_name == "bfloat16" else 1e-4
    T, _, B, G = xw.shape
    H = G // 3
    bytes_moved = nbytes(xw, u, rb, got)
    ops = 2 * T * 2 * B * H * G + 12 * T * 2 * B * H
    b_ms, b_by = bound_ms(bytes_moved, ops, dtype_name)
    res = dict(
        kernel="bigru", dtype=dtype_name, T=T, B=B, H=H, max_abs_err=err,
        tolerance=f"{tol} abs", ok=err <= tol,
        kernel_ms=time_ms(kernel),
        plain_ms=time_ms(lambda: bg.bigru_plain(xw, u, rb)),
        bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, ops=ops,
        library="torch.nn.GRU bidirectional (cuDNN) on the layer input; "
                "its time includes the input projection",
    )
    # yardstick only: the port never calls torch.nn.GRU
    gru = torch_gru_from(rnn, dt)
    res["library_vs_port_max_abs"] = float(
        (gru(feat)[0].float() - rnn(feat).float()).abs().max())
    res["library_ms"] = time_ms(lambda: gru(feat))
    emit("kernel_check", **res)
    require(res["ok"], f"bigru {dtype_name}: max error {err} beyond {tol}")
    return res


def predict_golden(name, g, key, dtype=None):
    from crnn_ocr_torch import load_pretrained

    pred = load_pretrained(name, device="cuda", dtype=dtype)
    out = pred.predict(golden_lines(g, key))
    return [o.text for o in out], [o.score for o in out]


def phase_goldens(g):
    import numpy as np

    results = {}
    # f32: every text equal, scores within rtol 1e-4 (atol 1e-5: a score is
    # a sum of ~60 log-probs, and near-certain lines score near 0)
    for name, key in (("fonts-hard", "hard"), ("fonts-small", "small")):
        texts, scores = predict_golden(name, g, key, "float32")
        want_t = [str(t) for t in g[f"{key}_texts_f32"]]
        want_s = g[f"{key}_scores_f32"]
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(texts, want_t))
               if a != b]
        rel = np.abs(np.array(scores) - want_s) / (np.abs(want_s) + 1e-30)
        score_ok = bool(np.allclose(scores, want_s, rtol=1e-4, atol=1e-5))
        results[f"{name}_f32"] = dict(lines=len(texts), text_mismatches=bad,
                                      max_score_rel_err=float(rel.max()),
                                      scores_ok=score_ok)
        emit("goldens", run=f"{name} float32", lines=len(texts),
             text_mismatches=bad, max_score_rel_err=float(rel.max()),
             scores_ok=score_ok)
        require(not bad and score_ok,
                f"{name} f32 differs from the JAX golden")
    # bf16 as shipped: at most 1 of 64 lines off the JAX bf16 golden, and
    # the kernel run's texts equal the plain-version run's on the card
    texts, scores = predict_golden("fonts-hard", g, "hard")
    want_t = [str(t) for t in g["hard_texts_bf16"]]
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(texts, want_t)) if a != b]
    with plain_kernels():
        plain_texts, _ = predict_golden("fonts-hard", g, "hard")
    plain_bad = [(i, a, b) for i, (a, b) in enumerate(zip(texts, plain_texts))
                 if a != b]
    truth = [str(t) for t in g["hard_truth"]]
    emit("goldens", run="fonts-hard bfloat16", lines=len(texts),
         text_mismatches=bad, kernel_vs_plain_mismatches=plain_bad,
         line_accuracy_vs_truth=float(np.mean(
             [a == b for a, b in zip(texts, truth)])))
    require(len(bad) <= 1, f"fonts-hard bf16: {len(bad)} lines differ from "
                           "the JAX bf16 golden (at most 1 may)")
    require(not plain_bad, "fonts-hard bf16: kernel texts differ from the "
                           "plain version's on the card")
    return results


def phase_throughput(g, card: str):
    """The main path, counted: ``REPS`` timed ``predict`` calls with the
    launch counts set to 0 just before them and read just after."""
    import torch
    from crnn_ocr_torch import load_pretrained

    reps = 20
    pred = load_pretrained("fonts-hard", device="cuda")
    lines = golden_lines(g, "hard")
    lines = (lines * (BATCH // len(lines) + 1))[:BATCH]
    for _ in range(3):
        pred.predict(lines, bucket=BUCKET)
    torch.cuda.synchronize()
    batch_ms = []
    reset_launches()
    for _ in range(reps):
        t0 = time.perf_counter()
        out = pred.predict(lines, bucket=BUCKET)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches()
    emit("launches", predict_calls=reps, **counts)
    require(counts["fused_stem"] == reps,
            f"fused_stem launched {counts['fused_stem']} times in {reps} "
            "predict calls (1 per call expected)")
    require(counts["bigru"] == 2 * reps,
            f"bigru launched {counts['bigru']} times in {reps} predict "
            "calls (2 per call expected, one per BiGRU layer)")
    require(counts["bigru_train"] == counts["ctc_alpha"]
            == counts["ctc_beta"] == 0,
            f"serving launched a training kernel: {counts}")
    require(len(out) == BATCH and all(isinstance(o.text, str) for o in out),
            "throughput run returned malformed predictions")

    # per-stage breakdown through the Predictor's own steps, synchronized
    # after each stage
    m = pred.model
    stages = {k: [] for k in ("preprocess", "stem", "backbone", "rnn_head",
                              "decode")}

    def clock(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages[key].append((t1 - t0) * 1e3)
        return t1

    with torch.inference_mode():
        for _ in range(13):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, w_new = pred.preprocess(lines, BUCKET)
            t = clock("preprocess", t)
            s = m.stem(x)
            t = clock("stem", t)
            f = m.backbone(s)
            t = clock("backbone", t)
            logits = m.head(f)
            t = clock("rnn_head", t)
            pred.decode(*pred.probs(logits, w_new))
            clock("decode", t)
    stage_ms = {k: statistics.median(v[3:]) for k, v in stages.items()}
    p50 = statistics.median(batch_ms)
    res = dict(model="fonts-hard", dtype="bfloat16", batch=BATCH,
               bucket=BUCKET, lines_per_s=BATCH / (p50 / 1e3),
               p50_batch_ms=p50, min_batch_ms=min(batch_ms),
               max_batch_ms=max(batch_ms), stage_ms=stage_ms,
               card=card)
    emit("throughput", **res)
    emit("trace", **trace_predict(pred, lines))
    return counts


def trace_predict(pred, lines, n: int = 5) -> dict:
    """torch.profiler over ``n`` predict calls: the device's busy share of
    the wall time, and the ops that take the most device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            pred.predict(lines, bucket=BUCKET)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _trace_summary(prof, wall_us, n)


# ---- slice 2: training fonts-hard, B = 128, bucket 256 ----

TRAIN_BATCH, TRAIN_MAX_LABEL = 128, 32
TRAIN_LR = 1e-4  # fine-tuning rate for the counted run: a tenth of the
# training default, for a model that already reads these lines
TRAIN_STEPS, TRAIN_WARMUP = 30, 3


def train_setup(g, dtype: str, dropout: float):
    """A fonts-hard train state on the card (the shipped weights, ``dtype``
    and ``dropout``), its raw host batch (the 64 golden lines repeated to
    128, labels padded to 32) and the device batch produced from it."""
    import dataclasses

    import numpy as np
    from crnn_ocr_torch.config import load_model_config
    from crnn_ocr_torch.data.codec import LabelCodec
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.infer.weights import (JAX_PRETRAINED, NPZ_DIR,
                                              load_npz, params_from_jax)
    from crnn_ocr_torch.train.state import create_train_state

    src = os.path.join(JAX_PRETRAINED, "fonts_hard")
    cfg = dataclasses.replace(
        load_model_config(os.path.join(src, "model_config.json")),
        dtype=dtype, dropout_rate=dropout)
    codec = LabelCodec.load(os.path.join(src, "classes.json"))
    reps = TRAIN_BATCH // len(g["hard_heights"])
    truth = [str(t) for t in g["hard_truth"]] * reps
    labels, lab_len = codec.encode_batch(truth, TRAIN_MAX_LABEL)
    host = {"the_input": np.concatenate([g["hard_canvas"]] * reps),
            "heights": np.concatenate([g["hard_heights"]] * reps),
            "widths": np.concatenate([g["hard_widths"]] * reps),
            "the_labels": labels, "label_length": lab_len,
            "bucket": BUCKET, "texts": truth}
    sd = params_from_jax(*load_npz(os.path.join(NPZ_DIR, "fonts_hard.npz")))
    state = create_train_state(cfg, sd, device="cuda",
                               learning_rate=TRAIN_LR)
    return cfg, codec, state, host, produce_batch(dict(host), "cuda", cfg)


def _close(got, want, atol, rtol):
    """max |got - want| and whether every element is within
    ``atol + rtol * |want|``."""
    err = (got.float() - want.float()).abs()
    return float(err.max()), bool((err <= atol + rtol * want.float().abs())
                                  .all())


def check_bigru_train(state, batch, dtype_name: str):
    """K3 on layer 0's input projections of the training path, against
    its plain version; K2 on the same inputs, to price the stash."""
    import torch
    from crnn_ocr_torch.kernels import bigru as bg

    m = state.model
    rnn = m.birnn0
    with torch.no_grad():
        feat = m.frame_features(m.backbone(m.stem(batch["x"])))
        xw = rnn.project(feat)
    u = rnn.recurrent_kernel.detach().to(rnn.dtype).contiguous()
    rb = rnn.bias.detach()[:, 1].contiguous()
    uk = rnn.kernel_operand()
    hs, gates = bg.bigru_train(xw, u, rb, uk)
    with torch.no_grad():
        p_hs, p_gates = bg.bigru_train_plain(xw, u, rb)
    torch.cuda.synchronize()
    bf16 = dtype_name == "bfloat16"
    # bf16: hs as K2 (2e-2, outputs in (-1, 1)); the gates carry the same
    # state error through sums of 256 products, and rh is unbounded, so
    # 3e-2 plus 2 % of the value. f32: 1e-4, as K2.
    hs_err, hs_ok = _close(hs, p_hs, 2e-2 if bf16 else 1e-4, 0.0)
    g_err, g_ok = _close(gates, p_gates, 3e-2 if bf16 else 1e-4,
                         2e-2 if bf16 else 0.0)
    T, _, B, G = xw.shape
    H = G // 3
    bytes_moved = nbytes(xw, u, rb, hs, gates)
    ops = 2 * T * 2 * B * H * G + 14 * T * 2 * B * H
    b_ms, b_by = bound_ms(bytes_moved, ops, dtype_name)
    # yardstick only: the port never calls torch.nn.GRU
    gru = torch_gru_from(rnn, rnn.dtype).train()
    feat_g = feat.detach().to(rnn.dtype).requires_grad_(True)
    res = dict(
        kernel="bigru_train", dtype=dtype_name, T=T, B=B, H=H,
        max_abs_err=max(hs_err, g_err), hs_max_abs_err=hs_err,
        gates_max_abs_err=g_err, ok=hs_ok and g_ok,
        tolerance=("hs 2e-2 abs; gates 3e-2 + 2e-2 * |plain|" if bf16
                   else "hs and gates 1e-4 abs"),
        kernel_ms=time_ms(lambda: bg.bigru_train(xw, u, rb, uk)),
        k2_same_inputs_ms=time_ms(lambda: bg.bigru_infer(xw, u, rb, uk)),
        plain_ms=time_ms(lambda: bg.bigru_train_plain(xw, u, rb), reps=5),
        library_ms=time_ms(lambda: gru(feat_g)),
        library="torch.nn.GRU bidirectional (cuDNN), training-mode forward "
                "on the layer input; includes the input projection",
        bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, ops=ops,
    )
    emit("kernel_check", **res)
    require(res["ok"], f"bigru_train {dtype_name}: hs error {hs_err}, "
                       f"gates error {g_err} beyond {res['tolerance']}")
    return res


def check_ctc(state, batch, cfg, dtype_name: str):
    """K6 and K7 on the training path's log-probs and labels, against
    their plain versions; F.ctc_loss's forward and backward as yardsticks."""
    import torch
    import torch.nn.functional as F
    from crnn_ocr_torch.kernels import ctc_loss as cl

    with torch.no_grad():
        logits = state.model(batch["x"])
    lp = torch.log_softmax(logits[:, cfg.ctc_time_slice:], dim=-1)
    emits, flags, lens, _, lab_len = cl.prepare(
        lp, batch["the_labels"], batch["input_length"],
        batch["label_length"])
    out = []
    for name, fn, plain in (("ctc_alpha", cl.ctc_alphas, cl.ctc_alphas_plain),
                            ("ctc_beta", cl.ctc_betas, cl.ctc_betas_plain)):
        got = fn(emits, flags, lens)
        want = plain(emits, flags, lens)
        torch.cuda.synchronize()
        live = want > cl.NEG / 2
        # f32 log-sum-exps in another order (CUDA's expf/logf against
        # PyTorch's), over up to 62 dependent frames: 1e-4 + 1e-5 * |value|
        # where a path exists; exactly NEG where none does
        err, ok = _close(got[live], want[live], 1e-4, 1e-5)
        ok = ok and bool((got[~live] == want[~live]).all())
        B, T, S = emits.shape
        bytes_moved = nbytes(emits, flags, lens, got)
        ops = 20 * B * T * S  # 3 exp, 1 log, ~16 adds, maxes and selects
        b_ms, b_by = bound_ms(bytes_moved, ops, "float32")
        res = dict(kernel=name, dtype=dtype_name, B=B, T=T, S=S,
                   max_abs_err=err, ok=ok,
                   tolerance="1e-4 + 1e-5 * |plain| where finite; NEG "
                             "where plain is NEG",
                   kernel_ms=time_ms(lambda: fn(emits, flags, lens)),
                   plain_ms=time_ms(lambda: plain(emits, flags, lens),
                                    reps=5),
                   bound_ms=b_ms, bound_by=b_by, bytes=bytes_moved, ops=ops,
                   dependent_frames=T - 1)
        out.append(res)
    # yardstick only: the port never calls F.ctc_loss
    lp_t = lp.detach().transpose(0, 1).contiguous().requires_grad_(True)
    args = (batch["the_labels"].long(), batch["input_length"].long(),
            batch["label_length"].long())

    def lib_fwd():
        return F.ctc_loss(lp_t, *args, blank=lp.shape[-1] - 1,
                          reduction="none", zero_infinity=False)

    loss = lib_fwd()
    out[0]["library_ms"] = time_ms(lib_fwd)
    out[0]["library"] = "F.ctc_loss forward (reduction='none')"
    ones = torch.ones_like(loss)
    out[1]["library_ms"] = time_ms(lambda: torch.autograd.grad(
        loss, lp_t, ones, retain_graph=True))
    out[1]["library"] = "F.ctc_loss backward alone (autograd.grad)"
    with torch.no_grad():
        ours = cl.loss_from_alphas(cl.ctc_alphas(emits, flags, lens), lab_len)
    out[0]["library_vs_port_loss_max_rel"] = float(
        ((loss.detach() - ours).abs() / ours.abs().clamp(min=1e-6)).max())
    for res in out:
        emit("kernel_check", **res)
        require(res["ok"], f"{res['kernel']} {dtype_name}: max error "
                           f"{res['max_abs_err']} beyond {res['tolerance']}")
    return out


def phase_train_kernels(g):
    """Phase 6: K3, K6 and K7 against their plain versions on the training
    path's own tensors, bf16 and f32, TF32 off."""
    checks = []
    for dtype_name in ("bfloat16", "float32"):
        cfg, _, state, _, batch = train_setup(g, dtype_name, 0.0)
        checks.append(check_bigru_train(state, batch, dtype_name))
        checks.extend(check_ctc(state, batch, cfg, dtype_name))
    return checks


def phase_train_parity(g):
    """Phase 7: one f32 train step (dropout 0) through the kernels against
    the same step through the plain versions on the card, and against the
    JAX package's step (``testdata/train_goldens.npz``)."""
    import numpy as np
    import torch
    from crnn_ocr_torch.train import state as st_lib
    from crnn_ocr_torch.train import step as step_lib

    def one_step(plain: bool):
        cfg, _, state, _, batch = train_setup(g, "float32", 0.0)
        ctx = plain_kernels() if plain else contextlib.nullcontext()
        with ctx:
            state.optimizer.zero_grad(set_to_none=True)
            loss, loss_vec = step_lib.loss_fn(state.model, batch, cfg)
            loss.backward()
            grads = {k: p.grad.detach().clone()
                     for k, p in state.model.named_parameters()}
            gnorm = st_lib.apply_gradients(state)
        torch.cuda.synchronize()
        return (loss.item(), loss_vec.detach(), gnorm.item(), grads,
                {k: v.detach().clone()
                 for k, v in state.model.state_dict().items()})

    reset_launches()
    k_loss, k_vec, k_norm, k_grads, k_sd = one_step(False)
    kernel_counts = read_launches()
    p_loss, p_vec, p_norm, p_grads, p_sd = one_step(True)
    require(kernel_counts["bigru_train"] == 2 and
            kernel_counts["ctc_alpha"] == 1 and kernel_counts["ctc_beta"] == 1,
            f"the kernel step did not run through the kernels: "
            f"{kernel_counts}")
    # kernels against plain versions: loss and norm rtol 2e-5; every
    # parameter's gradient rtol 1e-4 / atol 1e-4 of the leaf's largest (f32
    # sums in other orders; the CTC gradient takes the rounding of alphas
    # near -100 into every element), as tests/test_torch_train.py holds the
    # port's gradients to jax.grad. Adam's first update is about lr * sign(g)
    # whatever |g|, so the updated parameters add a check of each sign:
    # rtol 2e-4 / atol 2e-5, except gradient elements at the f32 noise of
    # their sums (<= 1e-5 of the tensor's largest), where the update can
    # differ by up to 2 * lr (at most 0.1 % of a tensor)
    # per leaf: the smallest atol, as a share of its largest gradient, that
    # passes it at rtol 1e-4
    grad_err = {}
    for name, want in p_grads.items():
        excess = (k_grads[name] - want).abs() - 1e-4 * want.abs()
        grad_err[name] = (float(excess.clamp(min=0).max())
                          / max(float(want.abs().max()), 1e-30))
    grads_off = [n for n, e in grad_err.items() if e > 1e-4]
    bad = []
    for name, want in p_sd.items():
        got = k_sd[name]
        off = (got - want).abs() > 2e-5 + 2e-4 * want.abs()
        if name in p_grads:
            gr = p_grads[name].abs()
            noise = gr <= 1e-5 * gr.max()
            err_off = (got - want).abs()[off]
            if (bool((off & ~noise).any()) or float(off.float().mean()) > 1e-3
                    or (err_off.numel() and float(err_off.max())
                        > 2 * TRAIN_LR)):
                bad.append(name)
        elif bool(off.any()):
            bad.append(name)
    worst = max(grad_err, key=grad_err.get)
    res = dict(
        loss=k_loss, plain_loss=p_loss, grad_norm=k_norm,
        plain_grad_norm=p_norm,
        loss_rel_err=abs(k_loss / p_loss - 1),
        grad_norm_rel_err=abs(k_norm / p_norm - 1),
        grad_atol_needed_max=grad_err[worst], grad_atol_needed_worst=worst,
        grads_off=grads_off,
        max_param_abs_err=max(float((k_sd[n] - p_sd[n]).abs().max())
                              for n in p_sd),
        params_off=bad, launches_in_kernel_step=kernel_counts,
        tolerance="loss, grad_norm rtol 2e-5; each gradient rtol 1e-4 / "
                  "atol 1e-4 * the leaf's max; params rtol 2e-4 / atol "
                  "2e-5 (noise-level gradient elements: 2 * lr)")
    ok = (res["loss_rel_err"] <= 2e-5 and res["grad_norm_rel_err"] <= 2e-5
          and not grads_off and not bad)
    # against the JAX package's step: the port preprocesses the lines itself
    # (standardized frames within 1e-4 of JAX's), so loss rtol 1e-4, each
    # line's loss 1e-3 + 1e-3 relative, the global and per-parameter
    # gradient norms rtol 2e-3, the BatchNorm statistics atol 1e-4
    gold = np.load(os.path.join(REPO, "crnn_ocr_torch", "testdata",
                                "train_goldens.npz"))
    vec_err = np.abs(k_vec.cpu().numpy() - gold["loss_vec"])
    vec_ok = bool((vec_err <= 1e-3 + 1e-3 * np.abs(gold["loss_vec"])).all())
    gn_rel = max(abs(float(k_grads[n].norm()) / float(gold[f"gradnorm/{n}"])
                     - 1) for n in k_grads)
    st_err = max(float(np.abs(k_sd[k[6:]].cpu().numpy() - gold[k]).max())
                 for k in gold.files if k.startswith("stats/"))
    golden = dict(loss=float(gold["loss"]), grad_norm=float(gold["grad_norm"]),
                  loss_rel_err=abs(k_loss / float(gold["loss"]) - 1),
                  loss_vec_max_abs_err=float(vec_err.max()),
                  grad_norm_rel_err=abs(k_norm / float(gold["grad_norm"]) - 1),
                  param_grad_norm_max_rel_err=gn_rel,
                  bn_stats_max_abs_err=st_err)
    golden_ok = (golden["loss_rel_err"] <= 1e-4 and vec_ok
                 and golden["grad_norm_rel_err"] <= 2e-3 and gn_rel <= 2e-3
                 and st_err <= 1e-4)
    emit("train_parity", kernels_vs_plain=res, ok=ok, vs_jax_golden=golden,
         golden_ok=golden_ok)
    require(ok, f"f32 train step: kernels differ from the plain versions: "
                f"{res}")
    require(golden_ok, f"f32 train step differs from the JAX golden: "
                       f"{golden}")


def phase_train(g, card: str):
    """Phase 8, the training path counted: fonts-hard bf16, dropout 0.2,
    B = 128, bucket 256, fine-tuned on the 64 golden lines. Each step is
    ``produce_batch`` (the host canvas to device frames) plus ``fit``'s own
    train step, synchronized and timed; the launch counts are set to 0 just
    before the timed steps and read just after."""
    import torch
    from crnn_ocr_torch.data.pipeline import produce_batch
    from crnn_ocr_torch.train import loop as loop_lib
    from crnn_ocr_torch.train import state as st_lib
    from crnn_ocr_torch.train import step as step_lib

    cfg, codec, state, host, _ = train_setup(g, "bfloat16", 0.2)
    train_step = step_lib.make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []

    def step():
        batch = produce_batch(dict(host), "cuda", cfg)
        batch.pop("texts"), batch.pop("bucket")
        losses.append(train_step(state, batch, gen)["loss"])

    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    step_ms = []
    reset_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches()
    emit("launches", train_steps=TRAIN_STEPS, **counts)
    want = {"bigru_train": 2 * TRAIN_STEPS, "ctc_alpha": TRAIN_STEPS,
            "ctc_beta": TRAIN_STEPS, "fused_stem": 0, "bigru": 0}
    require(all(counts[k] == v for k, v in want.items()),
            f"train steps launched {counts}; expected {want} (2 K3, 1 K6, "
            "1 K7, 0 K1 and 0 K2 per step)")
    loss_curve = [float(x) for x in losses]
    first, last5 = loss_curve[0], statistics.mean(loss_curve[-5:])
    require(all(map(lambda v: v == v, loss_curve)), "a train loss is NaN")
    require(last5 < first, f"the loss did not fall: first {first}, mean of "
                           f"the last 5 {last5}")

    # per-stage breakdown through the same functions, synchronized per stage
    stages = {k: [] for k in ("preprocess", "forward", "loss", "backward",
                              "optimizer")}

    def clock(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages[key].append((t1 - t0) * 1e3)
        return t1

    for _ in range(8):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = produce_batch(dict(host), "cuda", cfg)
        t = clock("preprocess", t)
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(batch["x"], gen)
        t = clock("forward", t)
        loss_vec = step_lib.ctc_loss_vec(
            logits, batch["the_labels"], batch["input_length"],
            batch["label_length"], cfg.ctc_time_slice)
        loss = torch.clamp(loss_vec, max=step_lib.LOSS_CLIP).mean()
        t = clock("loss", t)
        loss.backward()
        t = clock("backward", t)
        st_lib.apply_gradients(state)
        clock("optimizer", t)
    stage_ms = {k: statistics.median(v[2:]) for k, v in stages.items()}
    p50 = statistics.median(step_ms)
    # all the lines of the timed steps over all their time, stalls included
    emit("train", model="fonts-hard", dtype="bfloat16", batch=TRAIN_BATCH,
         bucket=BUCKET, dropout=0.2, learning_rate=TRAIN_LR,
         steps=TRAIN_WARMUP + TRAIN_STEPS,
         lines_per_s=TRAIN_BATCH * TRAIN_STEPS / (sum(step_ms) / 1e3),
         p50_step_ms=p50, min_step_ms=min(step_ms), max_step_ms=max(step_ms),
         stage_ms=stage_ms, first_loss=first, last5_mean_loss=last5,
         loss_curve=loss_curve, card=card)
    emit("train_trace", **trace_train(step))

    # fit and evaluate themselves, outside the counted window
    batches = [produce_batch(dict(host), "cuda", cfg) for _ in range(4)]
    state = loop_lib.fit(state, cfg, iter(batches), lambda: iter(batches[:1]),
                         codec, loop_lib.FitConfig(
                             steps=state.step + 4, eval_every=2,
                             log_every=2, eval_batches=1))
    ev = loop_lib.evaluate(state, step_lib.make_eval_step(cfg),
                           iter(batches[:1]), codec, 1)
    emit("fit", steps=state.step, eval=ev)
    require(0.0 <= ev["cer"] <= 1.0, f"fit's evaluation is malformed: {ev}")
    return counts


def trace_train(step, n: int = 3) -> dict:
    """torch.profiler over ``n`` train steps: the device's idle share, the
    top device and host ops, and the plain BiGRU backward loop's share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = _trace_summary(prof, wall_us, n, skip=RANGES)
    for key in RANGES:
        # a range has a host row and a device-timeline row of one name; the
        # latter spans its first kernel's start to its last kernel's end,
        # gaps included
        rows = [r for r in prof.key_averages() if r.key == key]
        require(bool(rows), f"the trace has no {key} range")
        host = max(r.cpu_time_total for r in rows)
        span = max(r.device_time_total for r in rows)
        out[f"{key}_host_ms_per_step"] = host / n / 1e3
        out[f"{key}_device_span_ms_per_step"] = span / n / 1e3
        out[f"{key}_share_of_wall"] = host / wall_us
    return out


# record_function ranges the port's training path opens
RANGES = ("bigru_backward", "ctc_loss_backward")


def _trace_summary(prof, wall_us: float, n: int, skip=()) -> dict:
    """Device busy time (the union of kernel and copy intervals on the card,
    user ranges excluded), idle share, and the top device and host ops."""
    import torch

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False) and e.name not in skip
    )
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    require(busy > 0, "the trace shows no work on the device")
    avg = [r for r in prof.key_averages() if r.key not in skip]

    def top(attr, k=8):
        rows = sorted(avg, key=lambda r: getattr(r, attr), reverse=True)[:k]
        return [(r.key[:60], round(getattr(r, attr) / n / 1e3, 4))
                for r in rows]

    return dict(iterations=n, wall_ms_per_iteration=wall_us / n / 1e3,
                device_busy_ms_per_iteration=busy / n / 1e3,
                device_idle_share=1.0 - busy / wall_us,
                top_device_ms=top("self_device_time_total"),
                top_host_ms=top("self_cpu_time_total"))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU "
              "only", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from crnn_ocr_torch import load_pretrained
    except ImportError as e:
        print(f"chip_smoke: the crnn_ocr_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    phase_build(card)

    # phase 2: kernels against their plain versions on the main path's data
    g = np.load(os.path.join(REPO, "crnn_ocr_torch", "testdata",
                             "greedy_goldens.npz"))
    lines = golden_lines(g, "hard")
    lines = (lines * (BATCH // len(lines) + 1))[:BATCH]
    checks = []
    with torch.inference_mode():
        for dtype_name in ("bfloat16", "float32"):
            pred = load_pretrained("fonts-hard", device="cuda",
                                   dtype=dtype_name)
            m = pred.model
            x, _ = pred.preprocess(lines, BUCKET)
            feat = m.frame_features(m.backbone(m.stem(x)))
            checks.append(check_stem(m, x, dtype_name))
            checks.append(check_bigru(m, feat, dtype_name))

    phase_goldens(g)
    counts = phase_throughput(g, card)

    # slice 2: training
    checks += phase_train_kernels(g)
    phase_train_parity(g)
    counts.update({k: v for k, v in phase_train(g, card).items()
                   if k in ("bigru_train", "ctc_alpha", "ctc_beta")})

    sources = {
        "fused_stem": ("crnn_ocr_torch/kernels/csrc/fused_stem.cu",
                       "crnn_ocr_tpu/kernels/fused_stem.py:134"),
        "bigru": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                  "crnn_ocr_tpu/kernels/bigru.py:76"),
        "bigru_train": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                        "crnn_ocr_tpu/kernels/bigru.py:144"),
        "ctc_alpha": ("crnn_ocr_torch/kernels/csrc/ctc_loss.cu",
                      "crnn_ocr_tpu/kernels/ctc_loss.py:195"),
        "ctc_beta": ("crnn_ocr_torch/kernels/csrc/ctc_loss.cu",
                     "crnn_ocr_tpu/kernels/ctc_loss.py:217"),
    }
    kernels = []
    for c in checks:
        if c["dtype"] != "bfloat16":  # both paths run bf16
            continue
        name = c["kernel"]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=counts[name],
            max_abs_err=c["max_abs_err"], ms=c["kernel_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            f32_max_abs_err=next(
                o["max_abs_err"] for o in checks
                if o["kernel"] == name and o["dtype"] == "float32"),
        ))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
