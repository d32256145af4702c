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

The last lines are the card's ``name, power.limit``, the kernels' JSON
line and ``{"ok": true, "device": {...}}``.
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
    """Run the model's kernel call sites through the plain versions (for
    the card-side comparison run of phase 3 only)."""
    import crnn_ocr_torch.models.crnn as crnn_mod
    import crnn_ocr_torch.models.rnn as rnn_mod
    from crnn_ocr_torch.kernels import bigru, fused_stem

    saved = (crnn_mod.fused_stem_serve, rnn_mod.bigru)

    def gru(xw, u, rec_bias, u_kernel=None):
        return bigru.bigru_plain(xw, u, rec_bias)

    crnn_mod.fused_stem_serve, rnn_mod.bigru = fused_stem.fused_stem_plain, gru
    try:
        yield
    finally:
        crnn_mod.fused_stem_serve, rnn_mod.bigru = saved


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
    from crnn_ocr_torch.kernels import bigru, fused_stem

    reps = 20
    pred = load_pretrained("fonts-hard", device="cuda")
    lines = golden_lines(g, "hard")
    lines = (lines * (BATCH // len(lines) + 1))[:BATCH]
    for _ in range(3):
        pred.predict(lines, bucket=BUCKET)
    torch.cuda.synchronize()
    batch_ms = []
    fused_stem.launches = 0
    bigru.launches = 0
    for _ in range(reps):
        t0 = time.perf_counter()
        out = pred.predict(lines, bucket=BUCKET)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {"fused_stem": fused_stem.launches, "bigru": bigru.launches}
    emit("launches", predict_calls=reps, **counts)
    require(counts["fused_stem"] == reps,
            f"fused_stem launched {counts['fused_stem']} times in {reps} "
            "predict calls (1 per call expected)")
    require(counts["bigru"] == 2 * reps,
            f"bigru launched {counts['bigru']} times in {reps} predict "
            "calls (2 per call expected, one per BiGRU layer)")
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
    # device busy time: the union of kernel and copy intervals on the card
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    avg = prof.key_averages()

    def top(attr, k=8):
        rows = sorted(avg, key=lambda r: getattr(r, attr), reverse=True)[:k]
        return [(r.key[:60], round(getattr(r, attr) / n / 1e3, 4))
                for r in rows]

    return dict(batches=n, wall_ms_per_batch=wall_us / n / 1e3,
                device_busy_ms_per_batch=busy / n / 1e3,
                device_idle_share=1.0 - busy / wall_us,
                top_device_ms_per_batch=top("self_device_time_total"),
                top_host_ms_per_batch=top("self_cpu_time_total"))


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

    sources = {
        "fused_stem": ("crnn_ocr_torch/kernels/csrc/fused_stem.cu",
                       "crnn_ocr_tpu/kernels/fused_stem.py:134"),
        "bigru": ("crnn_ocr_torch/kernels/csrc/bigru.cu",
                  "crnn_ocr_tpu/kernels/bigru.py:76"),
    }
    kernels = []
    for c in checks:
        if c["dtype"] != "bfloat16":  # the main path runs bf16
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
