"""Time K6 and K7 (the CTC alpha and beta recursions) on one GPU, on every
design of ``crnn_ocr_torch/kernels/ctc_loss.py::plan``.

    python3 tools/time_ctc_designs.py [--rounds 2] [--label TEXT]

At the training path's shape (B 128, T 62, labels padded to 32: S 65, 63
classes), at twice its frames, and at S 11, 129, 257, 513 and 1023 (the
most states a plan takes), on seeded log-probs (``torch.log_softmax`` of normal
logits; input lengths drawn in [T / 2, T], label lengths in [0, L], one
infeasible sample), each design's output is held to the plain version
(1e-4 + 1e-5 * |plain| where finite, exactly NEG where the plain version is
NEG) and compared bit for bit with the ``"block"`` design's. Each design is
timed by torch.profiler over 20 calls after a warm-up call, three windows,
median (``kernel_ms``, the kernel's device time a call), in ``--rounds``
rounds of turns over the designs; ``us_per_frame`` divides it by the
dependent frames (T - 1 for alpha, T for beta). Each line gives the plan
and the instance's ptxas report. Prints the card's ``name, power.limit``,
then one JSON line per measurement; exits 1 if any check fails. Needs a
CUDA card; builds ``csrc/ctc_loss.cu`` at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (B, T, C, L): the training path's shape, at twice its frames, and S 11,
# 129, 257, 513 and 1023
SHAPES = ((128, 62, 63, 32), (128, 124, 63, 32), (256, 30, 12, 5),
          (64, 62, 63, 64), (64, 62, 63, 128), (32, 62, 63, 256),
          (5, 126, 40, 511))


def profile_ms(fn, reps: int = 20) -> float:
    """The device ms a call of ``fn``'s kernels, median of three profiler
    windows of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "ctc_" in e.name]
        out.append(sum(e.time_range.end - e.time_range.start
                       for e in recs) / reps / 1e3)
    return statistics.median(out)


def case(B, T, C, L, dev):
    import numpy as np
    import torch
    from crnn_ocr_torch.kernels import ctc_loss as cl

    rng = np.random.default_rng(B * 1000 + T)
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, T, C)).astype(np.float32)), -1)
    labels = torch.from_numpy(rng.integers(0, C - 1, (B, L)))
    il = torch.from_numpy(rng.integers(T // 2, T + 1, (B,)).astype(np.int32))
    ll = torch.from_numpy(rng.integers(0, L + 1, (B,)).astype(np.int32))
    il[0], ll[0] = 1, L  # infeasible
    emits, flags, lens, _, _ = cl.prepare(lp.to(dev), labels.to(dev),
                                          il.to(dev), ll.to(dev))
    return emits, flags, lens


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    import chip_smoke
    from crnn_ocr_torch.kernels import _build
    from crnn_ocr_torch.kernels import ctc_loss as cl

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    _build.build_all(["ctc_loss"])
    ptxas = chip_smoke.ctc_ptxas(_build.ptxas_reports.get("ctc_loss", ""))
    dev = torch.device("cuda")
    ok = True
    for B, T, C, L in SHAPES:
        emits, flags, lens = case(B, T, C, L, dev)
        S = emits.shape[2]
        for name, fn, plain in (("alpha", cl.ctc_alphas, cl.ctc_alphas_plain),
                                ("beta", cl.ctc_betas, cl.ctc_betas_plain)):
            want = plain(emits, flags, lens)
            block = fn(emits, flags, lens, "block")
            for rnd in range(args.rounds):
                for design in cl.DESIGNS:
                    got = fn(emits, flags, lens, design)
                    torch.cuda.synchronize()
                    err, good = chip_smoke.ctc_close(got, want)
                    ok &= good
                    ms = profile_ms(lambda: fn(emits, flags, lens, design))
                    p = cl.plan(B, T, S, design)
                    frames = T - 1 if name == "alpha" else T
                    print(json.dumps(dict(
                        label=args.label, round=rnd, kernel=f"ctc_{name}",
                        design=design, B=B, T=T, S=S, ok=good,
                        max_abs_err=err,
                        block_equal=bool(torch.equal(got, block)),
                        kernel_ms=ms, us_per_frame=ms * 1e3 / max(frames, 1),
                        plan=p._asdict(),
                        ptxas=ptxas.get(chip_smoke.ctc_ptxas_key(name, p)))),
                        flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
