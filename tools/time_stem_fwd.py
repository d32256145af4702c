"""Time K1 (the serving stem) and K8 (the training stem's batch statistics)
on one GPU.

    python3 tools/time_stem_fwd.py

K1 at ``fonts-hard``'s serving shape (B 256, 32 x 256, C 64, bf16) on both
designs, ``"mma"`` (the window tile on the tensor cores, what bf16 serving
runs) and ``"conv9"`` (``stem_kernel``, what the training forward runs), on
the same seeded operands: each held to the plain version (one bf16 ulp of
the output, plus 1e-6) and the two designs to each other (the same). K8 at
``fonts-small``'s training shape (B 128, 32 x 128, C 64) and ``fonts-hard``'s
(B 128, 32 x 256), bf16 and f32: held to its plain version (1e-5 of the sum
of its terms' magnitudes, plus 1e-6), and run twice for the same bits. Each
is timed by torch.profiler over 20 calls after a warm-up call, three
windows, median: ``kernel_ms`` is the kernel's own device time a call,
``call_ms`` all the device work of the wrapper's call (for K8 also the sum
of the CTAs' partials). Each line gives the launch's plan
(``_stem_tiles.stem_plan``) and the instance's ptxas report. Prints the
card's ``name, power.limit``, then one JSON line per measurement. Needs a
CUDA card; builds ``csrc/fused_stem.cu`` at first use. ``--rows N`` launches
the tensor-core kernel with N pooled rows a tile (default
``_stem_tiles.TILE_ROWS``, what the wrappers launch with) and ``--label``
tags every line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SERVE = (256, 32, 256, 64)
STATS = (("small", 128, 32, 128, 64), ("hard", 128, 32, 256, 64))
KERNEL = {"mma": "stem_mma_kernel", "conv9": "stem_kernel"}


def profile_ms(fn, name: str, reps: int = 20):
    """(the named kernel's device ms a call, all device ms a call), medians
    of three profiler windows of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    kern, call = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dur = lambda es: sum(e.time_range.end - e.time_range.start  # noqa
                             for e in es) / reps / 1e3
        kern.append(dur([e for e in recs if name in e.name]))
        call.append(dur(recs))
    return statistics.median(kern), statistics.median(call)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke
    from crnn_ocr_torch.kernels import _build
    from crnn_ocr_torch.kernels import _stem_tiles as stiles
    from crnn_ocr_torch.kernels import fused_stem as fs
    from crnn_ocr_torch.kernels import fused_stem_train as fst

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    _build.build_all(["fused_stem"])
    ptxas = chip_smoke.stem_fwd_ptxas(_build.ptxas_reports.get("fused_stem",
                                                               ""))
    dev = torch.device("cuda")
    ok = True
    rows = args.rows or stiles.TILE_ROWS
    tag = dict(label=args.label, rows=rows)

    rng = np.random.default_rng(5)
    B, H, W, C = SERVE
    img = torch.from_numpy(rng.normal(size=(B, H, W, 1)).astype(np.float32))
    img = img.to(torch.bfloat16).to(dev)
    w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                         .astype(np.float32)).to(dev)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=C) * 0.2).astype(np.float32))
    scale, bias = scale.to(dev), bias.to(dev)
    want = fs.fused_stem_plain(img, w, scale, bias).float()
    outs = {}
    for design in ("mma", "conv9"):
        def run(design=design):
            if design == "mma":
                return stiles.launch_mma(img, w, scale, bias, rows)
            return fs._forward(img, w, scale, bias, design)

        got = run().float()
        outs[design] = got
        good = bool(((got - want).abs() <= want.abs() * 2.0 ** -7 + 1e-6)
                    .all())
        ok &= good
        k_ms, c_ms = profile_ms(run, KERNEL[design])
        print(json.dumps(dict(
            **tag, kernel="fused_stem", design=design, B=B, H=H, W=W, C=C,
            dtype="bfloat16", ok=good,
            max_abs_err=float((got - want).abs().max()),
            kernel_ms=k_ms, call_ms=c_ms,
            plan=(dataclasses.asdict(stiles.stem_design(img, C, False, rows))
                  if design == "mma" else None),
            ptxas=ptxas.get(f"fused_stem bfloat16 {design}"))), flush=True)
    a, b = outs["mma"], outs["conv9"]
    same = bool(((a - b).abs() <= b.abs() * 2.0 ** -7 + 1e-6).all())
    ok &= same
    print(json.dumps(dict(**tag, kernel="fused_stem",
                          mma_within_1_ulp_of_conv9=same,
                          max_abs_diff=float((a - b).abs().max()))),
          flush=True)

    for key, B, H, W, C in STATS:
        for dtype in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(3)
            img = torch.from_numpy(rng.normal(size=(B, H, W, 1))
                                   .astype(np.float32)).to(dtype).to(dev)
            w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                                 .astype(np.float32)).to(dev)
            def stats():
                return stiles.launch_mma(img, w, rows=rows)

            got, again = stats(), stats()
            want = fst.stem_stats_plain(img, w)
            z = fst._conv(img, w)
            sc = torch.stack([z.abs().sum((0, 2, 3)),
                              (z * z).sum((0, 2, 3))])
            err = (got - want).abs()
            good = bool((err <= 1e-5 * sc + 1e-6).all())
            same = torch.equal(got, again)
            ok &= good and same
            k_ms, c_ms = profile_ms(stats, "stem_mma_kernel")
            name = str(dtype)[6:]
            print(json.dumps(dict(
                **tag, kernel="stem_stats", shape=key, B=B, H=H, W=W, C=C,
                dtype=name, ok=good, same_bits_twice=same,
                max_err_over_scale=float((err / sc.clamp(min=1e-30)).max()),
                kernel_ms=k_ms, call_ms=c_ms,
                plan=dataclasses.asdict(stiles.stem_design(img, C, True,
                                                           rows)),
                ptxas=ptxas.get(f"stem_stats {name}"))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
