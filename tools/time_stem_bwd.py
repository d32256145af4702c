"""Time K9 and K10 (the training stem's backward) on one GPU.

    python3 tools/time_stem_bwd.py

On seeded operands at ``fonts-small``'s training shape (B 128, 32 x 128,
C 64) and ``fonts-hard``'s (B 128, 32 x 256, C 64), bf16 and f32: each
kernel's wrapper is held to its plain version (1e-5 of the sum of its
terms' magnitudes, plus 1e-6) and timed by torch.profiler over 20 calls
after a warm-up call, three windows, median: ``kernel_ms`` is the tiled
kernel's own device time a call, ``call_ms`` all the device work of the
wrapper's call (the parameter concatenation and the sum of the CTAs'
partials too). Each line also gives the launch's plan
(``fused_stem_train.bwd_plan``). Prints the card's ``name, power.limit``,
then one JSON line per measurement. Needs a CUDA card; builds
``csrc/fused_stem.cu`` at first use.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = (("small", 128, 32, 128, 64), ("hard", 128, 32, 256, 64))


def operands(B, H, W, C, dtype, seed=3):
    """An image, weights and a pooled gradient, and K9's and K10's
    per-channel vectors as the autograd Function derives them, on the
    card."""
    import numpy as np
    import torch
    from crnn_ocr_torch.kernels import fused_stem_train as fst

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    img = torch.from_numpy(rng.normal(size=(B, H, W, 1)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 1, C)) * 0.5)
                         .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, H // 2, W // 2, C))
                         .astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    beta = torch.from_numpy((rng.normal(size=C) * 0.3).astype(np.float32))
    img, g = img.to(dtype).to(dev), g.to(dtype).to(dev)
    w, gamma, beta = w.to(dev), gamma.to(dev), beta.to(dev)
    n = float(B * H * W)
    st = fst.stem_stats_plain(img, w)
    mean = st[0] / n
    var = st[1] / n - mean * mean
    v9 = (mean, *fst.bwd_affine(gamma, beta, mean, var))
    p = fst.stem_bwd_partials_plain(img, w, g, *v9)
    return img, w, g, v9, v9 + (v9[2], p[0] / n, p[1] / n)


def profile_ms(fn, reps: int = 20):
    """(the tiled kernel's device ms a call, all device ms a call), medians
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
        kern.append(dur([e for e in recs if "bwd_tile_kernel" in e.name]))
        call.append(dur(recs))
    return statistics.median(kern), statistics.median(call)


def main() -> int:
    import torch
    import chip_smoke
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
    ok = True
    for key, B, H, W, C in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            img, w, g, v9, v10 = operands(B, H, W, C, dtype)
            scales = chip_smoke.stem_train_scales(img, w, g, *v10)[1:]
            for final, kern, plain, vecs, sc in (
                    (False, fst.stem_bwd_partials, fst.stem_bwd_partials_plain,
                     v9, scales[0]),
                    (True, fst.stem_bwd_final, fst.stem_bwd_final_plain, v10,
                     scales[1])):
                got = kern(img, w, g, *vecs)
                want = plain(img, w, g, *vecs)
                err = (got - want).abs()
                good = bool((err <= 1e-5 * sc + 1e-6).all())
                ok &= good
                k_ms, c_ms = profile_ms(lambda: kern(img, w, g, *vecs))
                print(json.dumps(dict(
                    kernel="stem_bwd_final" if final else "stem_bwd_partials",
                    shape=key, B=B, H=H, W=W, C=C, dtype=str(dtype)[6:],
                    ok=good, max_err_over_scale=float(
                        (err / sc.clamp(min=1e-30)).max()),
                    kernel_ms=k_ms, call_ms=c_ms,
                    plan=dataclasses.asdict(fst.bwd_design(img, C, final)))),
                    flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
