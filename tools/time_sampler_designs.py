"""Time K12 (the STN sampler's backward) on one GPU, on every design and
cluster size of ``crnn_ocr_torch/kernels/grid_sample.py::plan``, with K11
(the forward) beside it for reference.

    python3 tools/time_sampler_designs.py [--rounds 2] [--label TEXT]

At ``fonts-warp-stn``'s shapes (32 x 256 frames, N 8192 samples an image):
B 128 (its training step) and B 256 (its serving batch), with the image in
bf16 and in f32, on the path's own tensors (its golden lines' frames and
its STN's theta, as ``chip_smoke.py`` phase 9 takes them) and a seeded
upstream gradient. Each design's outputs are held to the plain version (dx, dy to
1e-6 + 1e-6 * |plain|, d_img to 1e-5 + 1e-5 * |plain|) and to the
``"image"`` design's (dx, dy bit for bit); ``path`` marks the cluster
size ``grid_sample.cluster_for`` picks. Each instance is timed by
torch.profiler (``chip_smoke.kernel_device_ms``: its kernel's device
time a launch, the mean over a window's records of that kernel, median of
three windows of 20 launches after a warm-up launch), twice: warm (the
inputs in the 50 MB L2 from the launch before) and cold (a 128 MB buffer
written before each launch, which evicts them), in
``--rounds`` rounds of turns over the instances. Each line gives the plan,
the byte bound (each input read once, each output written once, over
3.35 TB/s) and the share of it, and the instance's ptxas report. Prints
the card's ``name, power.limit`` first, then one JSON line per
measurement; exits 1 if any check fails. Needs a CUDA card; builds
``csrc/grid_sample.cu`` at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

H, W = 32, 256  # fonts-warp-stn's frames; N = H * W samples an image
BATCHES = (128, 256)
CLUSTERS = (1, 2, 4, 8)


def operands(dtype_name: str, dev):
    """``fonts-warp-stn``'s frames (its 64 golden lines, repeated to the
    largest batch, preprocessed as its predictor does) in ``dtype_name``,
    and the pixel coordinates of its own STN's theta; a seeded upstream
    gradient."""
    import numpy as np
    import torch
    from crnn_ocr_torch import load_pretrained
    from crnn_ocr_torch.kernels import grid_sample as gs
    from crnn_ocr_torch.ops.grid_sample import affine_grid
    import chip_smoke

    sg = np.load(os.path.join(REPO, "crnn_ocr_torch", "testdata",
                              "stn_goldens.npz"))
    lines = chip_smoke.golden_lines(sg, chip_smoke.STN_KEY)
    B = max(BATCHES)
    lines = (lines * (B // len(lines) + 1))[:B]
    pred = load_pretrained(chip_smoke.STN_NAME, device=dev, dtype=dtype_name)
    with torch.no_grad():
        x, _ = pred.preprocess(lines, chip_smoke.BUCKET)
        img = x.to(pred.model.dtype)
        theta = pred.model.stn.localize(img)
        xs, ys = gs.pixel_coords(affine_grid(theta, H, W), H, W)
    g = torch.randn(xs.shape, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    return img, xs, ys, g


def instances(clusters):
    """(design, cluster) of every K12 instance the tool times."""
    from crnn_ocr_torch.kernels import grid_sample as gs

    return [("image", 1)] + [(d, c) for d in gs.DESIGNS if d != "image"
                             for c in clusters]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--label", default="")
    ap.add_argument("--clusters", default=",".join(map(str, CLUSTERS)),
                    help="cluster sizes to time, comma-separated")
    args = ap.parse_args()
    clusters = [int(c) for c in args.clusters.split(",")]
    import torch
    import chip_smoke
    from crnn_ocr_torch.kernels import _build
    from crnn_ocr_torch.kernels import grid_sample as gs

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    _build.build_all(["grid_sample"])
    ptxas = chip_smoke.sampler_ptxas(_build.ptxas_report("grid_sample"))
    print(json.dumps({"ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    timed = chip_smoke.kernel_device_ms
    ok = True
    for rnd in range(args.rounds):
        for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                                  ("float32", torch.float32)):
            full = operands(dtype_name, dev)
            for B in BATCHES:
                img, x, y, g = (t[:B].contiguous() for t in full)
                N = x.shape[1]
                want = gs.sample_pix_bwd_plain(img, x, y, g)
                first = gs.sample_pix_bwd(img, x, y, g, "image")
                bytes_moved = chip_smoke.nbytes(img, x, y, g, *want)
                bound, _ = chip_smoke.bound_ms(bytes_moved, 40 * B * N,
                                               "float32")
                base = dict(label=args.label, round=rnd, dtype=dtype_name,
                            B=B, H=H, W=W, N=N, bound_ms=bound,
                            bytes=bytes_moved)
                for design, cluster in instances(clusters):
                    run = (lambda d=design, c=cluster:
                           gs.sample_pix_bwd(img, x, y, g, d, c))
                    got = run()
                    torch.cuda.synchronize()
                    errs, good = {}, True
                    for key, a, b, tol in zip(("d_img", "dx", "dy"), got,
                                              want, (1e-5, 1e-6, 1e-6)):
                        errs[key], fine = chip_smoke._close(a, b, tol, tol)
                        good &= fine
                    same = all(torch.equal(a, b)
                               for a, b in zip(got[1:], first[1:]))
                    ok &= good and same
                    p = gs.plan(B, H, W, N, img.element_size(), design,
                                cluster)
                    warm = timed(run, "sample_bwd")
                    cold = timed(run, "sample_bwd", cold=True)
                    print(json.dumps(dict(
                        base, kernel="grid_sample_bwd", design=design,
                        cluster=cluster, path=(
                            design == "cluster"
                            and cluster == gs.cluster_for(B, H, W)),
                        ok=good, errors=errs,
                        dxdy_equal_to_image=same, ms=warm, cold_ms=cold,
                        share=bound / warm, cold_share=bound / cold,
                        plan=p._asdict(),
                        resources=(None if design == "image" else
                                   gs.resources(p, img.element_size())),
                        ptxas=ptxas.get(chip_smoke.sampler_ptxas_key(
                            p, dtype_name)))), flush=True)
                fwd = lambda: gs.sample_pix(img, x, y)  # noqa: E731
                fwd_bytes = chip_smoke.nbytes(img, x, y, want[1])
                fwd_bound, _ = chip_smoke.bound_ms(fwd_bytes, 20 * B * N,
                                                   "float32")
                warm = timed(fwd, "sample_fwd")
                cold = timed(fwd, "sample_fwd", cold=True)
                print(json.dumps(dict(
                    base, kernel="grid_sample", bound_ms=fwd_bound,
                    bytes=fwd_bytes, ms=warm, cold_ms=cold,
                    share=fwd_bound / warm, cold_share=fwd_bound / cold,
                    ptxas=ptxas.get(f"grid_sample {dtype_name}"))),
                    flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
