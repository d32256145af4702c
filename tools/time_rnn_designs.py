"""Time the recurrence kernels' designs against each other on one GPU.

    python3 tools/time_rnn_designs.py

For each of K2 (the GRU, serving), K3 (the GRU with its stash, training),
K4 (the LSTM, serving) and K5 (the LSTM with its stash, training) at H 256
and H 128, T 64, on seeded random inputs: the resident design at 8, 16 and
32 batch rows a cluster, and the streamed design, at batches where the
fewer rows fit one wave of the card's clusters and where they do not. Each
resident instance's line gives the CTAs of its grid and the clusters the
card holds at once (``cudaOccupancyMaxActiveClusters``) with its shared
memory, from which ``kernels/bigru.py::WAVE_CTAS`` is read. Each time is
the mean of 20 back-to-back launches between two CUDA events, after 3
warm-up launches, in two rounds; every resident design's hs (and stash) is
held to the streamed design's (``max_abs_diff``, 0 when bit for bit equal).

The f32 GRU (K2, K3) at ``fonts-small``'s width (H 128, T 32) at B 256,
128, 64 and 16, and at ``fonts-hard``'s (H 256, T 64) at B 256 and 128;
the f32 LSTM (K4, K5) at ``fonts-hard-lstm``'s (H 256, T 64: K5 at B 128,
K4 at B 256 and 128) and at H 128, T 32 (the 64-unit tile): the resident
design's f32 instance (3xTF32 on the tensor cores) at each of its rows (8
and 16 for the GRU; 8, 16 and 32 for the LSTM), and the old ``"f32"``
design, each timed by its device time (``chip_smoke.device_ms``: the
profiler's kernel durations, since one call of the resident design takes
less than the host needs to launch it) and held to the plain version on
the card (``max_abs_err``), with the same capacity fields (the f32 entries
of ``kernels/bigru.py::WAVE_CTAS``). A variant of ``csrc/bigru.cu`` (the
K split over 8 warps, or no product at all, timing only) is timed by this
script's copy in a copy of the tree whose ``.cu`` is edited.

Prints the card's ``name, power.limit``, then one JSON line per
measurement. Needs a CUDA card; builds ``csrc/bigru.cu`` at first use.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (cell, stash, H, B): K2, K5, K3, K4
CASES = (("gru", False, 256, 256), ("gru", False, 256, 240),
         ("gru", False, 256, 112), ("gru", False, 128, 256),
         ("gru", False, 128, 64), ("gru", False, 128, 16),
         ("lstm", True, 256, 256), ("lstm", True, 256, 128),
         ("lstm", True, 256, 112), ("lstm", True, 256, 64),
         ("lstm", True, 128, 128), ("lstm", True, 128, 64),
         ("lstm", True, 128, 16),
         ("gru", True, 256, 128), ("gru", True, 256, 64),
         ("gru", True, 128, 128),
         ("lstm", False, 256, 256), ("lstm", False, 256, 128),
         ("lstm", False, 128, 128))
# the f32 recurrences: (cell, stash, H, B, T)
F32_CASES = tuple(("gru", *c) for c in (
    (False, 128, 256, 32), (True, 128, 128, 32),
    (False, 128, 128, 32), (True, 128, 256, 32),
    (False, 128, 64, 32), (True, 128, 64, 32),
    (False, 128, 16, 32), (True, 128, 16, 32),
    (False, 256, 256, 64), (True, 256, 128, 64),
    (False, 256, 128, 64), (True, 256, 256, 64))) + tuple(
    ("lstm", *c) for c in (
        (True, 256, 128, 64), (False, 256, 256, 64), (False, 256, 128, 64),
        (True, 128, 128, 32), (False, 128, 256, 32)))


def event_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / reps


def resident_fields(cell, stash, H, B, d, dtype_name="bfloat16") -> dict:
    from chip_smoke import resident_resources

    res = resident_resources(cell, stash, -(-H // 16) * 16, d, dtype_name)
    return dict(ctas=-(-B // d.rows) * 2 * d.cluster,
                smem_bytes=res["smem_bytes"],
                max_active_clusters=res["max_active_clusters"],
                wave_ctas=res["max_active_clusters"] * d.cluster,
                registers=res["runtime_registers"],
                local_bytes=res["local_bytes"], ptxas=res["ptxas"])


def time_f32() -> None:
    """The f32 recurrences' designs (F32_CASES x the resident instance's
    rows, and the old ``"f32"`` design) on seeded inputs, in two rounds."""
    import numpy as np
    import torch

    from chip_smoke import device_ms
    from crnn_ocr_torch.kernels import bigru as bg

    torch.backends.cuda.matmul.allow_tf32 = False
    for cell, stash, H, B, T in F32_CASES:
        rng = np.random.default_rng(2)
        n = bg.GATES[cell]
        xw = torch.from_numpy(rng.normal(size=(T, 2, B, n * H))
                              .astype(np.float32)).cuda()
        u = torch.from_numpy((rng.normal(size=(2, H, n * H)) / np.sqrt(H))
                             .astype(np.float32)).cuda()
        rb = (torch.from_numpy((rng.normal(size=(2, n * H)) * 0.1)
                               .astype(np.float32)).cuda()
              if cell == "gru" else None)
        if cell == "gru":
            plain = bg.bigru_train_plain if stash else bg.bigru_plain
            want = plain(xw, u, rb)
        else:
            plain = bg.bilstm_train_plain if stash else bg.bilstm_plain
            want = plain(xw, u)
        want = want if stash else (want, None)
        chosen = bg.design_for(cell, stash, H, B, torch.float32)
        designs = [chosen._replace(rows=r)
                   for r in bg.resident_rows(torch.float32, cell)]
        designs.append(bg.Design("f32"))
        for rnd in range(2):
            for d in designs:
                def run(d=d):
                    return bg._launch(cell, xw, u, rb, None, stash, d)

                got = run()
                out = dict(cell=cell, dtype="float32", stash=stash, B=B,
                           H=H, T=T, design=d._asdict(), chosen=d == chosen,
                           ms=device_ms(run), round=rnd,
                           max_abs_err=max(
                               float((a - b).abs().max())
                               for a, b in zip(got, want) if a is not None))
                if d.name != "f32":
                    out.update(resident_fields(cell, stash, H, B, d,
                                               "float32"))
                print(json.dumps(out), flush=True)


def main() -> int:
    import numpy as np
    import torch

    from crnn_ocr_torch.kernels import bigru as bg

    if not torch.cuda.is_available():
        print("time_rnn_designs: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    time_f32()
    T = 64
    for cell, stash, H, B in CASES:
        rng = np.random.default_rng(1)
        n = bg.GATES[cell]
        xw = torch.from_numpy(rng.normal(size=(T, 2, B, n * H))
                              .astype(np.float32)).bfloat16().cuda()
        u = torch.from_numpy((rng.normal(size=(2, H, n * H)) / np.sqrt(H))
                             .astype(np.float32)).bfloat16().cuda()
        rb = torch.zeros(2, n * H, device="cuda") if cell == "gru" else None
        uk = bg.kernel_weights(u)
        chosen = bg.design_for(cell, stash, H, B, torch.bfloat16)
        streamed = bg.Design("streamed", 0, 16)
        designs = [chosen._replace(rows=rows) for rows in bg.RESIDENT_ROWS]
        designs.append(streamed)
        want = bg._launch(cell, xw, u, rb, uk, stash, streamed)
        for rnd in range(2):
            for d in designs:
                def run(d=d):
                    return bg._launch(cell, xw, u, rb, uk, stash, d)

                out = dict(cell=cell, stash=stash, B=B, H=H, T=T,
                           design=d._asdict(), chosen=d == chosen,
                           ms=event_ms(run), round=rnd)
                if d.name == "resident":
                    out["max_abs_diff"] = max(
                        float((a - b).float().abs().max())
                        for a, b in zip(run(), want) if a is not None)
                    out.update(resident_fields(cell, stash, H, B, d))
                print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
