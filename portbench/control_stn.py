"""``control.py``'s readings for a cell of the STN model (driver
``train_stn``), whose control and witness take the STN's plain reference
(``reference/stn.py``) where ``control.py`` takes the CRNN's, and whose
check has a number (``warp_grad_gap``) that ``control.py``'s judge lacks:

    python3 portbench/control_stn.py --workload train-warp-stn --mode fp8 \\
        --seeds 11,12,13

Modes: ``program``, ``fp8`` and ``bf16`` as ``control.py`` has them; the
faults of ``faults.py`` (``frozen_state``, ``half_batch``) and of
``faults_stn.py`` (``k12_doubled``).

Prints a JSON line a seed, as ``control.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _reference(conf, mix, seed: int, dev, q) -> dict:
    """The control: the reference at ``q``'s precision in the program's
    place, judged against the float32 reference."""
    from portbench import counts
    from portbench.drivers import train, train_stn
    from portbench.reference import model, stn

    model.float32_exact()
    n = mix["checked_steps"]
    seeds = [train.step_seed(seed, k) for k in range(n)]
    W = stn.load_weights(conf, ROOT, dev)
    batches = train_stn.warp_batches(
        mix, seed, model.load_classes(conf, ROOT), counts.downsample(conf),
        conf["ctc_time_slice"])[:n]
    low = stn.train_steps(W, batches, seeds, conf, mix, dev, q=q)
    return train_stn.judge_stn(
        low, stn.train_steps(W, batches, seeds, conf, mix, dev))


def reading(workload: str, mode: str, seed: int, device: str = "cuda",
            mix_overrides=None, detail: bool = False) -> dict:
    import torch

    from portbench import faults, faults_stn, harness
    from portbench.drivers import train_stn
    from portbench.reference import model

    plan = harness.cell_plan(harness.load_benchmark(), workload)
    conf, mix = plan["conf"], dict(plan["mix"], **(mix_overrides or {}))
    dev = torch.device(device)
    if mode in ("fp8", "bf16"):
        numbers = _reference(conf, mix, seed, dev, getattr(model, mode))
    else:
        plant = {"frozen_state": faults.frozen_state,
                 "half_batch": faults.half_batch,
                 **faults_stn.FAULTS}.get(mode)
        if mode != "program" and plant is None:
            raise SystemExit(f"no mode {mode!r}")
        driver = train_stn.Driver(conf, mix, seed, dev,
                                  None if plant is None else plant())
        driver.sync()
        driver.release()
        model.float32_exact()
        numbers = driver.check(model.load_weights(conf, ROOT, dev),
                               model.load_classes(conf, ROOT))
    if not detail:
        numbers = {k: v for k, v in numbers.items() if not k.startswith("__")}
    limits = plan["limits"]
    return {"workload": workload, "mode": mode, "seed": seed,
            "numbers": numbers,
            "passes": all(numbers[k] <= v for k, v in limits.items())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--detail", action="store_true",
                    help="also print every leaf's gaps")
    args = ap.parse_args()
    for s in args.seeds.split(","):
        t = time.perf_counter()
        out = reading(args.workload, args.mode, int(s), detail=args.detail)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
