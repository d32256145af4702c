"""The readings the limits in ``limits/`` are set from, at a cell's own
size, without a measured window (the benchmark's runs never run this):

    python3 portbench/control.py --workload serve-hard --mode fp8 \
        --seeds 11,12,13

Modes:

* ``program``: the program as a run drives it (set-up, then one call a
  document, or the train cell's checked steps), judged as a run judges it:
  the lower reading of each number;
* ``fp8``: the control, the plain reference computed one precision below
  the configuration's bfloat16 (``reference.model.fp8``), put in the
  program's place: its answers (serving) or its three steps (training)
  judged against the float32 reference; the upper reading;
* ``bf16``: the same at the configuration's own precision, a witness of
  what rounding alone does to each number;
* a fault of ``faults.py`` planted in the program (``altered_text``,
  ``frozen_state``, ``half_batch``).

Prints a JSON line a seed: the numbers and whether the cell's limits pass
them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def serve_samples(docs, conf, mix, seed: int):
    """``check_lines`` lines drawn from the seed over the documents, the
    widest among them, on their chunks' canvases."""
    import numpy as np

    from portbench.drivers.serve import batches_of

    flat = [(k, i) for k, d in enumerate(docs) for i in range(len(d))]
    rng = np.random.default_rng([seed, 4])
    pick = set(int(j) for j in rng.choice(len(flat), mix["check_lines"],
                                          replace=False))
    pick.add(max(range(len(flat)),
                 key=lambda j: docs[flat[j][0]][flat[j][1]].shape[1]))
    layout = [batches_of(d, conf["buckets"], conf["height"],
                         mix["batch_size"]) for d in docs]
    return [{"crop": docs[k][i], "bucket": layout[k][i][0],
             "canvas_hw": layout[k][i][1]}
            for k, i in (flat[j] for j in sorted(pick))]


def reading(workload: str, mode: str, seed: int, device: str = "cuda",
            mix_overrides=None, detail: bool = False) -> dict:
    import torch

    from portbench import counts, faults, harness, traffic
    from portbench.drivers import train as train_driver
    from portbench.reference import judge, model

    plan = harness.cell_plan(harness.load_benchmark(), workload)
    conf, mix = plan["conf"], dict(plan["mix"], **(mix_overrides or {}))
    dev = torch.device(device)
    classes = model.load_classes(conf, ROOT)
    if mode in ("fp8", "bf16"):
        q = getattr(model, mode)
        model.float32_exact()
        W = model.load_weights(conf, ROOT, dev)
        if mix["driver"] == "serve":
            samples = serve_samples(traffic.documents(mix, seed), conf, mix,
                                    seed)
            answers = judge.reference_answers(samples, conf, mix["decode"],
                                              W, classes, dev, q=q)
            for s, (text, score) in zip(samples, answers):
                s.update(text=text, score=score)
            numbers = judge.judge_serve(samples, conf, mix["decode"], W,
                                        classes, dev)
        else:
            n = mix["checked_steps"]
            batches = traffic.train_batches(
                mix, seed, classes, counts.downsample(conf),
                conf["ctc_time_slice"])[:n]
            seeds = [train_driver.step_seed(seed, k) for k in range(n)]
            low = model.train_steps(W, batches, seeds, conf, mix, dev, q=q)
            ref = model.train_steps(W, batches, seeds, conf, mix, dev)
            numbers = judge.judge_train(low, ref)
    else:
        import importlib

        if mode == "program":
            hooks = None
        elif mode == "altered_text":
            hooks = faults.altered_text(classes)
        else:
            hooks = faults.FAULTS[mode]()
        driver = importlib.import_module(
            f"portbench.drivers.{mix['driver']}").Driver(conf, mix, seed,
                                                         dev, hooks)
        if mix["driver"] == "serve":
            for _ in range(mix["docs"]):
                driver.call()
        driver.sync()
        driver.release()
        model.float32_exact()
        numbers = driver.check(model.load_weights(conf, ROOT, dev), classes)
    limits = plan["limits"]
    if not detail:
        numbers = {k: v for k, v in numbers.items() if not k.startswith("__")}
    return {"workload": workload, "mode": mode, "seed": seed,
            "numbers": numbers,
            "passes": all(numbers[k] <= v for k, v in limits.items())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--detail", action="store_true",
                    help="also print every leaf's gaps (training)")
    args = ap.parse_args()
    for s in args.seeds.split(","):
        t = time.perf_counter()
        out = reading(args.workload, args.mode, int(s), detail=args.detail)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
