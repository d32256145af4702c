"""One run of one cell: set-up, the measured (or traced) window, the check
of the outputs against the plain reference, and the result line.

Everything the run needs is found by name from ``BENCHMARK.json``: the
cell's configuration file (``configs/``), its traffic mix (``traffic/``,
whose ``driver`` names the loop in ``drivers/``), its per-layer readers
(``metrics/<metric>.py``, each a ``read(obs)`` returning a number or None)
and its limits (``limits/<cell>.json``). A new cell, configuration or
metric is new files and entries; nothing here changes.

The result is the last line of standard output; the numbers compared
with the reference are printed beside their limits as the last lines of
standard error and as the line's last key, ``checks``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names no run may hold: JAX, its libraries, the JAX
# package and the JAX package's own benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "crnn_ocr_tpu",
             "benchmarks")


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    """A metric is the cells its ``workloads`` lists; ``setup_s``, which
    has no such key, is every cell's."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_plan(bench: dict, cell_name: str) -> dict:
    """The cell's entry, configuration, mix, metrics and limits."""
    cell = _named(bench["workloads"], cell_name, "workload")
    entry = _named(bench["configs"], cell["config"], "config")
    with open(os.path.join(ROOT, entry["file"])) as f:
        conf = json.load(f)
    conf["_root"] = ROOT
    from portbench import traffic

    mix = traffic.load_mix(cell["traffic"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name)]
    layer = [m for m in bench["per_layer"] if _applies(m, cell_name)]
    with open(os.path.join(HERE, "limits", f"{cell_name}.json")) as f:
        limits = json.load(f)
    return {"cell": cell, "conf": conf, "mix": mix, "end_to_end": e2e,
            "per_layer": layer, "limits": limits}


def reader(name: str) -> Callable:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", hooks: Optional[dict] = None,
             mix_overrides: Optional[dict] = None) -> dict:
    """One run; returns ``{"result": line, "checks": [...]}``, or raises
    ``SystemExit`` with a message where no result may be printed.
    ``device``, ``hooks`` and ``mix_overrides`` are for the tests: a CPU
    run at a small size, with the program broken underneath."""
    import torch

    from portbench import counts, tracing
    from portbench.reference import model

    plan = cell_plan(load_benchmark(), workload)
    conf, mix = plan["conf"], dict(plan["mix"], **(mix_overrides or {}))
    chips = plan["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device == "cuda" and have < chips:
        raise SystemExit(f"{workload} needs {chips} CUDA device(s), the "
                         f"machine has {have}")
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    driver = importlib.import_module(
        f"portbench.drivers.{mix['driver']}").Driver(conf, mix, seed, dev,
                                                     hooks)
    driver.sync()
    setup_s = time.perf_counter() - t0

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": chips}
    breakdown = None
    card = card_line() if dev.type == "cuda" else "cpu"
    if trace:
        rec = tracing.Recorder()
        driver.install_spans(rec)
        n = mix.get("trace_calls", mix.get("trace_steps"))
        prof, wall = tracing.profile(
            lambda: [driver.call() for _ in range(n)], dev)
        summary = tracing.summarize(prof)
        del prof
        obs = dict(summary, **driver.traced_work(), wall_s=wall, units=n,
                   host_ms=rec.host_ms, rnn_least_s=rec.rnn_least_s,
                   peak_flops=counts.PEAK_FLOPS[conf["dtype"]], conf=conf,
                   mix=mix)
        for m in plan["per_layer"]:
            value = reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"], window_s=wall)
        breakdown = {"device_ops": [list(kv) for kv in summary["device_ops"]],
                     "idle_gaps": [list(kv) for kv in summary["idle_gaps"]]}
    else:
        window = driver.window(seconds)
        window["setup_s"] = setup_s
        for m in plan["end_to_end"]:
            if m["name"] in window:
                metrics[m["name"]] = {"value": window[m["name"]],
                                      "unit": m["unit"]}
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    attempted, failed = driver.attempted_failed()

    driver.release()
    model.float32_exact()
    weights = model.load_weights(conf, ROOT, dev)
    numbers = driver.check(weights, model.load_classes(conf, ROOT))
    limits = plan["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded forbidden modules: {found}")
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["card"] = card
    line["notes"] = {k: v for k, v in numbers.items()
                     if k not in limits and not k.startswith("__")}
    if not trace:
        line["notes"]["_quarters"] = window["_quarters"]
    line["checks"] = checks
    return {"result": line,
            "checks": [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
                       for k, c in checks.items()]}


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0)
    except SystemExit as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for ln in out["checks"]:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0
