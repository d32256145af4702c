"""No run loads JAX, its libraries or the JAX package, nor reads the JAX
package's ``benchmarks/``; the reference imports nothing of the program.
Module names are compared by their whole top-level name (the port's name
begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from portbench import harness

DRY = """
import json, sys, time
opened = []
def audit(event, args):
    if event == "open" and isinstance(args[0], str):
        opened.append(args[0])
sys.addaudithook(audit)
from portbench import harness
out = harness.run_cell("{cell}", 2**31 + 3, 0.5, bool({trace}),
                       time.perf_counter(), device="cpu",
                       mix_overrides={overrides})
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "opened": opened, "result": out["result"]}}))
"""
SMALL = {"serve-hard": {"docs": 1, "doc_lines": 24, "batch_size": 16,
                        "warmup_calls": 1, "check_lines": 4,
                        "trace_calls": 1},
         "train-hard-lstm": {"batch": 4, "pool_batches": 3,
                             "trace_steps": 1}}


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_dry_run_loads_no_jax_and_reads_no_jax_benchmarks():
    for trace, (cell, ov) in enumerate(SMALL.items()):
        got = _run(DRY.format(cell=cell, trace=trace, overrides=ov))
        assert not set(got["modules"]) & set(harness.FORBIDDEN)
        assert "crnn_ocr_torch" in got["modules"]
        bench = os.path.join(harness.ROOT, "benchmarks") + os.sep
        assert not [p for p in got["opened"]
                    if os.path.abspath(p).startswith(bench)]
        assert got["result"]["attempted"] > 0


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json\n"
            "import portbench.reference.model, portbench.reference.judge\n"
            "import portbench.reference.ctc, portbench.reference.h5\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & ({"crnn_ocr_torch"} | set(harness.FORBIDDEN))


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "crnn_ocr_tpu_like", sys)
    assert "crnn_ocr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]
