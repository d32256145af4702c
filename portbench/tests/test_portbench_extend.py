"""A cell, a configuration, a traffic mix and a per-layer metric are added
as files and entries alone: the harness finds them by name."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness


def test_a_new_cell_is_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "fonts-hard.json").read_text())
    conf["name"] = "dummy"
    (pb / "configs" / "dummy.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "docs-mixed.json").read_text())
    mix["doc_lines"] = 32
    (pb / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "dummy-cell.json").write_text(
        json.dumps({"text_gap": 1.0}))
    (pb / "metrics" / "dummy_ms.serve.py").write_text(
        "def read(obs):\n    return obs['wall_s'] * 1e3\n")
    bench["configs"].append({"name": "dummy", "source": "https://x.y",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ms.serve", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "Device",
                               "moves": "serve_lines_per_s",
                               "workloads": ["dummy-cell"]})
    bench["end_to_end"][0]["workloads"].append("dummy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json\n"
        "from portbench import harness, traffic\n"
        "p = harness.cell_plan(harness.load_benchmark(), 'dummy-cell')\n"
        "docs = traffic.documents(dict(p['mix'], docs=1), 3)\n"
        "print(json.dumps({'conf': p['conf']['name'],\n"
        "  'lines': len(docs[0]), 'limits': p['limits'],\n"
        "  'layer': [m['name'] for m in p['per_layer']],\n"
        "  'read': harness.reader('dummy_ms.serve')({'wall_s': 2.0})}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["conf"] == "dummy" and got["lines"] == 32
    assert got["limits"] == {"text_gap": 1.0}
    assert "dummy_ms.serve" in got["layer"] and got["read"] == 2000.0
