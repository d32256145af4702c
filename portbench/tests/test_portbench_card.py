"""On the card: one short run of each cell through the command the driver
runs, and the control at a cell's own size. Marked ``cuda``; each test
decides for itself whether there is a card, and skips without one."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (runs on the GPU machine)")


def _run(args, timeout=900):
    out = subprocess.run([sys.executable, *args], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-hard", "train-hard",
                                  "train-hard-lstm", "serve-hard-beam"])
def test_a_short_run_is_correct(cell):
    _card()
    line = json.loads(_run(["portbench/run.py", "--workload", cell,
                            "--seed", str(2**31 + 41), "--seconds", "3",
                            "--trace", "0"])[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-hard", "train-hard",
                                  "train-hard-lstm"])
def test_the_control_fails_on_the_card(cell):
    _card()
    for ln in _run(["portbench/control.py", "--workload", cell, "--mode",
                    "fp8", "--seeds", "5,6,7"]):
        assert json.loads(ln)["passes"] is False, ln
