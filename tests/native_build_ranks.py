"""The process side of ``tests/test_torch_cli_train.py::
test_concurrent_native_builds_run_the_compiler_once``: load the port's
native edit distance into a given build directory and record the compiler
runs of this process (the sources of the commands that the builder hands to
``subprocess.run``). Imports numpy and ``crnn_ocr_torch.native`` only."""

from __future__ import annotations

import json
import os
import subprocess
import types


def build_worker(rank: int, build_dir: str, out: str) -> None:
    from crnn_ocr_torch import native

    builds = []

    def run(cmd, *args, **kwargs):
        builds.append(os.path.basename(cmd[-1]))
        return subprocess.run(cmd, *args, **kwargs)

    native.BUILD_DIR = build_dir
    native.subprocess = types.SimpleNamespace(run=run)
    native.load("editdistance")
    assert native.editdistance("kitten", "sitting") == 3
    with open(os.path.join(out, f"build{rank}.json"), "w") as f:
        json.dump({"builds": builds}, f)
