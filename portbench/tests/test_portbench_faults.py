"""The harness's look for a chip skipped, a run driven on the CPU at a
small size with the timed path broken underneath: ``correct`` comes out
false for every fault the cell can have. And the control (the reference
one precision below, in the program's place) fails the cell's limits."""

import time

import pytest

from portbench import control, faults, harness
from portbench.reference import model

SMALL = {"serve-hard": {"docs": 1, "doc_lines": 32, "batch_size": 16,
                        "warmup_calls": 1, "check_lines": 8},
         "serve-hard-beam": {"docs": 1, "doc_lines": 16, "batch_size": 16,
                             "warmup_calls": 1, "check_lines": 4},
         "train-hard": {"batch": 8, "pool_batches": 3},
         "train-hard-lstm": {"batch": 8, "pool_batches": 3}}


def _run(cell, hooks):
    return harness.run_cell(cell, 2**31 + 11, 0.3, False,
                            time.perf_counter(), device="cpu", hooks=hooks,
                            mix_overrides=SMALL[cell])["result"]


@pytest.mark.parametrize("cell,number", [("serve-hard", "text_gap_mean"),
                                         ("serve-hard-beam", "text_gap")])
def test_an_altered_answer_is_not_correct(cell, number):
    conf = harness.cell_plan(harness.load_benchmark(), cell)["conf"]
    hooks = faults.altered_text(model.load_classes(conf, harness.ROOT))
    out = _run(cell, hooks)
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.mark.parametrize("cell", ["train-hard", "train-hard-lstm"])
@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_a_broken_step_is_not_correct(fault, cell):
    out = _run(cell, faults.FAULTS[fault]())
    assert out["correct"] is False


@pytest.mark.parametrize("cell", ["serve-hard", "serve-hard-beam",
                                  "train-hard", "train-hard-lstm"])
def test_the_control_fails_the_limits(cell):
    got = control.reading(cell, "fp8", 2**31 + 21, device="cpu",
                          mix_overrides=SMALL[cell])
    assert got["passes"] is False, got["numbers"]
