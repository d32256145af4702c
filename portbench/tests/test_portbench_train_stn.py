"""The STN cell (``train-warp-stn``, driver ``drivers/train_stn.py``) on
the CPU at a small batch: its batches follow ``traffic.train_batches``'s
rule over the STN task's lines, its traced run reads the STN's spans and
the warp's counters, and a broken step or the control (the STN's
reference one precision below the configuration's) fails its limits. A
K12 that doubles the gradient at theta fails ``warp_grad_gap`` (about 1),
which a sound run holds within bfloat16's rounding of that gradient."""

import time

import numpy as np
import pytest

from portbench import (control_stn, counts, faults, faults_stn, harness,
                       traffic)
from portbench.drivers import train_stn
from portbench.reference import model

CELL = "train-warp-stn"
SMALL = {"batch": 8, "pool_batches": 3, "trace_steps": 2}
SEED = 2**31 + 17


def _plan():
    return harness.cell_plan(harness.load_benchmark(), CELL)


def _batches(mix, conf, seed=3):
    return train_stn.warp_batches(
        mix, seed, model.load_classes(conf, harness.ROOT),
        counts.downsample(conf), conf["ctc_time_slice"])


def test_the_batches_follow_the_traffic_rule():
    plan = _plan()
    conf = plan["conf"]
    mix = dict(plan["mix"], **SMALL, lines="fonts_hard_lines.npz")
    classes = model.load_classes(conf, harness.ROOT)
    want = traffic.train_batches(mix, 3, classes, counts.downsample(conf),
                                 conf["ctc_time_slice"])
    for a, b in zip(_batches(mix, conf), want):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_the_checked_steps_take_distinct_warped_rows():
    plan = _plan()
    conf, mix = plan["conf"], dict(plan["mix"], pool_batches=3)
    rows = set()
    for b in _batches(mix, conf):
        assert b["the_input"].shape[0] == mix["batch"]
        for img_h, w, t in zip(b["heights"], b["widths"], b["texts"]):
            rows.add((t, int(img_h), int(w)))
    # 3 x 1024 rows out of the 3,136 that heights 16-64 give; a text may
    # recur across lines, so distinct (text, height, width) is a floor
    assert len(rows) >= 3 * mix["batch"] - 64


def test_the_stn_counts_its_operations():
    conf = _plan()["conf"]
    # conv 1->16 at 16x128, conv 16->32 at 8x64, Dense 4096->50, 50->6
    assert train_stn.stn_flops(conf) == (2 * 25 * 16 * 16 * 128
                                         + 2 * 25 * 16 * 32 * 8 * 64
                                         + 2 * 4096 * 50 + 2 * 50 * 6)
    assert train_stn.stn_flops(conf) == 15_155_800


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_on_the_cpu(trace):
    out = harness.run_cell(CELL, SEED, 0.3, trace, time.perf_counter(),
                           device="cpu", mix_overrides=SMALL)["result"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(_plan()["limits"])
    check = out["checks"]["warp_grad_gap"]
    assert check["value"] <= check["limit"]
    if trace:
        got = out["metrics"]
        assert got["stn_ms.train"]["value"] > 0
        # the plain sampler on the CPU: no K11 or K12 launch to count
        assert got["warp_launches.train"]["value"] == 0
        assert "stn_localize_device_ms.train" not in got  # no device time


def test_a_frozen_step_is_not_correct():
    out = harness.run_cell(CELL, SEED, 0.3, False, time.perf_counter(),
                           device="cpu", hooks=faults.frozen_state(),
                           mix_overrides=SMALL)["result"]
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == 1.0


def test_a_doubled_k12_is_not_correct():
    out = harness.run_cell(CELL, SEED, 0.3, False, time.perf_counter(),
                           device="cpu", hooks=faults_stn.k12_doubled(),
                           mix_overrides=SMALL)["result"]
    assert out["correct"] is False
    # the gradient at theta twice the reference's: a gap of 1 but for
    # bfloat16's rounding of it
    assert out["checks"]["warp_grad_gap"]["value"] == pytest.approx(1.0,
                                                                    abs=0.02)


def test_the_control_fails_the_limits():
    got = control_stn.reading(CELL, "fp8", SEED, device="cpu",
                              mix_overrides=SMALL)
    assert got["passes"] is False, got["numbers"]


def test_in_float32_the_warp_gradient_is_the_reference_warps():
    # the same operands and float32 on both sides: K11's CPU path and its
    # backward against the reference's gather-based warp, summed in
    # another order over the image's 8,192 samples
    plan = _plan()
    conf = dict(plan["conf"], dtype="float32")
    mix = dict(plan["mix"], **SMALL)
    d = train_stn.Driver(conf, mix, SEED, "cpu")
    d.release()
    warp1 = d.readings["warp1"]
    assert warp1["dtheta"].shape == (mix["batch"], 6)
    assert warp1["g"].shape == warp1["x"].shape == (mix["batch"],
                                                    conf["height"],
                                                    conf["width"])
    assert train_stn.warp_grad_gap(warp1) < 1e-5
