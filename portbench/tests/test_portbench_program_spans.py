"""The readers of the program's spans (``program_spans.py`` and their
``metrics/`` files): the arithmetic on a hand-built traced window, None
where the spans are absent, and a CPU traced run of each cell reporting
every host-ms and count metric the cell lists."""

import time

import pytest

from portbench import harness
from portbench.tests.test_portbench_faults import SMALL

NEW = {"pack_ms.serve", "upload_ms.serve", "resize_ms.serve",
       "resize_device_ms.serve", "forward_ms.serve",
       "forward_device_ms.serve", "wait_ms.serve", "to_text_ms.serve",
       "syncs.beam", "sync_wait_ms.beam", "frame_ms.beam",
       "exact_share.beam", "upload_ms.train", "forward_device_ms.train",
       "backward_ms.train", "backward_device_ms.train", "optimizer_ms.train",
       "optimizer_device_ms.train"}


def _obs(host=None, kernel=None, busy_s=0.0):
    return {"range_host_s": host or {}, "range_kernel_s": kernel or {},
            "busy_s": busy_s}


def _read(name, obs):
    return harness.reader(name)(obs)


def test_every_new_metric_is_declared_as_a_program_span():
    bench = harness.load_benchmark()
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert set(got) == NEW
    assert all(m["source"] == "program_span" for m in got.values())


def test_serving_stages_per_call():
    obs = _obs(host={"crnn.predict": [0.010, 0.012],
                     "crnn.predict.pack": [0.001, 0.003],
                     "crnn.predict.upload": [0.002, 0.002],
                     "crnn.predict.wait": [0.004, 0.0]},
               kernel={"crnn.predict.resize": [0.0005, 0.0015],
                       "crnn.predict.forward": [0.0, 0.0]})
    assert _read("pack_ms.serve", obs) == pytest.approx(2.0)
    assert _read("upload_ms.serve", obs) == pytest.approx(2.0)
    assert _read("wait_ms.serve", obs) == pytest.approx(2.0)
    assert _read("resize_device_ms.serve", obs) == pytest.approx(1.0)
    # spans absent, or device time none (the CPU)
    for name in ("resize_ms.serve", "to_text_ms.serve", "forward_ms.serve",
                 "forward_device_ms.serve"):
        assert _read(name, obs) is None, name
    no_calls = _obs(host={"crnn.predict.pack": [0.001]})
    assert _read("pack_ms.serve", no_calls) is None


def test_beam_counts_and_shares():
    obs = _obs(host={"crnn.predict": [1.0, 1.0],
                     "crnn.beam.frame": [0.01] * 8,
                     "crnn.beam.sync": [0.002] * 11,
                     "crnn.beam.exact": [0.003] * 2})
    assert _read("syncs.beam", obs) == pytest.approx(5.5)
    assert _read("sync_wait_ms.beam", obs) == pytest.approx(11.0)
    assert _read("frame_ms.beam", obs) == pytest.approx(10.0)
    assert _read("exact_share.beam", obs) == pytest.approx(25.0)
    no_exact = _obs(host={"crnn.beam.frame": [0.01] * 4})
    assert _read("exact_share.beam", no_exact) == 0.0
    for name in ("syncs.beam", "sync_wait_ms.beam", "frame_ms.beam",
                 "exact_share.beam"):
        assert _read(name, _obs()) is None, name


def test_training_stages_per_step():
    host = {"crnn.train.step": [0.1, 0.1, 0.1, 0.1],
            "crnn.data.upload": [0.02] * 4,
            "crnn.train.backward": [0.03] * 4,
            "crnn.train.optimizer": [0.004] * 4}
    kernel = {"crnn.data.upload": [0.001] * 4,
              "crnn.data.resize": [0.002] * 4,
              "crnn.train.forward": [0.02] * 4,
              "crnn.train.loss": [0.005] * 4,
              "crnn.train.backward": [0.0] * 4,
              "crnn.train.optimizer": [0.003] * 4}
    obs = _obs(host, kernel, busy_s=0.4)
    assert _read("upload_ms.train", obs) == pytest.approx(20.0)
    assert _read("backward_ms.train", obs) == pytest.approx(30.0)
    assert _read("optimizer_ms.train", obs) == pytest.approx(4.0)
    assert _read("forward_device_ms.train", obs) == pytest.approx(25.0)
    assert _read("optimizer_device_ms.train", obs) == pytest.approx(3.0)
    # 100 busy ms a step less 1 + 2 + 20 + 5 + 3 of the other spans
    assert _read("backward_device_ms.train", obs) == pytest.approx(69.0)
    cpu = _obs(host, {k: [0.0] * 4 for k in kernel}, busy_s=0.0)
    for name in ("forward_device_ms.train", "optimizer_device_ms.train",
                 "backward_device_ms.train"):
        assert _read(name, cpu) is None, name
    for name in ("upload_ms.train", "backward_ms.train",
                 "optimizer_ms.train"):
        assert _read(name, _obs()) is None, name


@pytest.mark.parametrize("cell", ["serve-hard", "serve-hard-beam",
                                  "train-hard", "train-hard-lstm"])
def test_a_traced_cpu_run_reports_the_host_metrics(cell):
    plan = harness.cell_plan(harness.load_benchmark(), cell)
    key = "trace_steps" if cell.startswith("train") else "trace_calls"
    out = harness.run_cell(cell, 2**31 + 5, 0.3, True, time.perf_counter(),
                           device="cpu",
                           mix_overrides=dict(SMALL[cell], **{key: 2}))
    line = out["result"]
    listed = {m["name"] for m in plan["per_layer"]} & NEW
    assert listed
    for name in listed:
        if "device" in name:
            assert name not in line["metrics"], name  # no card: no reading
        else:
            assert line["metrics"][name]["value"] >= 0, name
    if cell == "serve-hard":
        got = {k: v["value"] for k, v in line["metrics"].items()}
        stages = got["pack_ms.serve"] + got["upload_ms.serve"] + \
            got["resize_ms.serve"]
        assert stages <= got["preprocess_ms.serve"]
        assert got["wait_ms.serve"] + got["to_text_ms.serve"] <= \
            got["decode_ms.serve"]
