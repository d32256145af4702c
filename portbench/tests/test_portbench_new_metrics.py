"""The readers of the STN cell's per-layer metrics on a hand-built traced
window, and None where what they read is absent (a program without the
spans, another cell, or device time on the CPU)."""

import pytest

from portbench import harness

NEW = {"stn_ms.train": "program_span",
       "stn_localize_device_ms.train": "program_span",
       "warp_launches.train": "program_counter"}


def _obs(host=None, kernel=None, **kw):
    return dict({"range_host_s": host or {}, "range_kernel_s": kernel or {},
                 "busy_s": 0.0, "units": 2}, **kw)


def _read(name, obs):
    return harness.reader(name)(obs)


def test_each_new_metric_is_declared_with_its_cell():
    bench = harness.load_benchmark()
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert {k: m["source"] for k, m in got.items()} == NEW
    for k in NEW:
        assert got[k]["workloads"] == ["train-warp-stn"]


def test_stn_spans_a_step():
    obs = _obs(host={"crnn.train.step": [0.1, 0.1],
                     "crnn.stn.localize": [0.002, 0.004],
                     "crnn.stn.warp": [0.001, 0.001]},
               kernel={"crnn.stn.localize": [0.0005, 0.0007]})
    assert _read("stn_ms.train", obs) == pytest.approx(4.0)
    assert _read("stn_localize_device_ms.train", obs) == pytest.approx(0.6)
    bare = _obs(host={"crnn.train.step": [0.1]})
    assert _read("stn_ms.train", bare) is None
    assert _read("stn_localize_device_ms.train", bare) is None
    cpu = _obs(host={"crnn.train.step": [0.1], "crnn.stn.localize": [0.1]},
               kernel={"crnn.stn.localize": [0.0]})
    assert _read("stn_localize_device_ms.train", cpu) is None


def test_warp_launches_a_step():
    assert _read("warp_launches.train", _obs(k11_launches=2,
                                             k12_launches=2)) == 2.0
    assert _read("warp_launches.train", _obs()) is None  # another driver
    assert _read("warp_launches.train",
                 _obs(k11_launches=0, k12_launches=0)) == 0.0

