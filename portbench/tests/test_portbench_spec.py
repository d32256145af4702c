"""BENCHMARK.json against its contract, and every cell's files found by
name."""

import json
import os
import re

import pytest

from portbench import harness, traffic

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(bench["command"]) <= 32 and all(_line(w)
                                               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_keys(bench):
    seen = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        # only the set-up time, every cell's, goes without its cells
        assert "workloads" in m or m["name"] == "setup_s"
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert "setup_s" in metric_names


def test_every_cell_reports_what_its_metrics_move(bench):
    for w in bench["workloads"]:
        plan = harness.cell_plan(bench, w["name"])
        e2e = {m["name"] for m in plan["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert plan["per_layer"]
        for m in plan["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_cell_finds_its_files_by_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, conf["weights"]))
    used = set()
    for w in bench["workloads"]:
        plan = harness.cell_plan(bench, w["name"])
        used.add(w["config"])
        assert plan["mix"]["driver"] in ("serve", "train")
        assert plan["limits"]
        assert os.path.isfile(os.path.join(
            harness.HERE, "drivers", plan["mix"]["driver"] + ".py"))
        for m in plan["per_layer"]:
            assert callable(harness.reader(m["name"]))
        assert traffic.load_mix(w["traffic"]) == plan["mix"]
    assert used == {c["name"] for c in bench["configs"]}
