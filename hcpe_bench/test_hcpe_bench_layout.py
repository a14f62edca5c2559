"""The benchmark's files: every cell, configuration, traffic mix and
metric is found by name, and BENCHMARK.json keeps to its contract."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from hcpe_bench import harness

HERE = Path(__file__).resolve().parent
SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["hcpe_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(len(w) <= 200 and "\t" not in w for w in SPEC["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    found = harness.find_cell(cell, SPEC)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert found.config["name"] == entry["config"]
    assert found.traffic["loop"] in ("closed", "open")
    e2e = {m["name"] for m in found.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert found.per_layer, "every cell reports a per-layer metric"
    if found.traffic["loop"] == "open":
        assert found.traffic["rate_per_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_entry(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4)
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert 1 <= len(entry["why"]) <= 200
    assert (HERE / "traffic" / f"{entry['traffic']}.json").exists()


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    path = HERE.parent / config["file"]
    assert config["file"].startswith("hcpe_bench/configs/")
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert NAME.match(key)
        assert key in data["graph"] or key in data["query"]
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_and_silent_on_nothing(metric):
    entry = next(m for m in SPEC["end_to_end"] + SPEC["per_layer"]
                 if m["name"] == metric)
    assert NAME.match(metric) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    for cell in entry.get("workloads", []):
        assert cell in CELLS
    read = harness.metric_reader(metric)
    # a run that gave the reader nothing to read gets nothing back
    assert read({"records": [], "window_s": 0.0}) is None


@pytest.mark.parametrize("metric", SPEC["end_to_end"],
                         ids=[m["name"] for m in SPEC["end_to_end"]])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_moves_an_end_to_end_metric_of_its_cells(metric):
    target = next(m for m in SPEC["end_to_end"]
                  if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in target.get("workloads", CELLS)


def test_unknown_cell_is_refused():
    with pytest.raises(ValueError):
        harness.find_cell("no-such.cell", SPEC)
