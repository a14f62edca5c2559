"""Small cells for the benchmark's CPU tests: the real traffic mixes and
metrics over configurations cut to a few thousand vertices."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent

# tiny stand-ins for the real configuration, same keys
REAL = "graph500-s18-k3"
TINY = {
    "tiny-k3": (REAL, {"SCALE": 8, "edgefactor": 4}, {}),
    "tiny-k4": (REAL, {"SCALE": 7, "edgefactor": 2}, {"k": 4}),
}
CELLS = {"tiny-k3.recurring-count": ("tiny-k3", "recurring-count"),
         "tiny-k3.recurring-first1000": ("tiny-k3", "recurring-first1000"),
         "tiny-k4.recurring-count": ("tiny-k4", "recurring-count"),
         "tiny-k3.open-first1000": ("tiny-k3", "open-first1000")}
# each real cell's metrics go to the tiny cells of its traffic
RENAME = {f"{REAL}.{mix}": [c for c, (_, m) in CELLS.items() if m == mix]
          for mix in ("recurring-count", "recurring-first1000")}


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """``(spec, base)``: a BENCHMARK.json-shaped dict over the tiny
    cells and the folder that holds their data files and a copy of the
    metric readers."""
    base = tmp_path_factory.mktemp("tiny_cells")
    for sub in ("configs", "traffic", "workloads"):
        (base / sub).mkdir()
    for name, (real, sizes, query) in TINY.items():
        cfg = json.loads((HERE / "configs" / f"{real}.json").read_text())
        cfg["name"] = name
        cfg["graph"].update(sizes)
        cfg["query"].update(query, pool_size=8)
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for mix in {mix for _, mix in CELLS.values()}:
        shutil.copy(HERE / "traffic" / f"{mix}.json",
                    base / "traffic" / f"{mix}.json")
    shutil.copytree(HERE / "metrics", base / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (base / "workloads" / "tiny-k3.open-first1000.json").write_text(
        json.dumps({"traffic": {"rate_per_s": 200.0}}))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"] = [
        {"name": c, "config": cfg, "traffic": mix, "chips": 1, "why": "t"}
        for c, (cfg, mix) in CELLS.items()]
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            if "workloads" in m:
                m["workloads"] = [t for w in m["workloads"]
                                  for t in RENAME.get(w, [])]
    return spec, base
