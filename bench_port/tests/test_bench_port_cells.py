"""BENCHMARK.json against the benchmark's contract, and every cell's parts
found by name: its workload file, configuration, mix, entry and metric
readers."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from bench_port.core import cell  # noqa: E402

B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "bench_port/run.py"] and B["paths"] == ["bench_port"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    n = len(B["workloads"])
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, n // 4)


def test_names_units_and_keys():
    names = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert all(c in CELLS for c in m.get("workloads", CELLS))
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and _line(m["layer"])
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", CELLS)) <= set(moved.get("workloads", CELLS))
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in names and next(e for e in B["end_to_end"] if e["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_exist(name):
    spec = cell.cell_spec(name)
    assert (cell.BENCH / "entries" / f"{spec['entry']}.py").exists()
    assert spec["builder"].exists()
    conf = next(c for c in B["configs"] if c["name"] == spec["config_name"])
    assert conf["file"].startswith("bench_port/") and (ROOT / conf["file"]).exists()
    assert all(k in spec["config"] for k in conf["reduced"])
    assert len([m for m in spec["end_to_end"] if m["name"] != "setup_s"]) >= 1
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"]) and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(cell.metric_reader(m["name"]))
    assert spec["check"]["limits"]


def test_every_config_is_used_once_by_file():
    files = [c["file"] for c in B["configs"]]
    assert len(set(files)) == len(files)
    assert {c["name"] for c in B["configs"]} == {w["config"] for w in B["workloads"]}
