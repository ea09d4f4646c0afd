"""Finding a cell's parts by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration and
traffic mix. The parts live in files of their own under `bench_port/`:

    configs/<config>.json     the sizes as run, source, reduced, assumed, init rules
    configs/<config>.py       build(sizes, seed, device) -> the program's modules
    traffic/<mix>.json        the parameters the one generator (core/traffic.py) reads
    workloads/<cell>.json     the entry, its parameters and the check's sample
    entries/<entry>.py        setup / window / check for one kind of entry
    metrics/<metric>.py       read(run) -> value or None; `<name>.py` first, else
                              the part of the name before its first dot

Nothing here names a cell, a configuration, a mix or a metric.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_module(path: Path):
    """Import a file of the benchmark by path (its name may hold '-' or '.')."""
    name = "bench_port_" + re.sub(r"\W", "_", str(path.relative_to(BENCH).with_suffix("")))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """Everything one run of cell `name` reads: its BENCHMARK.json entry, its
    workload file, its configuration's sizes and its mix, and the metric
    entries it reports."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = read_json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if work[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {work[key]!r}, BENCHMARK.json {entry[key]!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {
        "name": name,
        "chips": entry["chips"],
        "entry": work["entry"],
        "params": work.get("params", {}),
        "check": work.get("check", {}),
        "config_name": entry["config"],
        "config": read_json(ROOT / conf["file"]),
        "builder": BENCH / "configs" / f"{entry['config']}.py",
        "traffic": read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        "end_to_end": reported(bench["end_to_end"]),
        "per_layer": reported(bench["per_layer"]),
    }


def entry_module(spec: dict):
    return load_module(BENCH / "entries" / f"{spec['entry']}.py")


def builder_module(spec: dict):
    return load_module(spec["builder"])


def metric_reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path).read
    raise FileNotFoundError(f"no reader metrics/{name}.py or metrics/{name.split('.')[0]}.py")
