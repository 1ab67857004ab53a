"""Finds every piece of a cell by the names in BENCHMARK.json.

A workload names a configuration (configs/<file> as BENCHMARK.json gives it)
and a traffic mix (traffic/<name>.json); the mix names its driver
(drivers/<name>.py); every metric is read by metrics/<metric name>.py.  A
later change adds a cell or a metric by adding such files and entries, and
edits none of this code.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    """The configuration's file, as it is run."""
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _module(path: str, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """drivers/<name>.py: its `Session` runs the cell's entry."""
    return _module(os.path.join(BENCH_DIR, "drivers", f"{name}.py"), f"stwo_bench_driver_{name}")


def reader(metric: str):
    """metrics/<metric>.py's `read(record)`: the metric's value, or None
    where the record holds nothing to read."""
    mod = _module(os.path.join(BENCH_DIR, "metrics", f"{metric}.py"), f"stwo_bench_metric_{metric}")
    return mod.read


def metrics_of(bench: dict, cell: str, per_layer: bool) -> list:
    """The cell's metrics of one kind: those whose `workloads` name the
    cell, and those without the key."""
    entries = bench["per_layer" if per_layer else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
