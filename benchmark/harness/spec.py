"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: `benchmark/configs/<config>.json`;
- a traffic mix: `benchmark/traffic/<traffic>.json`, whose `driver` names
  the module in `benchmark/drivers/` that runs that kind of traffic;
- a metric: `benchmark/metrics/<name>.py`, a module with
  `read(run) -> float | None`.

A new cell or metric is a new file and a new entry; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as fh:
        return json.load(fh)


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def driver(traffic_mix: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic_mix['driver']}")


def reader(metric_name: str):
    """The module of `benchmark/metrics/<metric_name>.py` (a name may hold
    dots, so it is loaded by path)."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    with no `workloads` key, and those that list it."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]
