"""Find a cell's files by the names in ``BENCHMARK.json``.

A later change adds a configuration, a traffic mix or a metric by adding
files under ``bench/`` and entries to ``BENCHMARK.json``; nothing here
names one of them:

* ``configs`` entry ``file``: a JSON object of sizes; its ``system`` key
  names ``bench/systems/<system>.py``, the driver of that kind of system;
* workload ``traffic``: ``bench/traffic/<traffic>.json``, parameters that
  the general generator (``bench/lib/traffic.py``) reads;
* every metric ``name``: ``bench/metrics/<name>.py``, whose ``read(record)``
  returns the number or ``None``.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Dict, List

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    """The Python file at ``path`` as module ``name`` (file names may hold
    dots and dashes, so they are not imported by name)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def workload(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(bench: Dict, name: str) -> Dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return {**load_json(ROOT / entry["file"]), "name": name}
    raise KeyError(f"BENCHMARK.json has no config {name!r}")


def traffic(name: str) -> Dict:
    return {**load_json(BENCH / "traffic" / f"{name}.json"), "name": name}


def system(name: str) -> ModuleType:
    return load_module(BENCH / "systems" / f"{name}.py", f"bench_system_{name}")


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")


def metrics_of(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports: those
    that list it under ``workloads``, and those with no such list."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]
