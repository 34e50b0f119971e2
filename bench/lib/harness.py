"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` builds the cell's system from its configuration and traffic
(``bench/lib/loader.py`` finds both by name), times its set-up, runs the
window (under ``torch.profiler`` with ``trace``), reads the peak memory,
frees the program's state, runs the comparison with the plain reference,
and reads each metric the cell reports with the metric's own reader.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from bench.lib import loader
from bench.lib.clock import sync
from bench.lib.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, overrides: Optional[Dict] = None) -> Tuple[Dict, List[Dict]]:
    """The cell's result object (see ``bench/README.md``) and its checks
    (each compared number's ``name``, ``value``, ``limit``, ``ok`` and, where
    it has one, ``detail``); ``overrides`` (``{"config": {...}, "traffic":
    {...}}``) replace keys of the cell's files, for the tests' small sizes."""
    overrides = overrides or {}
    cell = loader.workload(bench, name)
    cfg = {**loader.config(bench, cell["config"]), **overrides.get("config", {})}
    mix = {**loader.traffic(cell["traffic"]), **overrides.get("traffic", {})}
    t_system = time.perf_counter()
    system = loader.system(cfg["system"]).System(cfg, mix, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    stages = {"before_system_s": t_system - t_start, **system.stages}
    print("bench: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr, flush=True)
    with Tracer(trace, device) as tracer:
        t0 = time.perf_counter()
        record = system.window(seconds)
        sync(device)
        window_s = time.perf_counter() - t0
    record.update(setup_s=setup_s, window_s=window_s, trace=tracer.summary())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    system.release()
    checks = system.check(record)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in loader.metrics_of(bench, name, kind):
        value = loader.metric_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["ok"] for c in checks), "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": dev}
    if record["trace"] is not None:
        dev.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["window_s"])
        result["breakdown"] = {k: record["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result, checks
