"""Probe the fleet's pipelined serving cycle on one NVIDIA H100.

    python3 tools/fleet_pipeline_probe.py [--runs 2]

Run on a machine with the card, from the root of a checkout.  It runs
``chip_smoke.py``'s ``fleet`` phase part (d) serving cycle ``--runs``
times: make_tenants' q = 16 tenants on p = 1000 processors, warm banks,
``rebalance()`` then ``observe()`` each epoch, sync beside
``pipeline=True`` at depth 1 and 0, under exact times and under 2 % noise,
and depth 1 once more with the deferred partition run eagerly
(``modelbank_torch.GRAPH_DEFERRED = False``) instead of replayed as a CUDA
graph.  Each run prints one JSON line (the part's own: epoch walls,
rebalance and observe host ms, every pre-dispatched partition's host and
device ms, the counters, the gates); the last line gives min/median/max
over the runs of each configuration's median epoch and of its replayed
pre-dispatches' host and device ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _spread(xs) -> dict:
    xs = np.asarray(xs, dtype=float)
    return {"min": float(xs.min()), "median": float(np.median(xs)), "max": float(xs.max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(smoke.nvidia_smi(), flush=True)
    summary = {}
    for run in range(args.runs):
        row = smoke._fleet_pipeline_serving(eager=True)
        print(json.dumps({"run": run, **row}), flush=True)
        for label in ("exact", "noise_2pct"):
            for mode, r in row[label].items():
                s = summary.setdefault(f"{label}.{mode}", {"epoch_ms": [], "predispatch_host_ms": [],
                                                          "predispatch_device_ms": []})
                s["epoch_ms"].append(r["epoch_ms_median"])
                timed = slice(smoke.FLEET_SERVE_WARMUP, None)  # the shape's replays
                s["predispatch_host_ms"] += r["predispatch"]["host_ms"][timed]
                s["predispatch_device_ms"] += r["predispatch"]["device_ms"][timed]
    print(json.dumps({"summary": {k: {m: _spread(v) for m, v in s.items() if v} for k, s in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
