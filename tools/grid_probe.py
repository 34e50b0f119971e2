"""Probe the 2-D grid partitioner's application on one NVIDIA H100.

    python3 tools/grid_probe.py [--runs 10] [--src DIR]

Run on a machine with the card, from the root of a checkout.  It runs the
``grid`` phase's application of ``chip_smoke.py`` (part c) ``--runs``
times: a 2 x 4 grid of processors sharing the card, processor (i, j)
running ``matmul_update`` on its (r*128) x (w*128) x 4096 bf16 block
r_ij times (r = [[1, 2, 3, 4], [4, 3, 2, 1]]), balanced by
``Scheduler(grid=..., policy=Policy.GRID2D, backend="torch").partition_grid``
at eps 0.1 over M = N = 128 units, each speed-function evaluation the
median of ``MatmulGrid.samples`` timings.  For each run it prints one JSON line:
convergence, outer iterations, inner rounds, wall seconds, the seconds
inside the speed functions (the timed blocks), and the rest of the wall
split into the device bank's ``TorchModelBank.partition_units`` and
``TorchModelBank.fold_in`` (host clock, the card drained around each call;
the columns' inner loops reach the bank through the fleet, or through
child sessions' ``SpeedStore`` in a checkout from before the fleet), the
number of those calls, and everything else; then the final partition and
the CPM partition
(one benchmark round, proportional split) each measured five times in
turns, as the imbalance and makespan medians.  The last line sums the
runs up: converged runs, and min/median/max of each number.  ``--src``
names the ``src/`` directory whose ``repro_torch`` is probed (default:
this checkout's), so an unpacked parent is measured by the same probe.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _spread(xs) -> dict:
    xs = np.asarray(xs, dtype=float)
    return {"min": float(xs.min()), "median": float(np.median(xs)), "max": float(xs.max())}


class _Timed:
    """Host seconds spent in ``TorchModelBank.partition_units`` and
    ``fold_in``, and their calls, while active, the card drained before and
    after each call."""

    def __init__(self):
        from repro_torch.core import TorchModelBank

        self.s = {"partition_units": 0.0, "fold_in": 0.0}
        self.calls = dict.fromkeys(self.s, 0)
        self._cls = TorchModelBank
        self._orig = {name: getattr(TorchModelBank, name) for name in self.s}

    def __enter__(self):
        for name, method in self._orig.items():
            def timed(bank, *args, _name=name, _method=method, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _method(bank, *args, **kwargs)
                torch.cuda.synchronize()
                self.s[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                return out
            setattr(self._cls, name, timed)
        return self

    def __exit__(self, *exc):
        for name, method in self._orig.items():
            setattr(self._cls, name, method)
        return False


def one_run(app) -> dict:
    # imported here: main() puts --src on the path first
    from repro_torch.core import Policy, Scheduler, imbalance
    from repro_torch.kernels.matmul_update import matmul_update_cuda
    from repro_torch.launch import matmul_grid as mg

    app.reset_counts()
    before = matmul_update_cuda.launches
    sched = Scheduler(grid=app.grid(), policy=Policy.GRID2D, backend="torch", device="cuda")
    with _Timed() as timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part = sched.partition_grid(mg.GRID_UNITS, mg.GRID_UNITS, eps=mg.GRID_EPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = matmul_update_cuda.launches - before
    evals, expected, eval_s = app.evals, app.expected, app.eval_s
    cpm = Scheduler(grid=app.grid(), policy=Policy.CPM, backend="torch", device="cuda").partition_grid(
        mg.GRID_UNITS, mg.GRID_UNITS
    )
    measured = {"dfpa": [], "cpm": []}
    for _ in range(5):  # in turns
        for name, pt in (("dfpa", part), ("cpm", cpm)):
            measured[name].append(app.measure(pt))
    return {
        "converged": part.converged, "final_imbalance": part.imbalance, "outer_iterations": part.iterations,
        "rounds": part.diagnostics["total_rounds"], "col_widths": part.col_widths, "row_heights": part.row_heights,
        "wall_s": wall, "speed_fn_s": eval_s, "partition_s": timed.s["partition_units"],
        "fold_in_s": timed.s["fold_in"], "partition_calls": timed.calls["partition_units"],
        "fold_in_calls": timed.calls["fold_in"],
        "other_s": wall - eval_s - timed.s["partition_units"] - timed.s["fold_in"],
        "speed_fn_evaluations": evals, "samples": app.samples, "launches": launches,
        "launches_expected": expected,
        "remeasured_imbalance_median": float(np.median([imbalance(t) for t in measured["dfpa"]])),
        "makespan_ms_median": {n: float(np.median([max(t) for t in ts])) * 1e3 for n, ts in measured.items()},
        "cpm_col_widths": cpm.col_widths, "cpm_row_heights": cpm.row_heights,
        "cpm_remeasured_imbalance_median": float(np.median([imbalance(t) for t in measured["cpm"]])),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ directory that holds repro_torch")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.launch import matmul_grid as mg
    if not torch.cuda.is_available():
        raise SystemExit("grid_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    app = mg.MatmulGrid()
    app.run(0, 0, 1, 1)  # the kernel's first use
    torch.cuda.synchronize()
    rows = []
    for i in range(args.runs):
        row = {"run": i, "card": smi, **one_run(app)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = ("outer_iterations", "rounds", "wall_s", "speed_fn_s", "partition_s", "fold_in_s", "partition_calls",
            "fold_in_calls", "other_s", "remeasured_imbalance_median")
    summary = {
        "card": smi, "src": args.src, "runs": len(rows), "converged": sum(r["converged"] for r in rows),
        "launches_match": all(r["launches"] == r["launches_expected"] for r in rows),
        **{k: _spread([r[k] for r in rows]) for k in keys},
        "makespan_ms_dfpa": _spread([r["makespan_ms_median"]["dfpa"] for r in rows]),
        "makespan_ms_cpm": _spread([r["makespan_ms_median"]["cpm"] for r in rows]),
        "cpm_remeasured_imbalance_median": _spread([r["cpm_remeasured_imbalance_median"] for r in rows]),
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
