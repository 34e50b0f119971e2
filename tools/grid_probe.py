"""Probe the 2-D grid partitioner's application on one NVIDIA H100.

    python3 tools/grid_probe.py [--runs 10] [--src DIR] [--study]

Run on a machine with the card, from the root of a checkout.  It runs the
``grid`` phase's application of ``chip_smoke.py`` (part c) ``--runs``
times: a 2 x 4 grid of processors sharing the card, processor (i, j)
running ``matmul_update`` on its (r*128) x (w*128) x 4096 bf16 block
r_ij times (r = [[1, 2, 3, 4], [4, 3, 2, 1]]), balanced by
``Scheduler(grid=..., policy=Policy.GRID2D, backend="torch").partition_grid``
at eps 0.1 over M = N = 128 units, each speed-function evaluation the
median of ``MatmulGrid.samples`` timings (after ``MatmulGrid.warmup``
untimed runs, where the checkout has them).  For each run it prints one
JSON line:
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
Every run's line carries its trajectory: each outer iteration's column
widths, flat imbalance and per-column imbalance (from the scheduler's calls
of ``_flat_imbalance`` and ``_rebalance_widths``, observed, not changed);
a run that did not converge also prints its row heights and times.

``--study`` then measures what the speed functions see: (1) the spread
of each block's timings inside one evaluation and between evaluations,
(2) the bias left by what ran before (``study_noise``'s modes: each
timing alone on an idle card after another processor's block, the same
after an untimed run of the block, after an L2 flush, and as shipped),
both on the CPM partition and on the first run's, and (3) the wave
staircase of ``g(r, w)`` near the balanced rows; then
``--variant-runs`` runs of GRID2D under each measurement variant of
``make_app``.  The study needs this checkout's ``MatmulGrid``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
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


class _Trajectory:
    """Each outer iteration of GRID2D, read from the scheduler's calls of
    ``_flat_imbalance`` (the iteration's times) and ``_rebalance_widths``
    (its widths, its rows and the widths it proposes).  Both are called
    through unchanged."""

    def __init__(self):
        import repro_torch.core.scheduler as sched_mod
        from repro_torch.core import imbalance

        self._mod, self._imbalance = sched_mod, imbalance
        self.iters = []

    def __enter__(self):
        mod = self._mod
        self._orig = flat, rebalance = mod._flat_imbalance, mod._rebalance_widths

        def flat_logged(times):
            imb = flat(times)
            self.iters.append({
                "imbalance": imb, "col_imbalance": [self._imbalance(t) for t in times],
                "times_ms": [[1e3 * float(x) for x in t] for t in times],
            })
            return imb

        def rebalance_logged(widths, times, rows, N, **kw):
            out = rebalance(widths, times, rows, N, **kw)
            self.iters[-1].update(widths=list(widths), rows=[list(r) for r in rows], proposed=list(out))
            return out

        mod._flat_imbalance, mod._rebalance_widths = flat_logged, rebalance_logged
        return self

    def __exit__(self, *exc):
        self._mod._flat_imbalance, self._mod._rebalance_widths = self._orig
        return False

    def summary(self, part, full: bool) -> list:
        """Per outer iteration: widths, flat imbalance, per-column imbalance
        (and, when ``full``, rows, times and the proposed widths)."""
        out = []
        for it in self.iters:
            row = {"widths": it.get("widths", part.col_widths), "imbalance": it["imbalance"],
                   "col_imbalance": it["col_imbalance"]}
            if full:
                row.update(rows=it.get("rows", part.row_heights), times_ms=it["times_ms"],
                           proposed=it.get("proposed"))
            out.append(row)
        return out


def one_run(app) -> dict:
    # imported here: main() puts --src on the path first
    from repro_torch.core import Policy, Scheduler, imbalance
    from repro_torch.kernels.matmul_update import matmul_update_cuda
    from repro_torch.launch import matmul_grid as mg

    app.reset_counts()
    before = matmul_update_cuda.launches
    sched = Scheduler(grid=app.grid(), policy=Policy.GRID2D, backend="torch", device="cuda")
    with _Timed() as timed, _Trajectory() as traj:
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
        "trajectory": traj.summary(part, full=not part.converged),
    }


def _blocks(widths, rows) -> list:
    return [(i, j, r, w) for j, w in enumerate(widths) for i, r in enumerate(rows[j])]


def _synced_seconds(app, blk, flush=None) -> float:
    """One timing of a block alone: the card idle when it starts (the
    timing of ``MatmulGrid`` before its untimed run and back-to-back
    timings); ``flush`` is written first when given."""
    if flush is not None:
        flush.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    app.run(*blk)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def study_noise(app, widths, rows, label: str, evals: int) -> dict:
    """Each block of the partition timed ``evals`` times in each mode, the
    modes interleaved, three timings an evaluation as the speed functions
    take them: ``synced`` each timing alone on an idle card (the block
    before is another processor's), ``warm`` the same after one untimed
    run of the block, ``flush`` with 256 MB written before each timing (the
    50 MB L2 holds none of the operands), ``shipped`` as ``MatmulGrid``
    times an evaluation (one untimed run, the timings back to back)."""
    from repro_torch.core import imbalance

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    blocks = _blocks(widths, rows)
    modes = ("synced", "warm", "flush", "shipped")
    rec = {m: {b: [] for b in blocks} for m in modes}
    for _ in range(evals):
        for mode in modes:
            for blk in blocks:
                if mode == "shipped":
                    ts = app.timings(*blk, 3)
                else:
                    if mode == "warm":
                        app.run(*blk)
                    ts = [_synced_seconds(app, blk, scratch if mode == "flush" else None) for _ in range(3)]
                rec[mode][blk].append([t * 1e3 for t in ts])
    out = {"study": "noise", "partition": label, "col_widths": widths, "row_heights": rows, "evals": evals}
    medians = {}
    for mode in modes:
        per, meds = [], []
        for blk in blocks:
            x = np.asarray(rec[mode][blk])  # [evals, 3] ms
            med = np.median(x, axis=1)
            meds.append(med)
            per.append({
                "block": list(blk), "repeats": app.repeats[blk[0]][blk[1]],
                "mean_ms_by_timing": x.mean(axis=0).tolist(),
                "cv_within_evaluation": float(np.mean(x.std(axis=1) / x.mean(axis=1))),
                "cv_of_medians": float(med.std() / med.mean()), "median_ms": float(np.median(med)),
                "min_ms": float(x.min()), "max_ms": float(x.max()),
            })
        meds = np.asarray(meds)  # [blocks, evals]
        medians[mode] = np.median(meds, axis=1)
        out[mode] = {
            "blocks": per, "imbalance_of_medians": imbalance(medians[mode].tolist()),
            "imbalance_per_evaluation_round": _spread([imbalance(meds[:, e].tolist()) for e in range(evals)]),
        }
    out["bias_vs_warm"] = {m: (medians[m] / medians["warm"] - 1.0).tolist() for m in modes if m != "warm"}
    del scratch
    return out


def study_staircase(app, widths, rows, span: int = 10) -> dict:
    """``g(r, w)`` of processors (0, 0), (1, 0), (0, 1) and (1, 1) over rows
    r0 - span .. r0 + span at their column's width, each point the median
    of 5 back-to-back timings after one untimed run, beside the kernel's
    64 x 128 tiles."""
    points = []
    units = app.a.numel() // app.K // app.unit
    for i, j in ((0, 0), (1, 0), (0, 1), (1, 1)):
        w, r0 = widths[j], rows[j][i]
        for r in range(max(1, r0 - span), min(units, r0 + span) + 1):
            t = statistics.median(app.timings(i, j, r, w, 5))
            tiles = -(-r * app.unit // 64) * -(-w * app.unit // 128)
            points.append([i, j, r, w, t * 1e3, r * w / t, tiles])
    return {"study": "staircase", "columns": ["i", "j", "r", "w", "ms", "g", "tiles"], "points": points}


def make_app(mg, variant: str):
    """The application under a measurement variant: ``shipped`` as
    ``MatmulGrid`` measures, ``synced`` each timing alone on an idle card
    with no untimed run (``MatmulGrid`` before this measurement)."""
    if variant == "shipped":
        return mg.MatmulGrid()
    if variant != "synced":
        raise SystemExit(f"grid_probe: no variant {variant!r}")

    class Synced(mg.MatmulGrid):
        def timings(self, i, j, r, w, n):
            return [_synced_seconds(self, (i, j, r, w)) for _ in range(n)]

    app = Synced()
    app.warmup = 0  # no untimed runs to account for
    return app


def summarize(rows: list, smi: str, src: str, **extra) -> dict:
    keys = ("outer_iterations", "rounds", "wall_s", "speed_fn_s", "partition_s", "fold_in_s", "partition_calls",
            "fold_in_calls", "other_s", "remeasured_imbalance_median")
    return {
        "card": smi, "src": src, **extra, "runs": len(rows), "converged": sum(r["converged"] for r in rows),
        "launches_match": all(r["launches"] == r["launches_expected"] for r in rows),
        **{k: _spread([r[k] for r in rows]) for k in keys},
        "makespan_ms_dfpa": _spread([r["makespan_ms_median"]["dfpa"] for r in rows]),
        "makespan_ms_cpm": _spread([r["makespan_ms_median"]["cpm"] for r in rows]),
        "cpm_remeasured_imbalance_median": _spread([r["cpm_remeasured_imbalance_median"] for r in rows]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ directory that holds repro_torch")
    ap.add_argument("--study", action="store_true", help="the noise, bias and staircase study, then the variants")
    ap.add_argument("--evals", type=int, default=20, help="evaluations a block in the noise study")
    ap.add_argument("--variants", default="synced,shipped")
    ap.add_argument("--variant-runs", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import Policy, Scheduler
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
    if rows:
        print(json.dumps(summarize(rows, smi, args.src)), flush=True)
    if not args.study:
        return 0
    cpm = Scheduler(grid=app.grid(), policy=Policy.CPM, backend="torch", device="cuda").partition_grid(
        mg.GRID_UNITS, mg.GRID_UNITS
    )
    first = rows[0] if rows else one_run(app)
    for label, widths, heights in (("cpm", cpm.col_widths, cpm.row_heights),
                                   ("grid2d", first["col_widths"], first["row_heights"])):
        print(json.dumps({"card": smi, **study_noise(app, widths, heights, label, args.evals)}), flush=True)
    print(json.dumps({"card": smi, **study_staircase(app, first["col_widths"], first["row_heights"])}), flush=True)
    del app
    for variant in args.variants.split(","):
        vapp = make_app(mg, variant)
        vapp.run(0, 0, 1, 1)
        torch.cuda.synchronize()
        vrows = []
        for i in range(args.variant_runs):
            row = {"variant": variant, "run": i, **one_run(vapp)}
            vrows.append(row)
            print(json.dumps(row), flush=True)
        print(json.dumps(summarize(vrows, smi, args.src, variant=variant)), flush=True)
        del vapp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
