"""The paper's tables and figures on the port, through the ``Scheduler`` facade.

    python -m repro_torch.launch.paper_tables --device cuda            # on the card
    python -m repro_torch.launch.paper_tables --device cpu --only table5_2d
    python -m repro_torch.launch.paper_tables --backend numpy --out DIR

One function per artifact, each returning the CSV text that
``benchmarks/paper_tables.py`` of the reference writes, column for column
and format for format; ``sizes`` narrows the problem sizes it runs
(``SIZES`` holds the paper's):

  Table 2 — DFPA-based vs FFMPA-based app time (1-D matmul, HCL cluster)
  Table 3 — eps = 10% vs 2.5%
  Table 4 — Grid5000: 28 nodes, <= 3 iterations, < 1% cost; a 512-group fleet
  Fig. 6  — n=5120 convergence trace (borderline paging)
  Table 5 — 2-D DFPA cost fractions
  Fig. 10 — CPM vs DFPA vs FFMPA 2-D app performance

The 1-D artifacts run ``Scheduler.autotune`` (DFPA) and
``Scheduler.partition`` over full analytic models (FFMPA); the 2-D ones run
``Scheduler.partition_grid`` under ``GRID2D``, ``CPM`` and ``FFMPA``.  The
bank lives where ``backend``/``device`` say: ``backend="torch"`` puts every
DFPA bank, fold and partition on ``device`` (default the card),
``backend="numpy"`` keeps them on the host; FFMPA's analytic models take
the scalar host path on either backend, as in the reference.  The times are produced by the
calibrated simulator (``core/simulator.py``): the seconds in the CSVs are
simulated seconds of the paper's clusters, not times of the device that
ran the partitioner.  The CLI prints each artifact's CSV and, on stderr,
the wall seconds it took on this host and device.
"""

from __future__ import annotations

import argparse
import io
import pathlib
import sys
import time
from typing import Callable, Dict

import numpy as np

from ..core.executor import SimulatedExecutor
from ..core.fpm import AnalyticModel, imbalance
from ..core.modelbank_torch import resolve_device
from ..core.partition2d import app_time_2d
from ..core.scheduler import Policy, Scheduler
from ..core.simulator import (
    HCL_SPECS,
    full_model_build_cost,
    make_grid5000_time_fns,
    make_hcl_time_fns,
    matmul_app_time_1d,
    speed_fn_2d,
)

__all__ = [
    "SIZES",
    "TABLES",
    "fig10_compare",
    "fig6_convergence",
    "hcl_grid",
    "main",
    "table2_dfpa_cost",
    "table3_epsilon",
    "table4_scale",
    "table5_2d",
]

HCL_SIZES = [2048, 3072, 4096, 5120, 6144, 7168, 8192]
GRID5000_SIZES = [7168, 10240, 12288]
FIG6_SIZES = [5120]  # the borderline-paging size of the paper's trace
GRID_SIZES = [256, 384, 512, 768]


def _row_fns(tfns, n):
    return [(lambda tf: lambda r: tf(r * n))(tf) for tf in tfns]


def _dfpa(ex, n, eps, backend, device, **kw):
    """The paper's loop, cold, as the reference's ``dfpa()`` runs it."""
    return Scheduler(policy=Policy.DFPA, backend=backend, device=device).autotune(
        ex, n, eps, min_units=1, **kw
    )


def table2_dfpa_cost(backend: str = "torch", device="cuda", sizes=HCL_SIZES) -> str:
    """Table 2: FFMPA-app vs DFPA-app times; DFPA cost and iterations."""
    out = io.StringIO()
    out.write("n,ffmpa_app_s,dfpa_app_total_s,ratio,dfpa_cost_s,dfpa_iters\n")
    for n in sizes:
        _, tfns = make_hcl_time_fns(n)
        rows = _row_fns(tfns, n)
        ffmpa_d = Scheduler.from_models(
            [AnalyticModel(tf) for tf in rows], policy=Policy.FFMPA, backend=backend, device=device,
        ).partition(n, min_units=1).allocations
        t_ffmpa = matmul_app_time_1d(tfns, ffmpa_d, n)
        ex = SimulatedExecutor(time_fns=rows)
        res = _dfpa(ex, n, 0.025, backend, device)
        t_dfpa = matmul_app_time_1d(tfns, res.allocations, n) + ex.total_cost
        out.write(
            f"{n},{t_ffmpa:.2f},{t_dfpa:.2f},{t_dfpa / t_ffmpa:.3f},"
            f"{ex.total_cost:.2f},{res.iterations}\n"
        )
    # the paper's headline: full-model construction cost vs DFPA cost
    build = full_model_build_cost(
        lambda nn: make_hcl_time_fns(nn)[1],
        [1024 * k for k in range(1, 9)],
        [i / 80 for i in range(1, 21)],
    )
    out.write(f"full_model_build_s,{build:.0f},,,,\n")
    return out.getvalue()


def table3_epsilon(backend: str = "torch", device="cuda", sizes=HCL_SIZES) -> str:
    """Table 3: eps = 10% vs 2.5% — iterations grow mildly, cost barely."""
    out = io.StringIO()
    out.write("n,eps,matmul_s,dfpa_cost_s,dfpa_iters,imbalance\n")
    for n in sizes:
        for eps in (0.10, 0.025):
            _, tfns = make_hcl_time_fns(n)
            ex = SimulatedExecutor(time_fns=_row_fns(tfns, n))
            res = _dfpa(ex, n, eps, backend, device)
            app = matmul_app_time_1d(tfns, res.allocations, n)
            out.write(
                f"{n},{eps},{app:.2f},{ex.total_cost:.2f},{res.iterations},{res.imbalance:.4f}\n"
            )
    return out.getvalue()


def _fleet512_time_fns():
    """512 heterogeneous groups, speeds spread 3x, with capacity knees."""
    rng = np.random.default_rng(42)
    speeds = rng.uniform(1.0, 3.0, 512)
    knees = rng.integers(24, 64, 512)

    def gfn(i):
        def t(x):
            base = x / speeds[i]
            if x > knees[i]:
                base += (x - knees[i]) ** 1.5 / speeds[i]
            return base

        return t

    return [gfn(i) for i in range(512)]


def table4_scale(backend: str = "torch", device="cuda", sizes=GRID5000_SIZES) -> str:
    """Table 4: Grid5000 (28 heterogeneous nodes) + a 512-group fleet."""
    out = io.StringIO()
    out.write("cluster,n,matmul_s,dfpa_cost_s,dfpa_iters,cost_pct\n")
    for n in sizes:
        for eps in (0.10, 0.025):
            _, tfns = make_grid5000_time_fns(n)
            ex = SimulatedExecutor(time_fns=_row_fns(tfns, n))
            res = _dfpa(ex, n, eps, backend, device)
            app = matmul_app_time_1d(tfns, res.allocations, n)
            out.write(
                f"grid5000-eps{eps},{n},{app:.2f},{ex.total_cost:.3f},"
                f"{res.iterations},{100 * ex.total_cost / (app + ex.total_cost):.2f}\n"
            )
    ex = SimulatedExecutor(time_fns=_fleet512_time_fns())
    res = _dfpa(ex, 512 * 32, 0.1, backend, device, max_iter=40)
    out.write(
        f"fleet512,{512 * 32},,{ex.total_cost:.3f},{res.iterations},"
        f"imb={res.imbalance:.3f}\n"
    )
    return out.getvalue()


def fig6_convergence(backend: str = "torch", device="cuda", sizes=FIG6_SIZES) -> str:
    """Fig. 6: per-iteration trace at n=5120 (borderline paging nodes)."""
    out = io.StringIO()
    out.write("iter,imbalance,d_min,d_max,t_max_s\n")
    for n in sizes:
        _, tfns = make_hcl_time_fns(n)
        ex = SimulatedExecutor(time_fns=_row_fns(tfns, n))
        res = _dfpa(ex, n, 0.025, backend, device)
        for i, (d, t) in enumerate(res.diagnostics["history"]):
            out.write(f"{i + 1},{imbalance(t):.4f},{min(d)},{max(d)},{max(t):.4f}\n")
    return out.getvalue()


def hcl_grid(p: int = 4, q: int = 4, b: int = 32):
    """The 2-D experiments' ``p x q`` grid of HCL speed functions."""
    specs = (HCL_SPECS * 2)[: p * q]
    return [[speed_fn_2d(specs[i * q + j], b) for j in range(q)] for i in range(p)]


def _grid_part(grid, policy, n, backend, device, **kw):
    return Scheduler(grid=grid, policy=policy, backend=backend, device=device).partition_grid(n, n, **kw)


def table5_2d(backend: str = "torch", device="cuda", sizes=GRID_SIZES) -> str:
    """Table 5: DFPA-based 2-D matmul cost fractions vs problem size."""
    out = io.StringIO()
    out.write("M=N,total_s,dfpa_cost_s,rounds,matmul_s,cost_pct\n")
    for n in sizes:
        grid = hcl_grid(4, 4)
        res = _grid_part(grid, Policy.GRID2D, n, backend, device, eps=0.1)
        cost = res.diagnostics["bench_cost"]
        app = app_time_2d(grid, res, K=n)
        out.write(
            f"{n},{app + cost:.2f},{cost:.2f},"
            f"{res.diagnostics['total_rounds']},{app:.2f},{100 * cost / (app + cost):.1f}\n"
        )
    return out.getvalue()


def fig10_compare(backend: str = "torch", device="cuda", sizes=GRID_SIZES) -> str:
    """Fig. 10: CPM vs DFPA vs FFMPA 2-D matmul (speed = 1/app-time)."""
    out = io.StringIO()
    out.write("M=N,cpm_total_s,dfpa_total_s,ffmpa_total_s,cpm_vs_dfpa_slowdown\n")
    for n in sizes:
        grid = hcl_grid(4, 4)
        cpm = _grid_part(grid, Policy.CPM, n, backend, device)
        dfpa_res = _grid_part(grid, Policy.GRID2D, n, backend, device, eps=0.1)
        ff = _grid_part(grid, Policy.FFMPA, n, backend, device, eps=0.1, max_outer=50)
        t_cpm = app_time_2d(grid, cpm, K=n) + cpm.diagnostics["bench_cost"]
        t_dfpa = app_time_2d(grid, dfpa_res, K=n) + dfpa_res.diagnostics["bench_cost"]
        t_ff = app_time_2d(grid, ff, K=n)
        out.write(
            f"{n},{t_cpm:.2f},{t_dfpa:.2f},{t_ff:.2f},{t_cpm / t_dfpa:.2f}\n"
        )
    return out.getvalue()


SIZES: Dict[str, list] = {
    "table2_dfpa_cost": HCL_SIZES,
    "table3_epsilon": HCL_SIZES,
    "table4_scale": GRID5000_SIZES,
    "fig6_convergence": FIG6_SIZES,
    "table5_2d": GRID_SIZES,
    "fig10_compare": GRID_SIZES,
}

TABLES: Dict[str, Callable[..., str]] = {
    "table2_dfpa_cost": table2_dfpa_cost,
    "table3_epsilon": table3_epsilon,
    "table4_scale": table4_scale,
    "fig6_convergence": fig6_convergence,
    "table5_2d": table5_2d,
    "fig10_compare": fig10_compare,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="torch", choices=("torch", "numpy"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", nargs="*", choices=sorted(TABLES), help="artifacts to run (default: all)")
    ap.add_argument("--out", type=pathlib.Path, help="also write <artifact>.csv files here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device) if args.backend == "torch" else args.device
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    for name in args.only or list(TABLES):
        t0 = time.perf_counter()
        csv = TABLES[name](backend=args.backend, device=device)
        wall = time.perf_counter() - t0
        print(f"# {name} (simulated seconds; backend {args.backend}, device {device})")
        print(csv, end="")
        print(f"{name}: {wall:.3f} s wall on this host and device", file=sys.stderr)
        if args.out is not None:
            (args.out / f"{name}.csv").write_text(csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
