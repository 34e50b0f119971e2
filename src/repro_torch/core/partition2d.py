"""Nested 2-D partitioning (paper §3.2): the grid helpers and the result type.

The 2-D heterogeneous matmul distributes an ``M x N`` block matrix over a
``p x q`` processor grid: column widths ``n_j`` (outer) and per-column row
heights ``m_ij`` (inner).  The paper's DFPA-based algorithm:

  1. start even: ``n_j = N/q``, ``m_ij = M/p``;
  2. for each column j IN PARALLEL, run DFPA on the column's rows (this
     *estimates a 1-D projection of the 2-D FPM* at width ``n_j``);
  3. if the global imbalance <= eps -> done; else set
     ``n_j ∝ sum_i s_ij(m_ij, n_j)`` (column width proportional to the
     column's speed sum) and goto 2.

.. deprecated::
    The algorithms live on the facade: construct ``Scheduler(grid=grid,
    policy=Policy.GRID2D | CPM | FFMPA)`` and call ``partition_grid(M, N)``
    (or ``repartition_grid`` for the batched no-benchmark refresh).  The
    functions below are thin shims, as in the reference: they emit
    ``DeprecationWarning``, delegate to the facade and repack the typed
    ``Partition`` into the legacy :class:`Grid2DResult`.  ``backend`` is
    ``"numpy"`` (the reference's default) or ``"torch"`` (on ``device``).

This module keeps the result dataclass, the evaluation helper
:func:`app_time_2d`, and the pure grid helpers the facade shares
(`_col_times`, `_rebalance_widths`, `_flat_imbalance`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from .fpm import PiecewiseLinearFPM, imbalance

__all__ = [
    "Grid2DResult",
    "bank_repartition_2d",
    "dfpa_partition_2d",
    "cpm_partition_2d",
    "ffmpa_partition_2d",
    "app_time_2d",
]

SpeedFn2D = Callable[[float, float], float]  # g(m_b, n_b) -> units/s


@dataclass
class Grid2DResult:
    col_widths: List[int]  # n_j, len q
    row_heights: List[List[int]]  # m[j][i], q x p
    outer_iterations: int
    total_rounds: int  # total DFPA parallel rounds across all columns
    bench_cost: float  # wall-clock spent benchmarking (parallel-round model)
    converged: bool
    imbalance: float
    times: List[List[float]] = field(default_factory=list)  # t[j][i]


def _col_times(
    grid: Sequence[Sequence[SpeedFn2D]], j: int, widths: Sequence[int], rows: Sequence[int]
) -> List[float]:
    w = widths[j]
    return [
        (r * w) / grid[i][j](float(r), float(w)) if r > 0 else 0.0
        for i, r in enumerate(rows)
    ]


def _flat_imbalance(times: List[List[float]]) -> float:
    # imbalance() ignores zero-allocation entries itself.
    return imbalance([t for col in times for t in col])


def _rebalance_widths(widths: List[int], times: List[List[float]], rows, N: int, *, damp: float = 0.5) -> List[int]:
    """Outer step (ii): widths ∝ column speed sums, RELAXED by ``damp`` —
    the undamped update oscillates when speeds bend with the allocation
    (paging/nonlinear regions)."""
    q = len(widths)
    col_speed = []
    for j in range(q):
        s = sum(
            (rows[j][i] * widths[j]) / times[j][i]
            for i in range(len(rows[j]))
            if times[j][i] > 0
        )
        col_speed.append(s)
    tot = sum(col_speed)
    target = [N * s / tot for s in col_speed]
    blended = [
        (1.0 - damp) * w + damp * t for w, t in zip(widths, target)
    ]
    new_widths = [max(int(round(b)), 1) for b in blended]
    diff = N - sum(new_widths)
    order = sorted(range(q), key=lambda j: blended[j] - new_widths[j], reverse=(diff > 0))
    k = 0
    while diff != 0:
        j = order[k % q]
        step = 1 if diff > 0 else -1
        if new_widths[j] + step >= 1:
            new_widths[j] += step
            diff -= step
        k += 1
    return new_widths


def _to_grid2d(part) -> Grid2DResult:
    """Repack a facade ``Partition`` into the legacy result type."""
    diag = part.diagnostics
    return Grid2DResult(
        col_widths=list(part.col_widths),
        row_heights=[list(r) for r in part.row_heights],
        outer_iterations=part.iterations,
        total_rounds=diag.get("total_rounds", 0),
        bench_cost=diag.get("bench_cost", 0.0),
        converged=part.converged,
        imbalance=part.imbalance,
        times=[list(t) for t in diag.get("times", [])],
    )


def _check_backend(backend: str) -> None:
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}")


def bank_repartition_2d(
    fpms: Sequence[Sequence[PiecewiseLinearFPM]],
    fpm_width: Sequence[Sequence[Optional[int]]],
    widths: Sequence[int],
    M: int,
    *,
    min_units: int = 1,
    backend: str = "numpy",
    device="cuda",
) -> List[List[int]]:
    """Re-partition EVERY column's rows from the surviving FPM estimates in
    one call — no new benchmarks.

    .. deprecated:: use ``Scheduler.repartition_grid``.
    """
    from .scheduler import Policy, Scheduler
    from .speedstore import _warn_legacy

    _warn_legacy("bank_repartition_2d()", "Scheduler.repartition_grid()")
    _check_backend(backend)
    sched = Scheduler(policy=Policy.GRID2D, backend=backend, device=device)
    return sched.repartition_grid(fpms, fpm_width, widths, M, min_units=min_units)


def dfpa_partition_2d(
    grid: Sequence[Sequence[SpeedFn2D]],
    M: int,
    N: int,
    eps: float,
    *,
    max_outer: int = 40,
    inner_max_iter: int = 15,
    width_tol: float = 0.02,
    min_units: int = 1,
    backend: str = "numpy",
    device="cuda",
) -> Grid2DResult:
    """DFPA-based nested 2-D partitioning over ground-truth speeds ``grid``.

    .. deprecated:: use ``Scheduler(grid=grid, policy=Policy.GRID2D)
       .partition_grid(M, N, eps=...)``.
    """
    from .scheduler import Policy, Scheduler
    from .speedstore import _warn_legacy

    _warn_legacy("dfpa_partition_2d()", "Scheduler.partition_grid()")
    _check_backend(backend)
    sched = Scheduler(grid=grid, policy=Policy.GRID2D, backend=backend, device=device)
    part = sched.partition_grid(
        M, N, eps=eps, max_outer=max_outer, inner_max_iter=inner_max_iter,
        width_tol=width_tol, min_units=min_units,
    )
    return _to_grid2d(part)


def cpm_partition_2d(
    grid: Sequence[Sequence[SpeedFn2D]], M: int, N: int, *, backend: str = "numpy", device="cuda"
) -> Tuple[Grid2DResult, float]:
    """The conventional baseline: ONE benchmark round at the even distribution
    gives each processor a speed constant; rows/columns split proportionally.
    Returns (result, bench_cost).

    .. deprecated:: use ``Scheduler(grid=grid, policy=Policy.CPM)
       .partition_grid(M, N)``.
    """
    from .scheduler import Policy, Scheduler
    from .speedstore import _warn_legacy

    _warn_legacy("cpm_partition_2d()", "Scheduler.partition_grid()")
    _check_backend(backend)
    part = Scheduler(grid=grid, policy=Policy.CPM, backend=backend, device=device).partition_grid(M, N)
    res = _to_grid2d(part)
    return res, res.bench_cost


def ffmpa_partition_2d(
    grid: Sequence[Sequence[SpeedFn2D]],
    M: int,
    N: int,
    eps: float,
    *,
    max_outer: int = 50,
    backend: str = "numpy",
    device="cuda",
) -> Grid2DResult:
    """FFMPA baseline [18]: the FULL models are given (pre-built), so the
    nested iteration runs entirely on the host with zero benchmark cost.

    .. deprecated:: use ``Scheduler(grid=grid, policy=Policy.FFMPA)
       .partition_grid(M, N, eps=...)``.
    """
    from .scheduler import Policy, Scheduler
    from .speedstore import _warn_legacy

    _warn_legacy("ffmpa_partition_2d()", "Scheduler.partition_grid()")
    _check_backend(backend)
    part = Scheduler(grid=grid, policy=Policy.FFMPA, backend=backend, device=device).partition_grid(
        M, N, eps=eps, max_outer=max_outer
    )
    return _to_grid2d(part)


def app_time_2d(
    grid: Sequence[Sequence[SpeedFn2D]],
    result,
    K: int,
    *,
    bcast_overhead: float = 1.0e-3,
) -> float:
    """Full 2-D matmul app time: K pivot steps, each costing the slowest
    processor's panel update + broadcast overhead (paper Fig. 7(a)).

    Accepts either the legacy :class:`Grid2DResult` or a facade
    ``Partition`` — both expose ``col_widths`` / ``row_heights``.
    """
    step = 0.0
    for j, w in enumerate(result.col_widths):
        for i, r in enumerate(result.row_heights[j]):
            if r > 0:
                step = max(step, (r * w) / grid[i][j](float(r), float(w)))
    return K * (step + bcast_overhead)
