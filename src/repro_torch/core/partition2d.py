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

The algorithms live on the facade: construct ``Scheduler(grid=grid,
policy=Policy.GRID2D | CPM | FFMPA)`` and call ``partition_grid(M, N)``
(or ``repartition_grid`` for the batched no-benchmark refresh).  This module
keeps the evaluation helper :func:`app_time_2d` and the pure grid helpers
the facade shares (`_col_times`, `_rebalance_widths`, `_flat_imbalance`).
The reference's legacy ``Grid2DResult`` and its deprecated free-function
shims (``dfpa_partition_2d`` and friends) come with the port's last slice,
if at all.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

from .fpm import imbalance

__all__ = ["app_time_2d"]

SpeedFn2D = Callable[[float, float], float]  # g(m_b, n_b) -> units/s


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


def app_time_2d(
    grid: Sequence[Sequence[SpeedFn2D]],
    result,
    K: int,
    *,
    bcast_overhead: float = 1.0e-3,
) -> float:
    """Full 2-D matmul app time: K pivot steps, each costing the slowest
    processor's panel update + broadcast overhead (paper Fig. 7(a)).

    ``result`` is a grid ``Partition`` (``col_widths`` / ``row_heights``).
    """
    step = 0.0
    for j, w in enumerate(result.col_widths):
        for i, r in enumerate(result.row_heights[j]):
            if r > 0:
                step = max(step, (r * w) / grid[i][j](float(r), float(w)))
    return K * (step + bcast_overhead)
