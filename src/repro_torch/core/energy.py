"""Bi-objective time/energy partitioning: Pareto fronts over FPM banks.

The source paper's FPMs model only speed; the same group's follow-up
(*Bi-objective Optimisation of Data-parallel Applications on Heterogeneous
Platforms for Performance and Energy*, Khaleghzadeh et al.) extends the
framework with per-processor *energy* functions of problem size.  This
module adds that second objective on top of the existing bank machinery —
deliberately reusing the partition kernels rather than growing new ones:

* **Energy banks are speed banks.**  An energy model is stored as an
  *energy-rate* function ``er_i(x) = x / E_i(x)`` (units per joule) in a
  second :class:`~.modelbank.ModelBank` / ``TorchModelBank`` with the
  identical padded ``[p, k]`` layout, so
  ``energy_bank.time(x) == E_i(x)`` and every existing bank program —
  fold-in, stacking, monotone flags, the ``t*`` bisection, the
  threshold-count completion — applies verbatim.  Build rate models from
  measured ``(x, energy)`` samples with :func:`energy_model`.

* **The energy objective is the same geometric solve.**
  ``objective="energy"`` runs the equal-point bisection on the energy bank:
  it balances the *per-processor* energies (min-max energy), exactly as the
  time objective balances per-processor times.  The *fleet* (total) energy
  ``sum_i E_i(d_i)`` is what a power cap constrains; the front below
  reports totals, and dominated sweep points are filtered, so the reported
  front is always a valid (time, total-energy) trade-off curve.

* **The Pareto front is a batched sweep of time-threshold bisections.**
  Between the two pure solutions (time-optimal and energy-optimal), each
  front candidate fixes a makespan threshold ``t`` and solves the
  *energy-balanced partition subject to finishing by ~t*: per-processor
  caps are tightened to ``min(cap_i, floor(alloc_time_i(t)))`` — the
  count-under-threshold expression of the threshold completion — and the
  energy bank is partitioned under those caps.  On the torch backend all
  interior thresholds solve as ONE stacked ``[T, p, k]`` program on the
  device bank (the stacked-lane shape of ``Scheduler.repartition_grid``);
  on numpy they run through the same host program per threshold.  The
  thresholds, tightened caps, and all front metrics are computed host-side
  in float64 from the scalar estimates, so numpy and torch produce
  bit-identical fronts (the device bank's float64 bit-identity contract,
  lane by lane).

The endpoints of the front are the pure solutions **by construction** —
index 0 is exactly ``objective="time"``'s partition and index -1 exactly
``objective="energy"``'s.
In the degenerate case where the energy-balanced solve does not reduce
total energy below the time-optimal point's, the front collapses to the
single time-optimal point (there is no trade-off to expose).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .fpm import PiecewiseLinearFPM
from .modelbank import ModelBank, _alloc_at_times
from .modelbank_torch import TorchModelBank
from .partition import _partition_units_bank, _partition_units_scalar

__all__ = [
    "ParetoFront",
    "pareto_front",
    "capped_energy_partition",
    "energy_model",
]


def energy_model(points: Sequence[Tuple[float, float]]) -> PiecewiseLinearFPM:
    """Build an energy-rate FPM from measured ``(x, energy)`` samples.

    The returned model stores ``er(x) = x / E(x)``, so banking it and
    calling ``time(x)`` returns the energy ``E(x)`` — the representation
    trick that lets the whole speed-bank stack serve energy unchanged.
    Energies must be positive; sizes must be positive.
    """
    pts = []
    for x, e in points:
        x, e = float(x), float(e)
        if x <= 0.0 or e <= 0.0:
            raise ValueError(f"energy samples need x > 0 and energy > 0 (got {(x, e)})")
        pts.append((x, x / e))
    return PiecewiseLinearFPM.from_points(pts)


@dataclass
class ParetoFront:
    """A makespan/total-energy trade-off curve of integer partitions.

    ``times`` is strictly increasing and ``energies`` strictly decreasing
    (both float64; dominated sweep points are filtered at construction), so
    ``allocations[0]`` is the pure time-optimal partition and
    ``allocations[-1]`` the pure energy-balanced one.  A single-point front
    means the two objectives agree (no trade-off).
    """

    times: np.ndarray        # [F] predicted makespans, strictly increasing
    energies: np.ndarray     # [F] predicted total fleet energies, strictly decreasing
    allocations: np.ndarray  # [F, p] int64 partitions

    def __len__(self) -> int:
        return int(self.times.shape[0])

    def knee(self) -> int:
        """Index of the knee point: the front point closest (in the
        normalized (time, energy) square) to the utopia corner — the
        default pick when no energy budget is given."""
        f = len(self)
        if f <= 2:
            return 0
        t, e = self.times, self.energies
        tn = (t - t[0]) / (t[-1] - t[0]) if t[-1] > t[0] else np.zeros(f)
        en = (e - e[-1]) / (e[0] - e[-1]) if e[0] > e[-1] else np.zeros(f)
        return int(np.argmin(tn + en))

    def pick(self, energy_cap: Optional[float] = None) -> int:
        """Select a front index: with ``energy_cap`` the *fastest* point
        whose total energy fits the budget; without, the :meth:`knee`.
        An unattainable cap (below the front's minimum energy) returns the
        minimum-energy endpoint — best effort, still over budget; callers
        enforcing a hard budget must check ``energies[idx]``."""
        if energy_cap is None:
            return self.knee()
        cap = float(energy_cap)
        feasible = np.flatnonzero(self.energies <= cap)
        if feasible.size == 0:
            return len(self) - 1
        return int(feasible[0])  # times ascend: first feasible is fastest

    def as_dict(self) -> dict:
        """JSON-friendly view."""
        return {
            "times": [float(v) for v in self.times],
            "energies": [float(v) for v in self.energies],
            "allocations": [[int(v) for v in row] for row in self.allocations],
        }


def _active_max(vals: np.ndarray, d: Sequence[int]) -> float:
    """Max over processors with units (the makespan/peak convention used by
    Scheduler._flat_result: zero-allocation rows are ignored)."""
    out = [float(v) for v, di in zip(vals, d) if di > 0 and np.isfinite(v)]
    return max(out) if out else 0.0


def _total(vals: np.ndarray, d: Sequence[int]) -> float:
    """Total over processors with units (left-to-right float64 sum — the
    fixed reduction order that keeps numpy/torch front metrics
    bit-identical)."""
    out = 0.0
    for v, di in zip(vals, d):
        if di > 0 and np.isfinite(v):
            out += float(v)
    return out


def _stacked_energy_partition(tbank, caps_t, n, min_units, completion):
    """All interior thresholds' energy solves as ONE stacked [T, p, k]
    program: the energy bank broadcast along the threshold axis, per-lane
    caps carrying the tightened time caps — the stacked-lane shape of the
    grid partitioner's ``repartition_grid``.

    The broadcast is ``expand``: stride-0 views of the one bank, no copy.
    The partition programs only read ``xs``/``ss``/``counts`` (no fold, no
    in-place op), so the shared storage is never written."""
    T, p = caps_t.shape
    k = int(tbank.xs.shape[-1])
    flag = tbank.is_monotone()
    stacked = TorchModelBank(
        xs=tbank.xs.expand(T, p, k),
        ss=tbank.ss.expand(T, p, k),
        counts=tbank.counts.expand(T, p),
        max_count=tbank._max_count_bound(),
        empty_rows=np.broadcast_to(tbank._empty_rows_host(), (T, p)),
        monotone=flag,
        monotone_cols=np.full((T,), flag, dtype=bool),
    )
    d = stacked.partition_units(
        np.full(T, int(n), dtype=np.int64),
        caps_t,
        min_units=np.full(T, int(min_units), dtype=np.int64),
        completion=completion,
    )
    return [[int(v) for v in row] for row in d]


def pareto_front(
    store,
    energy,
    n: int,
    icaps: Sequence[int],
    *,
    min_units: int = 0,
    num_points: int = 17,
    completion: str = "auto",
) -> ParetoFront:
    """Compute the makespan/total-energy Pareto front (see module docstring).

    ``store`` / ``energy`` are SpeedStore-protocol objects over the same
    ``p`` processors and backend: ``store`` holds the speed models,
    ``energy`` the energy-rate models.  ``icaps`` must already be prepared
    per-processor integer caps (``_prep_unit_caps`` output).  ``num_points``
    bounds the sweep size (endpoints + up to ``num_points - 2`` interior
    thresholds, geometrically spaced between the pure solutions' makespans);
    dominated candidates are filtered, so the front may be smaller.
    """
    p = store.p
    icaps_arr = np.asarray(icaps, dtype=np.int64)
    scalar = store.backend == "scalar"
    if scalar:
        times_of = lambda d: store.times([float(v) for v in d])
        etimes_of = lambda d: energy.times([float(v) for v in d])
    else:
        sbank, ebank = store.bank(), energy.bank()
        times_of = lambda d: sbank.time([float(v) for v in d])
        etimes_of = lambda d: ebank.time([float(v) for v in d])

    # Endpoints: the pure solutions, via the store's own partition dispatch
    # (bit-identical to objective="time"/"energy" by construction).
    d_time, _ = store.partition(n, list(icaps_arr), min_units=min_units, completion=completion)
    d_energy, _ = energy.partition(n, list(icaps_arr), min_units=min_units, completion=completion)
    d_time_arr = np.asarray(d_time, dtype=np.int64)
    t_lo = _active_max(times_of(d_time), d_time)
    e_lo = _total(etimes_of(d_time), d_time)
    t_hi = _active_max(times_of(d_energy), d_energy)
    e_hi = _total(etimes_of(d_energy), d_energy)

    def _front(points):
        times, energies, allocs = zip(*points)
        return ParetoFront(
            times=np.asarray(times, dtype=np.float64),
            energies=np.asarray(energies, dtype=np.float64),
            allocations=np.asarray(allocs, dtype=np.int64),
        )

    # Degenerate: no trade-off to expose (identical partitions, a zero-work
    # job, or an energy solve that does not beat the time point on total
    # energy) — the front is the single time-optimal point.
    if (
        t_lo <= 0.0
        or list(d_time) == list(d_energy)
        or not (e_hi < e_lo and t_hi > t_lo)
    ):
        return _front([(t_lo, e_lo, [int(v) for v in d_time])])

    # Interior thresholds: geometric in (t_lo, t_hi), host float64 — the
    # SAME grid on every backend, so caps_t (and thus the solves) agree
    # bit-for-bit between numpy and torch.
    m = max(int(num_points), 2)
    ts = np.geomspace(t_lo, t_hi, m)[1:-1] if m > 2 else np.empty(0)

    interior: List[Tuple[float, float, List[int]]] = []
    if ts.size:
        if scalar:
            allocs = np.stack(
                [
                    np.asarray(
                        [
                            mdl.alloc_at_time(float(t), float(c))
                            for mdl, c in zip(store.models, icaps_arr)
                        ]
                    )
                    for t in ts
                ]
            )
        else:
            allocs = _alloc_at_times(sbank, ts, icaps_arr.astype(np.float64))
        # Tighten caps to the threshold; the elementwise max with the
        # time-optimal partition guarantees feasibility (sum >= n, caps >=
        # min_units) against float flooring at the t_lo boundary.
        caps_t = np.maximum(
            np.minimum(icaps_arr[None, :], np.floor(allocs).astype(np.int64)),
            d_time_arr[None, :],
        )
        if scalar:
            sols = [
                _partition_units_scalar(
                    energy.models, int(n), [int(v) for v in row], min_units=min_units
                )[0]
                for row in caps_t
            ]
        elif store.backend == "numpy":
            sols = [
                _partition_units_bank(
                    ebank, int(n), row, min_units=min_units, completion=completion
                )[0]
                for row in caps_t
            ]
        else:
            sols = _stacked_energy_partition(
                energy._carry(), caps_t, n, min_units, completion
            )
        for d in sols:
            interior.append(
                (_active_max(times_of(d), d), _total(etimes_of(d), d), [int(v) for v in d])
            )

    # Dominance filter: ascending time, strictly descending energy; interior
    # points colliding with (or dominated by) either endpoint drop out, so
    # both endpoints survive verbatim.
    interior.sort(key=lambda r: (r[0], r[1]))
    kept: List[Tuple[float, float, List[int]]] = [(t_lo, e_lo, [int(v) for v in d_time])]
    for t, e, d in interior:
        if t <= kept[-1][0] or e >= kept[-1][1]:
            continue
        if e <= e_hi or t >= t_hi:
            continue
        kept.append((t, e, d))
    kept.append((t_hi, e_hi, [int(v) for v in d_energy]))
    return _front(kept)


def capped_energy_partition(
    bank: ModelBank,
    ebank: ModelBank,
    n: int,
    icaps: Sequence[int],
    t_threshold: float,
    *,
    floor_d: Optional[Sequence[int]] = None,
    min_units: int = 0,
    completion: str = "auto",
) -> Optional[List[int]]:
    """One energy-balanced partition subject to makespan <= ``t_threshold``.

    The fleet power-cap primitive (host numpy — serving fleets bisect a
    common threshold multiplier over a handful of jobs, so the host program
    is the right cost class): tighten each cap to
    ``min(cap_i, floor(alloc_time_i(t)))``, optionally floor at ``floor_d``
    (pass the time-optimal partition to guarantee feasibility for any
    ``t >= makespan(floor_d)``), then partition the energy bank under the
    tightened caps.  Returns ``None`` when the threshold is infeasible
    (``sum(caps_t) < n``).
    """
    icaps_arr = np.asarray(icaps, dtype=np.int64)
    allocs = _alloc_at_times(
        bank, np.asarray([float(t_threshold)]), icaps_arr.astype(np.float64)
    )[0]
    caps_t = np.minimum(icaps_arr, np.floor(allocs).astype(np.int64))
    if floor_d is not None:
        caps_t = np.maximum(caps_t, np.asarray(floor_d, dtype=np.int64))
    if int(caps_t.sum()) < int(n):
        return None
    if min_units > 0 and np.any(caps_t < min_units):
        return None
    d, _ = _partition_units_bank(
        ebank, int(n), caps_t, min_units=int(min_units), completion=completion
    )
    return [int(v) for v in d]
