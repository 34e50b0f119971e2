"""Data-partitioning algorithms over performance models (host paths).

The port's own copy of the reference's host partitioners:

* ``partition_continuous`` — the geometric algorithm of [16]: the optimal
  allocations lie on a line through the origin of the (size, speed) plane,
  i.e. all processors finish at the same time ``t*``.  The smallest ``t``
  with ``sum_i alloc_i(t) >= n`` is found by bisection; ``alloc_i`` is
  monotone in ``t`` by construction, so bisection is exact for any shape of
  the speed estimate.
* ``partition_units`` — the integer version DFPA sends out: continuous
  solution, floor, ``min_units`` take-back, then a greedy min-makespan
  completion (each leftover unit to the processor whose completion time
  after receiving it is smallest).
* ``cpm_partition`` — the constant-performance-model baseline.

The private ``_partition_*`` kernels are the single host implementation;
the ``SpeedStore`` calls them with the backend resolved once.  The public
functions are thin deprecated adapters onto ``SpeedStore``, as in the
reference.  The torch device bank (``modelbank_torch.py``) mirrors the
bank kernels here expression for expression.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .fpm import SpeedModel
from .modelbank import ModelBank

__all__ = [
    "partition_continuous",
    "partition_units",
    "cpm_partition",
]

Models = Union[Sequence[SpeedModel], ModelBank]

# Iteration count of the most recent host-side t* bisection (scalar or bank
# kernel) — a telemetry tap read by SpeedStore.partition after a host solve.
# The torch bank runs its bisection on the device and does not report here.
_LAST_BISECTION_STEPS: int = 0


def _total_alloc(models: Sequence[SpeedModel], t: float, caps: Sequence[float]) -> float:
    return sum(m.alloc_at_time(t, c) for m, c in zip(models, caps))


def _prep_continuous_caps(p: int, n: float, caps: Optional[Sequence[float]]) -> List[float]:
    """Cap normalization + feasibility check shared by every backend."""
    caps = list(caps) if caps is not None else [float(n)] * p
    caps = [min(float(c), float(n)) for c in caps]
    if sum(caps) < n:
        raise ValueError(f"infeasible: sum(caps)={sum(caps)} < n={n}")
    return caps


def _continuous_scalar(
    models: Sequence[SpeedModel],
    n: float,
    caps: Optional[Sequence[float]] = None,
    *,
    rel_tol: float = 1e-12,
    max_steps: int = 200,
) -> Tuple[List[float], float]:
    p = len(models)
    if p == 0:
        raise ValueError("no processors")
    if n <= 0:
        return [0.0] * p, 0.0
    caps = _prep_continuous_caps(p, n, caps)
    return _partition_continuous_scalar(models, n, caps, rel_tol=rel_tol, max_steps=max_steps)


def _continuous_bank(
    bank: ModelBank,
    n: float,
    caps: Optional[Sequence[float]] = None,
    *,
    rel_tol: float = 1e-12,
    max_steps: int = 200,
) -> Tuple[List[float], float]:
    p = len(bank)
    if p == 0:
        raise ValueError("no processors")
    if n <= 0:
        return [0.0] * p, 0.0
    caps = _prep_continuous_caps(p, n, caps)
    return _partition_continuous_bank(bank, n, caps, rel_tol=rel_tol, max_steps=max_steps)


def _prep_unit_caps(
    p: int, n: int, caps: Optional[Sequence[int]], min_units: int
) -> List[int]:
    """Integer-partition validation shared by every backend (any
    ``cap < min_units`` refuses loudly)."""
    if n < 0:
        raise ValueError("n must be non-negative")
    if min_units * p > n:
        raise ValueError(f"min_units={min_units} infeasible for n={n}, p={p}")
    icaps = [int(c) for c in caps] if caps is not None else [n] * p
    if min_units > 0:
        for i, c in enumerate(icaps):
            if c < min_units:
                raise ValueError(
                    f"min_units={min_units} infeasible: caps[{i}]={c} < min_units"
                )
    return icaps


def _partition_continuous_scalar(
    models: Sequence[SpeedModel],
    n: float,
    caps: List[float],
    *,
    rel_tol: float,
    max_steps: int,
) -> Tuple[List[float], float]:
    """The per-model Python loop (one ``alloc_at_time`` call per model per
    bisection step) — the path for non-piecewise models."""
    # Exponential search for an upper bound on t*.
    hi = max(m.time(min(1.0, c)) for m, c in zip(models, caps) if c > 0)
    hi = max(hi, 1e-9)
    for _ in range(200):
        if _total_alloc(models, hi, caps) >= n:
            break
        hi *= 2.0
    else:  # pragma: no cover - guarded by the feasibility check above
        raise RuntimeError("could not bracket t*")
    lo = 0.0
    # Bisection: invariant total(lo) < n <= total(hi).
    steps = 0
    for _ in range(max_steps):
        steps += 1
        mid = 0.5 * (lo + hi)
        if _total_alloc(models, mid, caps) >= n:
            hi = mid
        else:
            lo = mid
        if hi - lo <= rel_tol * hi:
            break
    global _LAST_BISECTION_STEPS
    _LAST_BISECTION_STEPS = steps
    t_star = hi
    xs = [m.alloc_at_time(t_star, c) for m, c in zip(models, caps)]
    total = sum(xs)
    if total > 0:
        # alloc_at_time(t_star) may slightly overshoot n; rescale the excess
        # proportionally so the continuous solution sums exactly to n.
        excess = total - n
        if excess > 0:
            xs = [x - excess * (x / total) for x in xs]
    return xs, t_star


def _partition_continuous_bank(
    bank: ModelBank,
    n: float,
    caps: List[float],
    *,
    rel_tol: float,
    max_steps: int,
) -> Tuple[List[float], float]:
    """Bank path: the same bisection, one array op per step."""
    caps_arr = np.asarray(caps, dtype=np.float64)
    active = caps_arr > 0.0
    if np.any(active & (bank.counts == 0)):
        raise ValueError("empty FPM")
    # Exponential search for an upper bound on t*.
    t_init = bank.time(np.minimum(1.0, caps_arr))
    hi = float(t_init[active].max(initial=0.0))
    hi = max(hi, 1e-9)
    for _ in range(200):
        if bank.total_alloc(hi, caps_arr) >= n:
            break
        hi *= 2.0
    else:  # pragma: no cover - guarded by the feasibility check above
        raise RuntimeError("could not bracket t*")
    lo = 0.0
    steps = 0
    for _ in range(max_steps):
        steps += 1
        mid = 0.5 * (lo + hi)
        if bank.total_alloc(mid, caps_arr) >= n:
            hi = mid
        else:
            lo = mid
        if hi - lo <= rel_tol * hi:
            break
    global _LAST_BISECTION_STEPS
    _LAST_BISECTION_STEPS = steps
    t_star = hi
    xs = bank.alloc_at_time(t_star, caps_arr)
    total = float(xs.sum())
    if total > 0:
        excess = total - n
        if excess > 0:
            xs = xs - excess * (xs / total)
    return list(map(float, xs)), t_star


def _partition_units_scalar(
    models: Sequence[SpeedModel], n: int, icaps: List[int], *, min_units: int
) -> Tuple[List[int], float]:
    p = len(models)
    fcaps = [float(c) for c in icaps]
    xs, t_star = _continuous_scalar(models, float(n), fcaps)
    d = [max(min_units, int(math.floor(x))) for x in xs]
    d = [min(di, ci) for di, ci in zip(d, icaps)]
    leftover = n - sum(d)
    if leftover < 0:
        # min_units pushed us over n: take units back from the processors whose
        # per-unit time is largest (removing from the slowest hurts least).
        order = sorted(range(p), key=lambda i: models[i].time(d[i]) / max(d[i], 1), reverse=True)
        k = 0
        while leftover < 0:
            i = order[k % p]
            if d[i] > min_units:
                d[i] -= 1
                leftover += 1
            k += 1
    # Greedy completion: each leftover unit to the processor minimizing the
    # resulting completion time (ties -> larger fractional remainder).
    rem = [x - math.floor(x) for x in xs]
    for _ in range(leftover):
        best_i, best_key = -1, None
        for i in range(p):
            if d[i] + 1 > icaps[i]:
                continue
            key = (models[i].time(d[i] + 1), -rem[i])
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        if best_i < 0:
            raise ValueError("caps infeasible during integer completion")
        d[best_i] += 1
    if sum(d) != n:  # pragma: no cover - the loops above place every unit
        raise RuntimeError(f"integer completion placed {sum(d)} of {n} units")
    return d, t_star


def _threshold_prefill_bank(
    bank: ModelBank,
    d0: np.ndarray,
    caps_arr: np.ndarray,
    leftover: int,
    t_star: float,
    *,
    rel_tol: float = 1e-12,
    max_steps: int = 200,
) -> Tuple[np.ndarray, int]:
    """Threshold-count bulk completion for monotone-time banks.

    Bisects a time threshold ``t`` on

        count(t) = sum_i clip(floor(alloc_at_time(t, cap_i)), d0_i, cap_i)
                   - sum_i d0_i

    keeping the strict bracket ``count(lo) < leftover <= count(hi)``;
    everything counted at ``lo`` is granted in one array op and the
    boundary-tied remainder (at least 1) is returned for the exact greedy.
    Mirrored by ``modelbank_torch._threshold_prefill``.
    """
    caps_f = caps_arr.astype(np.float64)
    base_total = int(d0.sum())

    def count(t: float) -> Tuple[int, np.ndarray]:
        g = np.clip(
            np.floor(bank.alloc_at_time(t, caps_f)).astype(np.int64), d0, caps_arr
        )
        return int(g.sum()) - base_total, g

    # Bracket: alloc(t -> inf) -> caps and sum(caps) >= n, so doubling from
    # the continuous solve's t* always terminates.
    hi = max(float(t_star), 1e-9)
    for _ in range(200):
        c_hi, _ = count(hi)
        if c_hi >= leftover:
            break
        hi *= 2.0
    else:  # pragma: no cover - guarded by the feasibility checks above
        raise RuntimeError("could not bracket the completion threshold")
    lo = 0.0
    for _ in range(max_steps):
        mid = 0.5 * (lo + hi)
        c_mid, _ = count(mid)
        if c_mid >= leftover:
            hi = mid
        else:
            lo = mid
        if hi - lo <= rel_tol * hi:
            break
    c_lo, g_lo = count(lo)
    return g_lo, leftover - c_lo


def _partition_units_bank(
    bank: ModelBank, n: int, icaps: List[int], *, min_units: int,
    completion: str = "auto",
) -> Tuple[List[int], float]:
    """Vectorized floor + integer completion.

    ``"greedy"`` is the per-unit lazy heap, ``"threshold"`` forces the
    threshold-count bulk grant, ``"auto"`` keeps the lazy heap on this host
    path.  All modes share the heap for the final boundary units, so
    tie-breaking is identical: each unit goes to the processor with the
    smallest ``(time(d+1), -frac_remainder, index)``.
    """
    if completion not in ("auto", "threshold", "greedy"):
        raise ValueError(f"unknown completion mode {completion!r}")
    p = bank.p
    caps_arr = np.asarray(icaps, dtype=np.int64)
    xs_list, t_star = _continuous_bank(bank, float(n), [float(c) for c in icaps])
    xs = np.asarray(xs_list, dtype=np.float64)
    d = np.maximum(min_units, np.floor(xs).astype(np.int64))
    d = np.minimum(d, caps_arr)
    leftover = int(n - d.sum())

    if leftover < 0:
        # Vectorized analogue of the scalar take-back: largest per-unit time
        # first, round-robin until the overshoot is gone.
        with np.errstate(invalid="ignore"):
            per_unit = bank.time(d.astype(np.float64)) / np.maximum(d, 1)
        order = sorted(range(p), key=lambda i: per_unit[i], reverse=True)
        k = 0
        while leftover < 0:
            i = order[k % p]
            if d[i] > min_units:
                d[i] -= 1
                leftover += 1
            k += 1

    rem = xs - np.floor(xs)
    if leftover > 0 and completion == "threshold":
        d, leftover = _threshold_prefill_bank(bank, d, caps_arr, leftover, t_star)
    if leftover > 0:
        # Initial candidate times at d+1 for the whole bank in one pass; each
        # processor keeps exactly one heap entry, refreshed when it wins a unit.
        t_next = bank.time((d + 1).astype(np.float64))
        heap = [
            (float(t_next[i]), -float(rem[i]), i)
            for i in range(p)
            if d[i] + 1 <= caps_arr[i]
        ]
        heapq.heapify(heap)
        while leftover > 0:
            if not heap:
                raise ValueError("caps infeasible during integer completion")
            _, negrem, i = heapq.heappop(heap)
            d[i] += 1
            leftover -= 1
            if d[i] + 1 <= caps_arr[i]:
                heapq.heappush(heap, (bank.time_one(i, float(d[i] + 1)), negrem, i))
    if int(d.sum()) != n:  # pragma: no cover - the loops above place every unit
        raise RuntimeError(f"integer completion placed {int(d.sum())} of {n} units")
    return [int(v) for v in d], t_star


# ---------------------------------------------------------------------------
# Legacy adapters — delegate to the SpeedStore (backend resolved once
# there), emitting DeprecationWarning at the call site, as the reference's do.
# ---------------------------------------------------------------------------


def partition_continuous(
    models: Models,
    n: float,
    caps: Optional[Sequence[float]] = None,
    *,
    rel_tol: float = 1e-12,
    max_steps: int = 200,
    vectorize: bool = True,
    backend: str = "numpy",
    device="cuda",
) -> Tuple[List[float], float]:
    """Continuous optimal partition of ``n`` units across ``models``.

    .. deprecated:: use ``SpeedStore.partition_continuous``.
    """
    from .speedstore import SpeedStore, _warn_legacy

    _warn_legacy("partition_continuous()", "SpeedStore.partition_continuous()")
    store = SpeedStore.resolve(models, backend=backend, vectorize=vectorize, device=device)
    return store.partition_continuous(n, caps, rel_tol=rel_tol, max_steps=max_steps)


def partition_units(
    models: Models,
    n: int,
    caps: Optional[Sequence[int]] = None,
    *,
    min_units: int = 0,
    vectorize: bool = True,
    backend: str = "numpy",
    device="cuda",
) -> List[int]:
    """Integer partition of ``n`` equal computation units.

    .. deprecated:: use ``SpeedStore.partition_units`` / ``Scheduler.partition``.
    """
    from .speedstore import SpeedStore, _warn_legacy

    _warn_legacy("partition_units()", "SpeedStore.partition_units()")
    store = SpeedStore.resolve(models, backend=backend, vectorize=vectorize, device=device)
    return store.partition_units(n, caps, min_units=min_units)


def cpm_partition(speeds: Sequence[float], n: int, caps: Optional[Sequence[int]] = None) -> List[int]:
    """Conventional CPM distribution: proportional to constant speeds.

    .. deprecated:: use ``Scheduler.from_speeds(speeds).partition(n)``.
    """
    from .speedstore import SpeedStore, _warn_legacy

    _warn_legacy("cpm_partition()", "Scheduler.from_speeds(...).partition()")
    return SpeedStore.from_speeds(speeds).partition_units(n, caps)
