"""Vectorized bank of piecewise-linear FPMs on the host (numpy).

The port keeps its own copy of the reference's host bank: it is the
semantics the torch device bank (``modelbank_torch.py``) is held against,
expression for expression, and the ``"numpy"`` backend of the port's
``SpeedStore``.

``ModelBank`` stores all ``p`` models as padded 2-D arrays:

  * ``xs[p, k_max]`` — sorted observed problem sizes, right-padded by
    repeating each row's last point (padding segments have zero length and
    are masked out);
  * ``ss[p, k_max]`` — the speeds at those points, padded the same way;
  * ``counts[p]``    — number of valid points per row (0 = empty model).

and evaluates the model queries for the whole bank in single numpy passes:
``speed(x)`` / ``time(x)`` (piecewise-linear interpolation with constant
extension, elementwise identical to ``PiecewiseLinearFPM``) and
``alloc_at_time(t, caps)`` (the closed-form per-segment feasibility test
``x (1 - t m) <= t (s0 - m x0)`` for every segment of every processor).

Completion modes and the monotonicity contract
----------------------------------------------

The integer completion (placing the ``n - sum(floor(x_i))`` leftover units)
has two implementations on the banked backends:

* **per-unit greedy** (``completion="greedy"``) — each leftover unit goes
  to the processor minimizing ``(time(d_i + 1), -frac_remainder, index)``;
  a lazy heap here, a masked lexicographic argmin on the torch bank.
* **threshold-count** (``completion="threshold"``) — for monotone-time
  banks: bisect a time threshold on ``count(t) = sum(clip(floor(alloc(t)),
  d0, cap)) - sum(d0)``, bulk-grant everything under it, and hand the
  boundary-tied remainder to the exact greedy.

``"auto"`` keeps the heap on this host path and routes monotone banks to
the threshold count on the device bank.  A bank is monotone iff every row's
knots are sorted, its speeds positive and finite, and consecutive knots
satisfy ``x0 * s1 <= x1 * s0`` (:func:`_monotone_check`).

Two more pieces ride the same layout:

* **the energy sub-bank** (``core/energy.py``) — an optional second bank in
  the ``energy`` field whose ``ss`` hold energy *rates* ``x / E(x)``, so
  ``energy.time(x) == E(x)`` and every bank program serves energy as it
  serves speed;
* **group aggregation** (``core/hierarchy.py``) — :func:`aggregate_groups`
  builds the ``[g, k_g]`` group-level bank of the two-level partitioner
  from the members' allocations at sampled times (:func:`_alloc_at_times`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .fpm import ConstantModel, PiecewiseLinearFPM

__all__ = ["ModelBank", "aggregate_groups", "group_members"]

ArrayLike = Union[float, Sequence[float], np.ndarray]


def _monotone_check(xs: np.ndarray, ss: np.ndarray, counts: np.ndarray) -> bool:
    """Host-side monotone-time check over a padded bank (see
    :meth:`ModelBank.is_monotone`); one numpy pass."""
    k = xs.shape[-1]
    pts = np.arange(k) < counts[..., None]
    ok_pts = (xs > 0.0) & np.isfinite(xs) & (ss > 0.0) & np.isfinite(ss)
    if np.any(pts & ~ok_pts):
        return False
    if k >= 2:
        x0, x1 = xs[..., :-1], xs[..., 1:]
        s0, s1 = ss[..., :-1], ss[..., 1:]
        seg = np.arange(k - 1) < (counts - 1)[..., None]
        ok_seg = (x1 >= x0) & (x0 * s1 <= x1 * s0)
        if np.any(seg & ~ok_seg):
            return False
    return True


@dataclass
class ModelBank:
    """All ``p`` piecewise-linear FPMs as padded arrays (see module docstring)."""

    xs: np.ndarray  # [p, k_max] float64, row-sorted, padding repeats last point
    ss: np.ndarray  # [p, k_max] float64, padded the same way
    counts: np.ndarray  # [p] int64, number of valid points per row
    # Host-side monotone-time flag (None = unknown, computed lazily by
    # is_monotone()); routes the threshold-count integer completion.
    monotone: Optional[bool] = None
    # Optional energy sub-bank (same layout; ss holds energy RATES x/E(x),
    # so energy.time(x) == E(x)) — see core/energy.py.
    energy: Optional["ModelBank"] = None

    # -- construction --------------------------------------------------------

    @classmethod
    def from_point_lists(
        cls, points: Sequence[Tuple[Sequence[float], Sequence[float]]]
    ) -> "ModelBank":
        """Build from per-processor ``(xs_i, ss_i)`` sorted point lists."""
        p = len(points)
        counts = np.array([len(px) for px, _ in points], dtype=np.int64)
        k_max = max(int(counts.max(initial=1)), 1)
        xs = np.zeros((p, k_max), dtype=np.float64)
        ss = np.zeros((p, k_max), dtype=np.float64)
        for i, (px, ps) in enumerate(points):
            c = len(px)
            if c == 0:
                continue
            xs[i, :c] = px
            ss[i, :c] = ps
            xs[i, c:] = px[-1]  # zero-length padding segments, masked later
            ss[i, c:] = ps[-1]
        return cls(xs=xs, ss=ss, counts=counts)

    @classmethod
    def from_models(cls, models: Sequence[object]) -> "ModelBank":
        """Adapt a sequence of scalar models into a bank.

        Accepts ``PiecewiseLinearFPM``, ``ConstantModel`` (becomes the
        single-point model ``{(1, s)}``, whose constant extension reproduces
        it exactly), and anything exposing ``as_points()``.  Raises
        ``TypeError`` for models with no piecewise representation (e.g.
        ``AnalyticModel``) — callers fall back to the scalar path.
        """
        pts: List[Tuple[List[float], List[float]]] = []
        for m in models:
            if isinstance(m, PiecewiseLinearFPM):
                pts.append((list(m.xs), list(m.ss)))
            elif isinstance(m, ConstantModel):
                pts.append(([1.0], [float(m.s)]))
            elif hasattr(m, "as_points"):
                pp = m.as_points()
                pts.append(([float(x) for x, _ in pp], [float(s) for _, s in pp]))
            else:
                raise TypeError(
                    f"{type(m).__name__} has no piecewise representation; "
                    "use the scalar partition path"
                )
        return cls.from_point_lists(pts)

    # -- shape ---------------------------------------------------------------

    @property
    def p(self) -> int:
        return self.xs.shape[0]

    def __len__(self) -> int:
        return self.p

    @property
    def num_points(self) -> np.ndarray:
        return self.counts

    # -- monotonicity (threshold-count completion routing) -------------------

    def is_monotone(self) -> bool:
        """True iff every row's time ``x / s_i(x)`` is nondecreasing on
        ``[0, inf)`` — the contract under which the threshold-count integer
        completion is exact.  Computed once per bank and cached."""
        if self.monotone is None:
            self.monotone = _monotone_check(self.xs, self.ss, self.counts)
        return self.monotone

    # -- batched evaluation --------------------------------------------------

    def _edges(self):
        idx = np.arange(self.p)
        last = np.maximum(self.counts - 1, 0)
        return self.xs[idx, 0], self.ss[idx, 0], self.xs[idx, last], self.ss[idx, last]

    def speed(self, x: ArrayLike) -> np.ndarray:
        """Batched ``s_i(x_i)``; ``x`` is a scalar or a ``[p]`` vector.

        Empty rows evaluate to NaN (the scalar model raises there).
        """
        x = np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))
        first_x, first_s, last_x, last_s = self._edges()
        # k = bisect_right(xs, x) - 1, batched; padding repeats last_x so it
        # never out-counts an interior x.
        k = np.sum(self.xs <= x[:, None], axis=1) - 1
        k = np.clip(k, 0, np.maximum(self.counts - 2, 0))
        idx = np.arange(self.p)
        kp1 = np.minimum(k + 1, self.xs.shape[1] - 1)
        x0, x1 = self.xs[idx, k], self.xs[idx, kp1]
        s0, s1 = self.ss[idx, k], self.ss[idx, kp1]
        denom = np.where(x1 > x0, x1 - x0, 1.0)
        w = (x - x0) / denom
        interior = s0 + w * (s1 - s0)
        s = np.where(x <= first_x, first_s, np.where(x >= last_x, last_s, interior))
        return np.where(self.counts > 0, s, np.nan)

    def time(self, x: ArrayLike) -> np.ndarray:
        """Batched ``t_i(x_i) = x_i / s_i(x_i)`` (0 for non-positive ``x``)."""
        x = np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))
        with np.errstate(divide="ignore", invalid="ignore"):
            t = x / self.speed(x)
        return np.where(x > 0.0, t, 0.0)

    def alloc_at_time(self, t: float, caps: ArrayLike) -> np.ndarray:
        """Batched ``max { x in [0, cap_i] : x / s_i(x) <= t }`` -> ``[p]``,
        elementwise identical to ``PiecewiseLinearFPM.alloc_at_time``."""
        caps = np.broadcast_to(np.asarray(caps, dtype=np.float64), (self.p,))
        if t <= 0.0:
            return np.zeros(self.p, dtype=np.float64)
        first_x, first_s, last_x, last_s = self._edges()

        # Region [0, x_1]: constant speed ss[:, 0].
        best = np.minimum(t * first_s, np.minimum(first_x, caps))

        # Interior segments, all at once: s(x) = s0 + m (x - x0) on [x0, x1];
        # x <= t s(x)  <=>  x (1 - t m) <= t (s0 - m x0).
        k_max = self.xs.shape[1]
        if k_max >= 2:
            x0, x1 = self.xs[:, :-1], self.xs[:, 1:]
            s0, s1 = self.ss[:, :-1], self.ss[:, 1:]
            seg = np.arange(k_max - 1)[None, :]
            valid = (
                (seg < (self.counts - 1)[:, None])
                & (x0 < caps[:, None])
                & (x1 > x0)
            )
            x1c = np.minimum(x1, caps[:, None])
            denom = np.where(x1 > x0, x1 - x0, 1.0)
            m = (s1 - s0) / denom
            a = 1.0 - t * m
            b = t * (s0 - m * x0)
            with np.errstate(divide="ignore", invalid="ignore"):
                ub = b / np.where(a != 0.0, a, 1.0)
            cand = np.where(
                a > 0.0,
                np.where(ub >= x0, np.minimum(ub, x1c), 0.0),
                np.where(
                    a == 0.0,
                    np.where(b >= 0.0, x1c, 0.0),
                    np.where(x1c >= ub, x1c, 0.0),
                ),
            )
            cand = np.where(valid, cand, 0.0)
            best = np.maximum(best, cand.max(axis=1))

        # Region [x_m, cap]: constant speed ss[:, count-1].
        ub_r = t * last_s
        right = (caps > last_x) & (ub_r >= last_x) & (self.counts > 0)
        best = np.maximum(best, np.where(right, np.minimum(ub_r, caps), 0.0))

        return np.where((caps > 0.0) & (self.counts > 0), best, 0.0)

    def total_alloc(self, t: float, caps: ArrayLike) -> float:
        """``sum_i alloc_i(t)`` — one bisection step of the partitioner."""
        return float(self.alloc_at_time(t, caps).sum())

    # -- scalar access (greedy completion, adapters) -------------------------

    def speed_one(self, i: int, x: float) -> float:
        """Scalar ``s_i(x)`` for one row (used by the greedy unit completion)."""
        c = int(self.counts[i])
        if c == 0:
            raise ValueError("empty FPM row")
        xs, ss = self.xs[i], self.ss[i]
        if x <= xs[0]:
            return float(ss[0])
        if x >= xs[c - 1]:
            return float(ss[c - 1])
        k = int(np.searchsorted(xs[:c], x, side="right")) - 1
        w = (x - xs[k]) / (xs[k + 1] - xs[k])
        return float(ss[k] + w * (ss[k + 1] - ss[k]))

    def time_one(self, i: int, x: float) -> float:
        if x <= 0.0:
            return 0.0
        return x / self.speed_one(i, x)

    # -- the energy sub-bank (core/energy.py) --------------------------------

    def with_energy(self, energy: "ModelBank") -> "ModelBank":
        """Attach an energy sub-bank (same ``p``; ``ss`` holds energy rates
        ``x / E(x)``) — returns a new bank sharing this bank's arrays."""
        if energy.p != self.p:
            raise ValueError(
                f"energy bank has {energy.p} rows but speed bank has {self.p}"
            )
        return ModelBank(
            xs=self.xs, ss=self.ss, counts=self.counts,
            monotone=self.monotone, energy=energy,
        )

    def energy_at(self, d: ArrayLike) -> np.ndarray:
        """Per-processor energies ``E_i(d_i)`` of a distribution (0 for
        ``d_i <= 0``, NaN on empty energy rows with units)."""
        if self.energy is None:
            raise ValueError("no energy sub-bank attached (use with_energy)")
        return self.energy.time(d)

    def fleet_energy(self, d: ArrayLike) -> float:
        """Total fleet energy ``sum_i E_i(d_i)`` of a distribution."""
        return float(self.energy_at(d).sum())

    # -- transformations -----------------------------------------------------

    def scaled(self, speed_scale: ArrayLike) -> "ModelBank":
        """New bank with every row's speeds multiplied by ``speed_scale[i]``.
        A positive per-row scale preserves time-monotonicity, so the cached
        flag carries over; any other scale resets it to unknown.  The energy
        sub-bank (problem-size semantics, unchanged by a speed rescale)
        carries through untouched."""
        scale = np.broadcast_to(np.asarray(speed_scale, dtype=np.float64), (self.p,))
        return ModelBank(
            xs=self.xs.copy(),
            ss=self.ss * scale[:, None],
            counts=self.counts.copy(),
            monotone=self.monotone if bool(np.all(scale > 0.0)) else None,
            energy=self.energy,
        )

    # -- adapters back to the scalar protocol --------------------------------

    def row(self, i: int) -> PiecewiseLinearFPM:
        """Scalar ``SpeedModel`` view of one processor."""
        c = int(self.counts[i])
        return PiecewiseLinearFPM(xs=list(self.xs[i, :c]), ss=list(self.ss[i, :c]))

    def to_models(self) -> List[PiecewiseLinearFPM]:
        return [self.row(i) for i in range(self.p)]


def _alloc_at_times(bank: ModelBank, ts: np.ndarray, caps: np.ndarray) -> np.ndarray:
    """``alloc_at_time`` for a whole vector of candidate times at once:
    returns ``[T, p]``.  Expression for expression :meth:`ModelBank.
    alloc_at_time` with a leading time axis, so each row is bitwise what the
    scalar-``t`` call produces (the sampling primitive of the group
    aggregation)."""
    ts = np.asarray(ts, dtype=np.float64)[:, None]  # [T, 1]
    caps2 = np.broadcast_to(np.asarray(caps, dtype=np.float64), (bank.p,))[None, :]
    first_x, first_s, last_x, last_s = bank._edges()

    best = np.minimum(ts * first_s[None, :], np.minimum(first_x[None, :], caps2))

    k_max = bank.xs.shape[1]
    if k_max >= 2:
        x0, x1 = bank.xs[None, :, :-1], bank.xs[None, :, 1:]
        s0, s1 = bank.ss[None, :, :-1], bank.ss[None, :, 1:]
        seg = np.arange(k_max - 1)[None, None, :]
        valid = (
            (seg < (bank.counts - 1)[None, :, None])
            & (x0 < caps2[..., None])
            & (x1 > x0)
        )
        x1c = np.minimum(x1, caps2[..., None])
        denom = np.where(x1 > x0, x1 - x0, 1.0)
        m = (s1 - s0) / denom
        tseg = ts[..., None]  # [T, 1, 1]
        a = 1.0 - tseg * m
        b = tseg * (s0 - m * x0)
        with np.errstate(divide="ignore", invalid="ignore"):
            ub = b / np.where(a != 0.0, a, 1.0)
        cand = np.where(
            a > 0.0,
            np.where(ub >= x0, np.minimum(ub, x1c), 0.0),
            np.where(
                a == 0.0,
                np.where(b >= 0.0, x1c, 0.0),
                np.where(x1c >= ub, x1c, 0.0),
            ),
        )
        cand = np.where(valid, cand, 0.0)
        best = np.maximum(best, cand.max(axis=-1))

    ub_r = ts * last_s[None, :]
    right = (caps2 > last_x[None, :]) & (ub_r >= last_x[None, :]) & (bank.counts > 0)[None, :]
    best = np.maximum(best, np.where(right, np.minimum(ub_r, caps2), 0.0))

    best = np.where((caps2 > 0.0) & (bank.counts > 0)[None, :], best, 0.0)
    return np.where(ts > 0.0, best, 0.0)


# ---------------------------------------------------------------------------
# Group aggregation — the two-level partitioning path (core/hierarchy.py)
# ---------------------------------------------------------------------------


def group_members(groups: Sequence[int]) -> Tuple[List[int], List[np.ndarray]]:
    """Normalize a ``groups[p]`` assignment: returns the sorted unique group
    ids and, per group, the member processor indices in ascending order (the
    order the hierarchical scatter preserves)."""
    garr = np.asarray(groups)
    if garr.ndim != 1:
        raise ValueError("groups must be a 1-D per-processor assignment")
    gids = sorted(set(int(v) for v in garr))
    members = [np.flatnonzero(garr == g) for g in gids]
    return gids, members


def _aggregate_one(
    sub: ModelBank, caps: np.ndarray, max_knots: int
) -> Tuple[List[float], List[float]]:
    """One group's aggregate knots.

    The aggregate problem-size-at-time function is ``X(t) = sum_i
    alloc_i(t, cap_i)`` — exactly what one bisection step of the outer
    partitioner needs.  Knots are sampled at the union of the members'
    observed knot times ``x_ij / s_ij`` plus each member's cap-crossing time
    ``time_i(cap_i)`` (where its alloc saturates), so the aggregate is exact
    at every time any member's behaviour changes slope; between knots the
    bank's linear-in-speed interpolation approximates the true piecewise-
    rational composition.  Member caps are baked in (NOT the job size ``n``:
    the same aggregate serves any ``n``, and allocations above ``n`` cannot
    occur at the solution).  Sampling at sorted times makes the result
    monotone-time by construction: ``x0 s1 <= x1 s0`` with ``s = x/t``
    reduces to ``t0 <= t1``.

    Two refinements keep the interpolation honest between knot times:

    * a member's alloc can JUMP at a knot time — within a segment the
      implied time ``x / s(x)`` is a monotone hyperbola piece (``s``
      linear), so when it runs *decreasing* the whole segment becomes
      feasible the moment ``t`` reaches the far knot's time: a step, never
      an interior extremum.  A sample exactly at the knot time lands on TOP
      of that step; sampling each kept time again just below
      (``t (1 - 1e-9)``) pins the step's bottom, so the aggregate brackets
      the jump instead of interpolating across it;
    * between WIDELY separated knot times the sum of hyperbola/linear
      member pieces bends far from the bank's linear-in-speed
      interpolation, so a geometric fill of sample times spans the whole
      knot range — the gap ratio is bounded regardless of how the members'
      knots cluster.

    The knot budget splits ``max_knots`` as: up to 1/4 exact knot times,
    1/4 geometric fill, then the below-jump brackets double the kept set.
    """
    ts = _aggregate_times(sub, caps, max_knots)
    if ts.size == 0:
        return [], []
    caps_f = caps.astype(np.float64)
    k = sub.xs.shape[1]
    # _alloc_at_times materializes ~a dozen [T_chunk, p, k-1] temporaries;
    # chunk the time axis so each slab stays ~1 MB and the whole working set
    # L2-resident — the pass is memory-bandwidth bound, and cache blocking
    # here measures ~1.8x at fleet group shapes (p_g=1000, k~17) while also
    # keeping p ~ 10^5 member groups allocatable at p=10^6.  Chunk
    # boundaries cannot change any element's arithmetic, so the result is
    # bitwise independent of the chunk size.
    t_chunk = max(1, int(131_072 // max(sub.p * max(k, 1), 1)))
    xs_g = np.concatenate(
        [
            _alloc_at_times(sub, ts[i : i + t_chunk], caps_f).sum(axis=1)
            for i in range(0, ts.size, t_chunk)
        ]
    )
    return _points_from_samples(ts, xs_g)


def _aggregate_times(sub: ModelBank, caps: np.ndarray, max_knots: int) -> np.ndarray:
    """Sample times for one group's aggregate (see :func:`_aggregate_one`).

    Factored out of :func:`_aggregate_one` so the torch hierarchy backend can
    compute the sample grid on host (cheap, O(p k) with small constants)
    while evaluating the member allocations at those times on device.
    Returns a sorted, strictly positive, possibly empty float array.
    """
    k = sub.xs.shape[1]
    valid = (np.arange(k)[None, :] < sub.counts[:, None]) & (caps[:, None] > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_pts = np.where(sub.ss > 0, sub.xs / sub.ss, np.nan)
    ts = t_pts[valid]
    active = (caps > 0) & (sub.counts > 0)
    if np.any(active):
        cap_t = sub.time(np.where(active, caps, 1.0))
        ts = np.concatenate([ts, cap_t[active]])
    ts = np.unique(ts[np.isfinite(ts) & (ts > 0)])
    if ts.size == 0:
        return ts
    quota = max(max_knots // 4, 2)
    if ts.size > quota:
        pick = np.unique(np.round(np.linspace(0, ts.size - 1, quota)).astype(int))
        ts = ts[pick]
    # Jump brackets FIRST, on the knot/cap-derived times only: member alloc
    # functions can step exactly AT a knot time, never between knots, so the
    # geometric fill below (curvature sampling in wide gaps) needs no
    # brackets — skipping them keeps the sampled grid (and the group bank's
    # knot count) ~25% smaller for the same accuracy.
    ts = np.unique(np.concatenate([ts, ts * (1.0 - 1e-9)]))
    if ts[-1] > ts[0]:
        ts = np.unique(np.concatenate([ts, np.geomspace(ts[0], ts[-1], quota)]))
    return ts


def _points_from_samples(
    ts: np.ndarray, xs_g: np.ndarray
) -> Tuple[List[float], List[float]]:
    """Turn sampled ``(time, aggregate size)`` pairs into bank knot lists."""
    keep = xs_g > 0
    # equal-X plateaus (all members capped): keep the FIRST (earliest-time,
    # fastest) occurrence — the true aggregate reaches that size then.
    keep &= np.concatenate([[True], np.diff(xs_g) > 0])
    ts, xs_g = ts[keep], xs_g[keep]
    return list(xs_g), list(xs_g / ts)


def aggregate_groups(
    bank: ModelBank,
    groups: Sequence[int],
    caps: Sequence[float],
    *,
    max_group_knots: int = 64,
) -> Tuple[ModelBank, np.ndarray, List[np.ndarray]]:
    """Build the ``[g, k_g]`` group-level bank for a ``groups[p]`` assignment.

    Returns ``(group_bank, group_caps, members)``: one aggregate row per
    group (see :func:`_aggregate_one`; ``max_group_knots`` bounds each row's
    knot count, keeping the outer solve O(g k_g)), the summed member caps,
    and the per-group member indices.  The group bank's ``monotone`` flag is
    set — true by construction — so the outer integer completion may always
    take the threshold-count bulk grant.  Groups with no capacity get an
    empty row and cap 0 (the outer solver allocates them nothing).
    """
    caps_arr = np.broadcast_to(np.asarray(caps, dtype=np.float64), (bank.p,))
    gids, members = group_members(groups)
    pts: List[Tuple[List[float], List[float]]] = []
    gcaps = np.zeros(len(gids), dtype=np.float64)
    for gi, idx in enumerate(members):
        sub = ModelBank(
            xs=bank.xs[idx], ss=bank.ss[idx], counts=bank.counts[idx]
        )
        gcaps[gi] = caps_arr[idx].sum()
        pts.append(_aggregate_one(sub, caps_arr[idx], max_group_knots))
    gbank = ModelBank.from_point_lists(pts)
    gbank.monotone = True  # by construction: knots sampled at sorted times
    return gbank, gcaps, members
