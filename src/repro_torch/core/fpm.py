"""Functional performance models (FPMs).

The paper represents the speed of a processor by a function ``s(x)`` of problem
size ``x`` (number of equal-size computation units).  DFPA never builds the full
function; it maintains a *partial piecewise-linear estimate* from the points
observed so far, with the paper's three update rules (§2, step 5):

  * ``x < x_(1)``  : the segment ``(0, s(x_(1))) -> (x_(1), s(x_(1)))`` is replaced by
    ``(0, s(x)) -> (x, s(x)) -> (x_(1), s(x_(1)))``  (constant extension to the left
    of the leftmost observed point);
  * ``x > x_(m)``  : the constant continuation to the right is re-anchored at the
    new rightmost point;
  * ``x_(k) < x < x_(k+1)``: the point is inserted and the segment split.

All of which reduce to: keep a sorted set of observed ``(x, s)`` points, evaluate
by linear interpolation between points and constant extension outside them.

Models expose two queries used by the geometric partitioner (``partition.py``):

  * ``time(x)``            — execution-time estimate ``x / s(x)``;
  * ``alloc_at_time(t, cap)`` — ``max { x in [0, cap] : time(x) <= t }``, the
    workload the processor can finish within ``t``.  This is the primitive of the
    line-through-origin algorithm of [16]: the optimal allocations are
    ``x_i = alloc_i(t*)`` for the smallest ``t*`` with ``sum_i x_i >= n``.

``alloc_at_time`` is monotone non-decreasing in ``t`` *by construction* (the
feasible set only grows with ``t``), so bisection over ``t`` is valid for any
shape of the speed estimate — the implementation does not rely on monotonicity
of ``s`` itself, only positivity.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Callable, List, Protocol, Sequence, Tuple

__all__ = [
    "SpeedModel",
    "PiecewiseLinearFPM",
    "ConstantModel",
    "AnalyticModel",
    "imbalance",
]


def imbalance(times: Sequence[float]) -> float:
    """The paper's balance metric: ``max_{i,j} |t_i - t_j| / t_i``.

    Maximised by ``t_i = min``, ``t_j = max`` so it equals ``(max - min)/min``
    over the *working* processors.  Entries ``<= 0`` are processors that
    received no units this round (legal under ``min_units=0``) — they are
    ignored, not treated as infinitely imbalanced, so a distribution whose
    working processors finish simultaneously is balanced no matter how many
    processors sat out.  Fewer than two positive entries -> 0 (trivially
    balanced).
    """
    ts = [float(t) for t in times if float(t) > 0.0]
    if len(ts) < 2:
        return 0.0
    tmin, tmax = min(ts), max(ts)
    return (tmax - tmin) / tmin


class SpeedModel(Protocol):
    """What the geometric partitioner needs from a performance model."""

    def speed(self, x: float) -> float: ...

    def time(self, x: float) -> float: ...

    def alloc_at_time(self, t: float, cap: float) -> float: ...


@dataclass
class PiecewiseLinearFPM:
    """Partial piecewise-linear estimate of a speed function (the paper's FPM).

    ``xs``/``ss`` hold the sorted observed points.  ``on_duplicate`` controls
    what happens when the same problem size is re-measured: ``"replace"``
    trusts the newest observation (the paper's behaviour — later measurements
    reflect the current state of the machine), ``"mean"`` averages.
    """

    xs: List[float] = field(default_factory=list)
    ss: List[float] = field(default_factory=list)
    on_duplicate: str = "replace"

    # -- construction ------------------------------------------------------

    @classmethod
    def from_points(cls, pts: Sequence[Tuple[float, float]], **kw) -> "PiecewiseLinearFPM":
        m = cls(**kw)
        for x, s in pts:
            m.add_point(x, s)
        return m

    @classmethod
    def from_constant(cls, x: float, s: float, **kw) -> "PiecewiseLinearFPM":
        """The DFPA step-2 initial approximation: a constant model ``s(x) = s``
        anchored at the first observation ``(x, s)``."""
        return cls.from_points([(x, s)], **kw)

    # -- the paper's update rule --------------------------------------------

    def add_point(self, x: float, s: float) -> None:
        if not (x > 0.0):
            raise ValueError(f"problem size must be positive, got {x}")
        if not (s > 0.0) or not math.isfinite(s):
            raise ValueError(f"speed must be positive and finite, got {s}")
        i = bisect.bisect_left(self.xs, x)
        if i < len(self.xs) and self.xs[i] == x:
            if self.on_duplicate == "mean":
                self.ss[i] = 0.5 * (self.ss[i] + s)
            else:
                self.ss[i] = s
            return
        self.xs.insert(i, x)
        self.ss.insert(i, s)

    # -- evaluation ----------------------------------------------------------

    @property
    def num_points(self) -> int:
        return len(self.xs)

    def speed(self, x: float) -> float:
        if not self.xs:
            raise ValueError("empty FPM")
        if x <= self.xs[0]:
            return self.ss[0]
        if x >= self.xs[-1]:
            return self.ss[-1]
        k = bisect.bisect_right(self.xs, x) - 1
        x0, x1 = self.xs[k], self.xs[k + 1]
        s0, s1 = self.ss[k], self.ss[k + 1]
        w = (x - x0) / (x1 - x0)
        return s0 + w * (s1 - s0)

    def time(self, x: float) -> float:
        if x <= 0.0:
            return 0.0
        return x / self.speed(x)

    # -- the partitioner primitive -------------------------------------------

    def alloc_at_time(self, t: float, cap: float) -> float:
        """``max { x in [0, cap] : x / s(x) <= t }`` in closed form per segment.

        Within a segment ``s(x) = s0 + m (x - x0)`` the constraint
        ``x <= t * s(x)`` is linear:  ``x (1 - t m) <= t (s0 - m x0)``.
        """
        if t <= 0.0 or cap <= 0.0 or not self.xs:
            return 0.0
        best = 0.0

        # Region [0, x_1]: constant speed ss[0].
        x_lo = min(self.xs[0], cap)
        best = max(best, min(t * self.ss[0], x_lo))

        # Interior segments.
        for k in range(len(self.xs) - 1):
            x0, x1 = self.xs[k], self.xs[k + 1]
            if x0 >= cap:
                break
            x1c = min(x1, cap)
            s0 = self.ss[k]
            m = (self.ss[k + 1] - s0) / (x1 - x0)
            a = 1.0 - t * m
            b = t * (s0 - m * x0)
            if a > 0.0:
                ub = b / a
                if ub >= x0:
                    best = max(best, min(ub, x1c))
            elif a == 0.0:
                if b >= 0.0:
                    best = max(best, x1c)
            else:  # a < 0: feasible for x >= b/a; segment top is feasible
                if x1c >= b / a:
                    best = max(best, x1c)

        # Region [x_m, cap]: constant speed ss[-1].
        if cap > self.xs[-1]:
            ub = t * self.ss[-1]
            if ub >= self.xs[-1]:
                best = max(best, min(ub, cap))
        return best

    def as_points(self) -> List[Tuple[float, float]]:
        return list(zip(self.xs, self.ss))


@dataclass
class ConstantModel:
    """CPM: a single positive number.  ``time(x) = x / s``."""

    s: float

    def speed(self, x: float) -> float:  # noqa: ARG002 - constant by definition
        return self.s

    def time(self, x: float) -> float:
        return x / self.s if x > 0 else 0.0

    def alloc_at_time(self, t: float, cap: float) -> float:
        if t <= 0.0:
            return 0.0
        return min(t * self.s, cap)


@dataclass
class AnalyticModel:
    """Wraps an arbitrary ground-truth time function ``t(x)`` (used by the
    simulator and by FFMPA when the 'full model' is analytic rather than
    piecewise).  Requires ``t`` to be non-decreasing in ``x`` — true for any
    real workload (more units never take less total time) — and solves
    ``alloc_at_time`` by bisection on ``x``.
    """

    time_fn: Callable[[float], float]

    def time(self, x: float) -> float:
        return self.time_fn(x) if x > 0 else 0.0

    def speed(self, x: float) -> float:
        t = self.time(x)
        return x / t if t > 0 else math.inf

    def alloc_at_time(self, t: float, cap: float) -> float:
        if t <= 0.0 or cap <= 0.0:
            return 0.0
        if self.time(cap) <= t:
            return cap
        lo, hi = 0.0, cap  # invariant: time(lo) <= t < time(hi)
        for _ in range(96):
            mid = 0.5 * (lo + hi)
            if self.time(mid) <= t:
                lo = mid
            else:
                hi = mid
        return lo
