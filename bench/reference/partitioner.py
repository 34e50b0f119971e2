"""A frozen copy of the host partitioner, and a replay of the DFPA loop's
decisions: the plain reference for every allocation the program's
scheduler sends out.

The partitioner is the paper's geometric algorithm on partial piecewise-
linear speed estimates, in float64 on the host, as the port's numpy bank
computes it (``src/repro_torch/core/modelbank.py`` and ``partition.py`` at
the commit this benchmark was written on, trimmed to the path a cold
``Scheduler`` takes: no caps beyond ``n``, the exact per-unit greedy
completion).  The port's device bank is held to be bit-identical to that
bank in float64, so every allocation is compared exactly.

The replay cannot run the platform: it takes the program's own measured
times round by round and works out which distribution the loop had to send
next (``Scheduler.autotune``: the even split, the fold-in of ``d_i / t_i``,
the repartition, the one-unit probe out of a fixed point, the best
distribution kept; ``Scheduler.observe``: the EMA of a distribution's
times, the fold-in, the repartition past ``eps``).  Imports numpy only.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def imbalance(times: Sequence[float]) -> float:
    """``(max - min) / min`` over the processors that ran (``t > 0``)."""
    ts = [float(t) for t in times if float(t) > 0.0]
    if len(ts) < 2:
        return 0.0
    return (max(ts) - min(ts)) / min(ts)


def even(n: int, p: int) -> List[int]:
    base, rem = divmod(n, p)
    return [base + (1 if i < rem else 0) for i in range(p)]


class Estimates:
    """Each processor's observed ``(x, s)`` points, sorted by ``x``; a point
    at an ``x`` already observed replaces it."""

    def __init__(self, p: int):
        self.points: List[Dict[float, float]] = [dict() for _ in range(p)]

    def fold_in(self, x: Sequence[float], s: Sequence[float], valid: Sequence[bool]) -> None:
        for i, (xi, si, ok) in enumerate(zip(x, s, valid)):
            if ok:
                if not (float(xi) > 0.0) or not (float(si) > 0.0) or not math.isfinite(float(si)):
                    raise ValueError(f"bad observation ({xi}, {si})")
                self.points[i][float(xi)] = float(si)

    def bank(self) -> "Bank":
        return Bank([sorted(pts.items()) for pts in self.points])


class Bank:
    """The ``p`` estimates as padded ``xs, ss [p, k]`` and ``counts [p]``."""

    def __init__(self, rows: Sequence[Sequence[Tuple[float, float]]]):
        p = len(rows)
        self.counts = np.array([len(r) for r in rows], dtype=np.int64)
        k = max(int(self.counts.max(initial=1)), 1)
        self.xs = np.zeros((p, k), dtype=np.float64)
        self.ss = np.zeros((p, k), dtype=np.float64)
        for i, r in enumerate(rows):
            if not r:
                continue
            self.xs[i, :len(r)] = [x for x, _ in r]
            self.ss[i, :len(r)] = [s for _, s in r]
            self.xs[i, len(r):] = r[-1][0]
            self.ss[i, len(r):] = r[-1][1]
        self.p = p

    def _edges(self):
        idx = np.arange(self.p)
        last = np.maximum(self.counts - 1, 0)
        return self.xs[idx, 0], self.ss[idx, 0], self.xs[idx, last], self.ss[idx, last]

    def speed(self, x) -> np.ndarray:
        x = np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))
        first_x, first_s, last_x, last_s = self._edges()
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

    def time(self, x) -> np.ndarray:
        x = np.broadcast_to(np.asarray(x, dtype=np.float64), (self.p,))
        with np.errstate(divide="ignore", invalid="ignore"):
            t = x / self.speed(x)
        return np.where(x > 0.0, t, 0.0)

    def alloc_at_time(self, t: float, caps) -> np.ndarray:
        """``max { x in [0, cap_i] : x / s_i(x) <= t }`` for every processor,
        in closed form on each segment of its estimate."""
        caps = np.broadcast_to(np.asarray(caps, dtype=np.float64), (self.p,))
        if t <= 0.0:
            return np.zeros(self.p, dtype=np.float64)
        first_x, first_s, last_x, last_s = self._edges()
        best = np.minimum(t * first_s, np.minimum(first_x, caps))
        k_max = self.xs.shape[1]
        if k_max >= 2:
            x0, x1 = self.xs[:, :-1], self.xs[:, 1:]
            s0, s1 = self.ss[:, :-1], self.ss[:, 1:]
            seg = np.arange(k_max - 1)[None, :]
            valid = (seg < (self.counts - 1)[:, None]) & (x0 < caps[:, None]) & (x1 > x0)
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
                np.where(a == 0.0, np.where(b >= 0.0, x1c, 0.0), np.where(x1c >= ub, x1c, 0.0)),
            )
            cand = np.where(valid, cand, 0.0)
            best = np.maximum(best, cand.max(axis=1))
        ub_r = t * last_s
        right = (caps > last_x) & (ub_r >= last_x) & (self.counts > 0)
        best = np.maximum(best, np.where(right, np.minimum(ub_r, caps), 0.0))
        return np.where((caps > 0.0) & (self.counts > 0), best, 0.0)

    def total_alloc(self, t: float, caps) -> float:
        return float(self.alloc_at_time(t, caps).sum())

    def time_one(self, i: int, x: float) -> float:
        if x <= 0.0:
            return 0.0
        c = int(self.counts[i])
        xs, ss = self.xs[i], self.ss[i]
        if x <= xs[0]:
            s = float(ss[0])
        elif x >= xs[c - 1]:
            s = float(ss[c - 1])
        else:
            k = int(np.searchsorted(xs[:c], x, side="right")) - 1
            w = (x - xs[k]) / (xs[k + 1] - xs[k])
            s = float(ss[k] + w * (ss[k + 1] - ss[k]))
        return x / s


def partition_continuous(bank: Bank, n: float, caps: Sequence[float], *, rel_tol: float = 1e-12,
                         max_steps: int = 200) -> Tuple[np.ndarray, float]:
    """The smallest common time ``t*`` at which the processors hold ``n``
    units, by doubling and bisection; the allocations at ``t*``, the excess
    taken back in proportion."""
    caps_arr = np.asarray([min(float(c), float(n)) for c in caps], dtype=np.float64)
    active = caps_arr > 0.0
    if np.any(active & (bank.counts == 0)):
        raise ValueError("empty estimate")
    hi = float(bank.time(np.minimum(1.0, caps_arr))[active].max(initial=0.0))
    hi = max(hi, 1e-9)
    for _ in range(200):
        if bank.total_alloc(hi, caps_arr) >= n:
            break
        hi *= 2.0
    else:
        raise RuntimeError("could not bracket t*")
    lo = 0.0
    for _ in range(max_steps):
        mid = 0.5 * (lo + hi)
        if bank.total_alloc(mid, caps_arr) >= n:
            hi = mid
        else:
            lo = mid
        if hi - lo <= rel_tol * hi:
            break
    xs = bank.alloc_at_time(hi, caps_arr)
    total = float(xs.sum())
    if total > 0 and total - n > 0:
        xs = xs - (total - n) * (xs / total)
    return xs, hi


def partition_units(bank: Bank, n: int, min_units: int) -> List[int]:
    """Integer allocations of ``n`` units: the continuous solution floored
    (at least ``min_units``), the overshoot taken back from the largest
    per-unit times, then each leftover unit to the processor with the
    smallest ``(time(d + 1), -fractional remainder, index)``."""
    p = bank.p
    if min_units * p > n:
        raise ValueError(f"min_units={min_units} infeasible for n={n}, p={p}")
    caps = np.full(p, n, dtype=np.int64)
    xs, _ = partition_continuous(bank, float(n), [float(c) for c in caps])
    d = np.minimum(np.maximum(min_units, np.floor(xs).astype(np.int64)), caps)
    leftover = int(n - d.sum())
    if leftover < 0:
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
    if leftover > 0:
        t_next = bank.time((d + 1).astype(np.float64))
        heap = [(float(t_next[i]), -float(rem[i]), i) for i in range(p) if d[i] + 1 <= caps[i]]
        heapq.heapify(heap)
        while leftover > 0:
            _, negrem, i = heapq.heappop(heap)
            d[i] += 1
            leftover -= 1
            if d[i] + 1 <= caps[i]:
                heapq.heappush(heap, (bank.time_one(i, float(d[i] + 1)), negrem, i))
    return [int(v) for v in d]


def probe_neighbour(d, times, seen, min_units) -> Optional[List[int]]:
    """The first unseen one-unit move from a slower to a faster processor."""
    p = len(d)
    for i in sorted(range(p), key=lambda i: times[i], reverse=True):
        if d[i] - 1 < min_units:
            continue
        for j in sorted(range(p), key=lambda i: times[i]):
            if i == j:
                continue
            cand = list(d)
            cand[i] -= 1
            cand[j] += 1
            if tuple(cand) not in seen:
                return cand
    return None


def _valid(d, times):
    return [di > 0 and ti > 0 for di, ti in zip(d, times)]


def replay(rounds: Sequence[Tuple[Sequence[int], Sequence[float]]], *, n: int, eps: float, min_units: int,
           balance_rounds: int, observe: bool, max_iter: int = 100, smooth: float = 0.5) -> List[str]:
    """Replay one session from a cold start: ``Scheduler.autotune`` over the
    first ``balance_rounds`` rounds, then the others at the distribution it
    left, with ``Scheduler.observe`` after each when ``observe``.  ``rounds`` holds the program's ``(d, times)`` of each
    round as run.  Returns one line for every round whose distribution is
    not the one the loop had to send, and one when the balancing stopped
    after another count of rounds."""
    p = len(rounds[0][0])
    est = Estimates(p)
    faults: List[str] = []
    seen: Dict[Tuple[int, ...], List[float]] = {}
    probes = 2 * p
    want = even(n, p)
    best_d, best_t, best_imb = None, None, math.inf
    stop_after = None
    k = 0
    while k < len(rounds) and stop_after is None:
        d, times = [int(v) for v in rounds[k][0]], [float(t) for t in rounds[k][1]]
        if d != want:
            faults.append(f"balance round {k}: sent {d}, the loop sends {want}")
        seen[tuple(d)] = times
        est.fold_in([float(v) for v in d], [di / ti if (di > 0 and ti > 0) else 1.0 for di, ti in zip(d, times)],
                    _valid(d, times))
        imb = imbalance(times)
        if imb < best_imb:
            best_d, best_t, best_imb = list(d), list(times), imb
        k += 1
        if imb <= eps:
            stop_after, final = k, list(d)
            break
        if k >= max_iter:
            stop_after, final = k, list(best_d)
            break
        nxt = partition_units(est.bank(), n, min_units)
        if tuple(nxt) in seen:
            t_seen = seen[tuple(nxt)]
            if imbalance(t_seen) < best_imb:
                best_d, best_t, best_imb = list(nxt), list(t_seen), imbalance(t_seen)
            probe = probe_neighbour(nxt, t_seen, seen, min_units) if probes > 0 else None
            if probe is None:
                stop_after, final = k, list(best_d)
                break
            probes -= 1
            nxt = probe
        want = nxt
    if stop_after is None:
        faults.append(f"the balancing had not stopped after {len(rounds)} rounds")
        return faults
    if stop_after != balance_rounds:
        faults.append(f"the balancing stopped after {balance_rounds} rounds, the loop stops after {stop_after}")
        return faults
    ema: Dict[Tuple[int, int], float] = {}
    want = final
    for k in range(balance_rounds, len(rounds)):
        d, times = [int(v) for v in rounds[k][0]], [float(t) for t in rounds[k][1]]
        if d != want:
            faults.append(f"iteration {k}: sent {d}, the loop sends {want}")
        if not observe:
            continue
        speeds, valid = [1.0] * p, [False] * p
        for i, (di, ti) in enumerate(zip(d, times)):
            if di <= 0 or ti <= 0:
                continue
            e = ema.get((i, di))
            e = ti if e is None else (1 - smooth) * e + smooth * ti
            ema[(i, di)] = e
            speeds[i], valid[i] = di / e, True
        est.fold_in([float(v) for v in d], speeds, valid)
        want = partition_units(est.bank(), n, min_units) if imbalance(times) > eps else d
    return faults
