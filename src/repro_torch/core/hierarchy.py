"""Two-level hierarchical partitioning — outer solve over group aggregates,
inner per-group solves on each group's own sub-bank.

The paper's platforms are hierarchically heterogeneous — hosts grouped by
class, groups behind a shared interconnect — and the two-level partitioner
follows that structure:

1. **Aggregate** each group behind a composite performance model
   (``aggregate_groups`` in ``modelbank.py``): the sum of the members'
   allocations at equal time, sampled at the union of member knots, a
   ``[g, k_g]`` bank that is monotone-time by construction.
2. **Outer solve** (host numpy, as in the reference): the ordinary ``t*``
   bisection on the group bank, then floor + take-back + the greedy
   tie-break over groups, so the integer group shares sum to exactly ``n``.
3. **Inner solves**: each group's share is partitioned over its members on
   the group's ``[p_g, k]`` sub-bank.  On the numpy backend this is the
   ordinary host solve per group; on the torch backend all groups run as
   ONE stacked ``[g, p_max, k]`` partition on the card, members
   right-padded with ``caps = 0`` rows, each group's completion routed by
   its own monotone flag, and each group's float sums taken over its own
   rows in numpy's order.  The reference routes large block sets through
   a serial per-group map on the CPU (a cache-blocking choice that gives
   the same allocations); the port takes the batched form only.

The reference's ``sharding="shard_map"`` (group blocks spread over several
devices) has no counterpart on one card: this hierarchy takes no
``sharding=``, and :meth:`Hierarchy.max_shard_elems` counts all ``g``
blocks.

Telemetry (``repro_torch.obs``) is the reference's: a ``hier.outer`` span
around the outer solve, a ``hier.inner`` span around the inner solves and a
``hier.agg_cache.hit`` / ``.miss`` counter per aggregation-cache lookup.
On the torch backend ``hier.inner`` spans the one stacked ``[g, p_max, k]``
device solve (which returns host allocations, so the span covers the
device work), not the reference's per-group loop.

Exactness tiers (held by ``tests/test_torch_hierarchy.py``):

* a single group reproduces the flat solve **bit-identically**;
* multiple groups reproduce the flat **makespan** to within the
  aggregation's interpolation error;
* in float64 the torch backend's allocations and ``t_outer`` equal the
  numpy backend's bit for bit, and so does its aggregate bank.

Validation raises the flat paths' ``ValueError`` messages in the flat
paths' order, so the ``Scheduler`` facade keeps one error surface.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .modelbank import (
    ModelBank,
    _aggregate_one,
    _aggregate_times,
    _points_from_samples,
    group_members,
)
from .modelbank_torch import (
    _agg_alloc,
    _partition_units,
    ragged_order_sum,
    resolve_device,
    torch_dtype,
)
from .partition import (
    _partition_continuous_bank,
    _partition_units_bank,
    _prep_unit_caps,
)

try:  # telemetry is optional: the solver runs identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent
    def _obs_active():
        return None

__all__ = ["Hierarchy"]

# Device aggregation materializes a [g, T, p_max, k-1] product intermediate
# (plus the [g, T, p_max] allocation cube copied back to the host); route
# through it only while that stays modest, as the reference does.  Beyond
# the budget the host pass is the right tool: it runs once per fold and the
# aggregate cache serves the steady state.
_AGG_DEVICE_MAX_BYTES = 256 * 1024 * 1024


class Hierarchy:
    """Two-level partitioner over a ``groups[p]`` assignment.

    Build with :meth:`from_bank` (slices a flat bank into per-group
    sub-banks) or :meth:`from_group_banks` (per-group banks handed over
    directly; the flat ``[p, k]`` bank is never materialized and global
    processor indices run contiguously group by group).

    ``backend`` selects the inner solver: ``"torch"`` (the default) one
    stacked program over the group blocks on ``device`` (default
    ``"cuda"``; a missing card raises), ``"numpy"`` host loops per group.  Instances snapshot their
    banks at construction — rebuild after the models change.
    """

    def __init__(
        self,
        sub_banks: Sequence[ModelBank],
        members: Sequence[np.ndarray],
        p: int,
        *,
        backend: str = "torch",
        max_group_knots: int = 64,
        dtype=None,
        device="cuda",
    ):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown hierarchy backend {backend!r}")
        self.sub_banks = list(sub_banks)
        self.members = [np.asarray(m, dtype=np.int64) for m in members]
        self.p = int(p)
        self.backend = backend
        self.max_group_knots = int(max_group_knots)
        self.dtype = dtype
        self.device = resolve_device(device) if backend == "torch" else None
        self._blocks = None  # device [g, p_max, k] blocks, built lazily
        self._agg_cache: dict = {}  # caps signature -> aggregated group bank

    # -- construction --------------------------------------------------------

    @classmethod
    def from_bank(
        cls,
        bank: ModelBank,
        groups: Sequence[int],
        *,
        backend: str = "torch",
        max_group_knots: int = 64,
        dtype=None,
        device="cuda",
    ) -> "Hierarchy":
        garr = np.asarray(groups)
        if garr.ndim != 1 or garr.shape[0] != bank.p:
            raise ValueError(
                f"groups must be a length-p assignment (got shape {garr.shape} "
                f"for p={bank.p})"
            )
        _, members = group_members(groups)
        subs = [
            ModelBank(
                xs=bank.xs[idx],
                ss=bank.ss[idx],
                counts=bank.counts[idx],
                # a monotone bank has only monotone rows; a non-monotone one
                # says nothing about this group's rows — resolve lazily
                monotone=True if bank.monotone is True else None,
            )
            for idx in members
        ]
        return cls(
            subs, members, bank.p, backend=backend,
            max_group_knots=max_group_knots, dtype=dtype, device=device,
        )

    @classmethod
    def from_group_banks(
        cls,
        banks: Sequence[ModelBank],
        *,
        backend: str = "torch",
        max_group_knots: int = 64,
        dtype=None,
        device="cuda",
    ) -> "Hierarchy":
        """Build from per-group banks without materializing the flat
        ``[p, k]`` bank.  Global processor indices run contiguously group
        by group."""
        banks = list(banks)
        members: List[np.ndarray] = []
        off = 0
        for b in banks:
            members.append(np.arange(off, off + b.p, dtype=np.int64))
            off += b.p
        return cls(
            banks, members, off, backend=backend,
            max_group_knots=max_group_knots, dtype=dtype, device=device,
        )

    # -- shape ---------------------------------------------------------------

    @property
    def g(self) -> int:
        return len(self.sub_banks)

    def max_shard_elems(self) -> int:
        """Bank elements (xs plus ss knots) the inner solves materialize on
        one device: all ``g`` padded group blocks, since the port runs on a
        single card (the reference's ``shard_map`` split has no
        counterpart)."""
        p_max = max((b.p for b in self.sub_banks), default=1) or 1
        k = max((int(b.xs.shape[1]) for b in self.sub_banks), default=1)
        return 2 * self.g * p_max * k

    # -- the two-level solve -------------------------------------------------

    def partition_units(
        self,
        n: int,
        caps: Optional[Sequence[int]] = None,
        *,
        min_units: int = 0,
        completion: str = "auto",
        rel_tol: float = 1e-12,
        max_steps: int = 200,
        with_t: bool = False,
    ):
        """Integer partition of ``n`` units over all ``p`` processors.

        Validation (messages and order) mirrors the flat paths exactly.
        Returns the ``[p]`` allocation list; with ``with_t=True`` returns
        ``(allocations, t_outer)`` where ``t_outer`` is the outer solve's
        equal-time point on the group aggregates.
        """
        if completion not in ("auto", "threshold", "greedy"):
            raise ValueError(f"unknown completion mode {completion!r}")
        n = int(n)
        if isinstance(caps, np.ndarray) and caps.dtype.kind in "iu":
            # vectorized mirror of _prep_unit_caps for an integer caps array
            if n < 0:
                raise ValueError("n must be non-negative")
            if min_units * self.p > n:
                raise ValueError(
                    f"min_units={min_units} infeasible for n={n}, p={self.p}"
                )
            caps_arr = caps.astype(np.int64, copy=False)
            if min_units > 0:
                bad = caps_arr < min_units
                if bad.any():
                    i = int(np.argmax(bad))
                    raise ValueError(
                        f"min_units={min_units} infeasible: "
                        f"caps[{i}]={int(caps_arr[i])} < min_units"
                    )
        else:
            icaps = _prep_unit_caps(self.p, n, caps, min_units)
            caps_arr = np.asarray(icaps, dtype=np.int64)
        if self.p == 0:
            raise ValueError("no processors")
        if n == 0:
            out = [0] * self.p
            return (out, 0.0) if with_t else out
        clipped = np.minimum(caps_arr.astype(np.float64), float(n))
        if clipped.sum() < n:
            raise ValueError(f"infeasible: sum(caps)={clipped.sum()} < n={float(n)}")
        for sub, idx in zip(self.sub_banks, self.members):
            if np.any((caps_arr[idx] > 0) & (sub.counts == 0)):
                raise ValueError("empty FPM")

        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t0 = tel.clock()
        shares, t_outer, _ = self._outer_shares(n, caps_arr, min_units)
        if rec:
            t1 = tel.clock()
            tel.span_at("hier.outer", t0, t1, groups=self.g, n=n)

        if self.backend == "torch":
            d_full = self._inner_torch(shares, caps_arr, min_units, completion, max_steps)
        else:
            d_full = np.zeros(self.p, dtype=np.int64)
            for sub, idx, ng in zip(self.sub_banks, self.members, shares):
                if len(idx) == 0:
                    continue
                d_sub, _ = _partition_units_bank(
                    sub,
                    int(ng),
                    [int(c) for c in caps_arr[idx]],
                    min_units=min_units,
                    completion=completion,
                )
                d_full[idx] = d_sub
        if rec:
            tel.span_at("hier.inner", t1, tel.clock(),
                        groups=self.g, backend=self.backend)
        out = [int(v) for v in d_full]
        assert sum(out) == n
        return (out, float(t_outer)) if with_t else out

    def _outer_shares(
        self, n: int, caps_arr: np.ndarray, min_units: int
    ) -> Tuple[np.ndarray, float, ModelBank]:
        """Integer group shares summing to exactly ``n``: aggregate, bisect,
        floor, take back the min_units overshoot, then grant the boundary
        units between groups by the greedy tie-break
        ``(time(share+1), -frac_remainder, index)`` on the aggregate."""
        g = self.g
        gcaps_i = np.array(
            [caps_arr[idx].sum() for idx in self.members], dtype=np.int64
        )
        # The aggregate bank is cached on the instance (up to 8 banks).
        # When no member cap can bind (every cap >= n, the caps=None case)
        # the aggregate is computed cap-free, so one cached bank serves
        # every n; capped calls key on the exact caps bytes.
        uncapped = bool(np.all(caps_arr >= n))
        key = "uncapped" if uncapped else caps_arr.tobytes()
        gbank = self._agg_cache.get(key)
        tel = _obs_active()
        if tel is not None and tel.enabled:
            tel.counter(
                "hier.agg_cache.hit" if gbank is not None
                else "hier.agg_cache.miss"
            )
        if gbank is None:
            caps_f = (
                np.full(self.p, np.inf)
                if uncapped
                else caps_arr.astype(np.float64)
            )
            gbank = ModelBank.from_point_lists(self._aggregate_pts(caps_f))
            gbank.monotone = True  # by construction: knots at sorted times
            if len(self._agg_cache) >= 8:
                self._agg_cache.clear()
            self._agg_cache[key] = gbank

        floors = np.array(
            [min_units * len(idx) for idx in self.members], dtype=np.int64
        )
        xs_list, t_outer = _partition_continuous_bank(
            gbank,
            float(n),
            [min(float(c), float(n)) for c in gcaps_i],
            rel_tol=1e-12,
            max_steps=200,
        )
        xs_g = np.asarray(xs_list, dtype=np.float64)
        shares = np.maximum(floors, np.floor(xs_g).astype(np.int64))
        shares = np.minimum(shares, gcaps_i)
        leftover = int(n - shares.sum())

        if leftover < 0:
            # min_units floors overshot: take back from the groups whose
            # aggregate per-unit time is largest, round-robin (the flat
            # take-back, at group level).
            with np.errstate(invalid="ignore"):
                per_unit = gbank.time(shares.astype(np.float64)) / np.maximum(
                    shares, 1
                )
            order = sorted(range(g), key=lambda i: per_unit[i], reverse=True)
            k = 0
            while leftover < 0:
                i = order[k % g]
                if shares[i] > floors[i]:
                    shares[i] -= 1
                    leftover += 1
                k += 1

        rem = xs_g - np.floor(xs_g)
        for _ in range(leftover):
            best_i, best_key = -1, None
            for i in range(g):
                if shares[i] + 1 > gcaps_i[i]:
                    continue
                key = (gbank.time_one(i, float(shares[i] + 1)), -float(rem[i]))
                if best_key is None or key < best_key:
                    best_i, best_key = i, key
            if best_i < 0:
                raise ValueError("caps infeasible during integer completion")
            shares[best_i] += 1
        assert int(shares.sum()) == n
        return shares, float(t_outer), gbank

    def _aggregate_pts(self, caps_f: np.ndarray) -> List[Tuple[List[float], List[float]]]:
        """Per-group aggregate knot lists, evaluated on the card when the
        blocks are float64 and the intermediates stay within budget."""
        if self.backend == "torch":
            pts = self._aggregate_pts_device(caps_f)
            if pts is not None:
                return pts
        return [
            _aggregate_one(sub, caps_f[idx], self.max_group_knots)
            for sub, idx in zip(self.sub_banks, self.members)
        ]

    def _aggregate_pts_device(
        self, caps_f: np.ndarray
    ) -> Optional[List[Tuple[List[float], List[float]]]]:
        """Every group's member allocations at its sample times as one
        ``[g, T, p_max]`` device program (``modelbank_torch._agg_alloc``)
        instead of ``g`` host passes.  The sample-time grid stays on the
        host and the per-group member sum stays a host ``np.sum`` over the
        same axis as the host pass, so the aggregate bank equals the numpy
        backend's bit for bit.  Returns None (the caller falls back to the
        host loop) when the blocks are not float64 or the device
        intermediates would exceed ``_AGG_DEVICE_MAX_BYTES``."""
        ts_list = [
            _aggregate_times(sub, caps_f[idx], self.max_group_knots)
            for sub, idx in zip(self.sub_banks, self.members)
        ]
        t_max = max((int(t.size) for t in ts_list), default=0)
        if t_max == 0:
            return [([], []) for _ in ts_list]
        xs_b, ss_b, counts_b = self._ensure_blocks()
        if xs_b.dtype != torch.float64:
            return None
        p_max = int(xs_b.shape[1])
        k_b = int(xs_b.shape[2])
        # the [g, T, p, k-1] t*m product is the largest device intermediate
        if self.g * t_max * p_max * max(k_b - 1, 1) * 8 > _AGG_DEVICE_MAX_BYTES:
            return None

        ts_pad = np.ones((self.g, t_max), dtype=np.float64)
        caps_pad = np.zeros((self.g, p_max), dtype=np.float64)
        for gi, (t, idx) in enumerate(zip(ts_list, self.members)):
            if t.size:
                # pad by repeating the last sample: evaluated, then sliced
                # away before the member sum
                ts_pad[gi, : t.size] = t
                ts_pad[gi, t.size :] = t[-1]
            caps_pad[gi, : len(idx)] = caps_f[idx]
        put = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)  # noqa: E731
        out = _agg_alloc(xs_b, ss_b, counts_b, put(caps_pad), put(ts_pad)).cpu().numpy()
        pts: List[Tuple[List[float], List[float]]] = []
        for gi, (t, idx) in enumerate(zip(ts_list, self.members)):
            if t.size == 0:
                pts.append(([], []))
                continue
            xs_g = out[gi, : t.size, : len(idx)].sum(axis=1)
            pts.append(_points_from_samples(t, xs_g))
        return pts

    # -- torch inner solves --------------------------------------------------

    def _ensure_blocks(self):
        """The padded ``[g, p_max, k]`` group blocks on the device (built
        on the host once, then uploaded)."""
        if self._blocks is None:
            g = self.g
            p_max = max((b.p for b in self.sub_banks), default=0) or 1
            k = max((int(b.xs.shape[1]) for b in self.sub_banks), default=1)
            xs = np.zeros((g, p_max, k), dtype=np.float64)
            ss = np.zeros_like(xs)
            counts = np.zeros((g, p_max), dtype=np.int64)
            for gi, b in enumerate(self.sub_banks):
                pg, kb = b.xs.shape
                if pg == 0:
                    continue
                xs[gi, :pg, :kb] = b.xs
                ss[gi, :pg, :kb] = b.ss
                if kb < k:
                    # width padding repeats the last column, the
                    # from_point_lists convention (masked by counts anyway)
                    xs[gi, :pg, kb:] = b.xs[:, -1:]
                    ss[gi, :pg, kb:] = b.ss[:, -1:]
                counts[gi, :pg] = b.counts
            dt = torch_dtype(self.dtype)
            self._blocks = (
                torch.as_tensor(xs, dtype=dt, device=self.device),
                torch.as_tensor(ss, dtype=dt, device=self.device),
                torch.as_tensor(counts, device=self.device),
            )
        return self._blocks

    def _inner_torch(
        self,
        shares: np.ndarray,
        caps_arr: np.ndarray,
        min_units: int,
        completion: str,
        max_steps: int,
    ) -> np.ndarray:
        """Every group's share over its members as one stacked partition
        of the ``[g, p_max, k]`` blocks: ``n`` ``[g]`` the shares,
        ``min_units`` ``[g, p_max]`` (0 pins the padded rows), the
        completion routed per group, the float sums over each group's own
        rows (:func:`~.modelbank_torch.ragged_order_sum`)."""
        g = self.g
        p_max = max((b.p for b in self.sub_banks), default=0) or 1
        caps_blk = np.zeros((g, p_max), dtype=np.int64)
        mu_blk = np.zeros((g, p_max), dtype=np.int64)  # 0 pins padded rows
        for gi, idx in enumerate(self.members):
            caps_blk[gi, : len(idx)] = caps_arr[idx]
            mu_blk[gi, : len(idx)] = min_units
        if completion == "threshold":
            fast = np.ones(g, dtype=bool)
        elif completion == "greedy":
            fast = np.zeros(g, dtype=bool)
        else:
            # per-group auto routing: a non-monotone group demotes only its
            # own inner solve (host flags, cached per sub-bank)
            fast = np.array([b.is_monotone() for b in self.sub_banks], dtype=bool)
        xs, ss, counts = self._ensure_blocks()
        put = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)  # noqa: E731
        d, ok, _t = _partition_units(
            xs, ss, counts,
            put(caps_blk, counts.dtype),
            put(np.asarray(shares, dtype=np.int64), counts.dtype),
            put(mu_blk, counts.dtype),
            1e-12,
            max_steps,
            put(fast, torch.bool),
            completion_fast=bool(fast.any()),
            row_sum=ragged_order_sum([len(idx) for idx in self.members], self.device),
        )
        d = d.cpu().numpy()
        if not bool(ok.all()):
            raise ValueError("caps infeasible during integer completion")
        d_full = np.zeros(self.p, dtype=np.int64)
        for gi, idx in enumerate(self.members):
            d_full[idx] = d[gi, : len(idx)]
        return d_full
