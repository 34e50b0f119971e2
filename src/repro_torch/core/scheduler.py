"""Scheduler: the facade over the paper's partitioning lifecycle.

One session object over a :class:`~.speedstore.SpeedStore` (backend resolved
once) plus a :class:`Policy`:

  * ``partition(n, caps, min_units)`` — one optimal distribution from the
    current models (the paper's step 3); with ``objective="energy"`` /
    ``"pareto"`` / ``energy_cap=`` after ``attach_energy`` it balances
    energy or picks a point of the time/energy front (``core/energy.py``);
  * ``observe(times)``               — fold one round's measured times into
    the estimates (step 5), EMA-smoothed, repartitioning when the imbalance
    exceeds ``eps``;
  * ``repartition()``                — force a re-partition;
  * ``autotune(executor, n, eps)``   — the paper's DFPA measurement loop;
  * ``partition_grid(M, N)``         — the nested 2-D partitioner of §3.2,
    policy-selected CPM / FFMPA / DFPA-based, and ``repartition_grid``, its
    no-benchmark refresh of every column as one stacked ``[q, p, k]`` bank;
  * ``straggler_actions(times)``     — the straggler detector
    (``runtime/straggler.py``) over one round's times: REPROFILE is applied
    (``reprofile``), QUARANTINE reported for the caller's ``leave``;
  * ``resize`` / ``join`` / ``leave`` — elastic membership: survivors keep
    their estimates, joiners borrow the fastest survivor's point, and the
    session repartitions at once, on the same backend, dtype and device;
  * ``state_dict()`` / ``from_state()`` — config, estimates, EMA state and
    the current distribution round-trip, so a restored scheduler produces
    bit-identical next rounds.  ``from_state`` also reads the reference
    package's ``Scheduler.state_dict()`` as it is (``core/convert.py``).
    Neither carries the straggler detector, as in the reference.

A ``groups=`` assignment (``policy=Policy.HIER`` is its declarative
spelling, but any policy may carry groups) sends ``partition``,
``repartition`` and ``observe`` through the two-level partitioner
(``core/hierarchy.py``); the rounds of ``autotune`` repartition flat, as
the reference's do.

Every constructor defaults to ``backend="torch"`` on ``device="cuda"``: the
bank and every partition live on the card, and a missing card raises at
construction.  ``backend="numpy"`` / ``"scalar"`` keep their host meaning
(the parity references), and ``device="cpu"`` runs the torch bank on the
host.

The grid's per-column inner DFPA loops run through the multi-tenant fleet
(``repro_torch.fleet.FleetScheduler``), as the reference's do: every column
re-benchmarked in an outer round is one job of one fleet, so on the torch
backend each inner round is one stacked ``[q, p, k]`` partition and one
stacked fold-in, with results bit-identical to sequential child
``autotune`` loops.

With a ``repro_torch.obs`` sink installed (or ``torch.profiler``
recording) the session records the reference's telemetry:
``scheduler.partition`` and ``scheduler.autotune`` spans,
``scheduler.observe`` counters and ``scheduler.reprofile`` events; and the
port's own ``scheduler.observe`` span and ``scheduler.repartition`` counter.
``autotune`` and ``observe`` repartition through the store, so their rounds
record ``speedstore.partition`` spans (or ``hier.*`` spans under
``groups=``), not ``scheduler.partition``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .executor import BatchedSimulatedExecutor2D, Executor
from .fpm import AnalyticModel, PiecewiseLinearFPM, imbalance
from .hierarchy import Hierarchy
from .modelbank import ModelBank
from .modelbank_torch import TorchModelBank, resolve_device
from .partition2d import _col_times, _flat_imbalance, _rebalance_widths
from .speedstore import BACKENDS, SpeedStore

try:  # telemetry is optional: the scheduler runs identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent
    def _obs_active():
        return None

__all__ = ["Policy", "Partition", "Scheduler"]


class Policy(Enum):
    """Which performance-model policy drives the distribution.

    * ``CPM``    — constant performance models (the conventional baseline);
    * ``FFMPA``  — pre-built full functional models (partition once);
    * ``DFPA``   — the paper's algorithm: partial models built online;
    * ``GRID2D`` — the nested 2-D DFPA partitioner of §3.2 (requires
      ``grid=``);
    * ``HIER``   — the two-level partitioner (requires ``groups=``).
    """

    CPM = "cpm"
    FFMPA = "ffmpa"
    DFPA = "dfpa"
    GRID2D = "grid2d"
    HIER = "hier"


@dataclass
class Partition:
    """One partitioning outcome — the single result type of the facade.

    For 1-D partitions ``allocations[i]`` is processor ``i``'s unit count.
    For grid partitions ``col_widths``/``row_heights`` are authoritative and
    ``allocations`` flattens the row heights column-major
    (``[rows[j][i] for j for i]``).
    """

    allocations: List[int]
    t_star: Optional[float]  # continuous equal-time point (None for grid/loop results)
    makespan: Optional[float]  # estimated (or measured) slowest-processor time
    imbalance: float  # max |t_i - t_j| / t_i over working processors
    converged: bool
    iterations: int
    policy: Policy
    backend: str
    times: Optional[List[float]] = None  # per-processor times backing the metrics
    col_widths: Optional[List[int]] = None  # grid only
    row_heights: Optional[List[List[int]]] = None  # grid only
    diagnostics: Dict[str, Any] = field(default_factory=dict)

    @property
    def d(self) -> List[int]:
        """Alias for ``allocations`` (the paper's output array ``d``)."""
        return self.allocations


def _even(n: int, p: int) -> List[int]:
    base, rem = divmod(n, p)
    return [base + (1 if i < rem else 0) for i in range(p)]


def _probe_neighbour(d, times, seen, caps, min_units):
    """First unseen 1-unit transfer from slower to faster processors (the
    deterministic fixed-point escape of the DFPA loop)."""
    p = len(d)
    order_slow = sorted(range(p), key=lambda i: times[i], reverse=True)
    order_fast = sorted(range(p), key=lambda i: times[i])
    for i in order_slow:
        if d[i] - 1 < min_units:
            continue
        for j in order_fast:
            if i == j:
                continue
            if caps is not None and d[j] + 1 > caps[j]:
                continue
            cand = list(d)
            cand[i] -= 1
            cand[j] += 1
            if tuple(cand) not in seen:
                return cand
    return None


_UNSET = object()


class Scheduler:
    """Session-style facade over the self-adaptable partitioning lifecycle.

    Construct from a :class:`SpeedStore` (or let the constructor build one:
    ``num_groups`` empty estimates for the online loop, or nothing yet for a
    cold ``autotune``), pick a :class:`Policy`, then drive the lifecycle
    methods.  The backend and device are fixed at construction.
    """

    def __init__(
        self,
        store: Optional[SpeedStore] = None,
        *,
        policy: Policy = Policy.DFPA,
        grid: Optional[Sequence[Sequence[Any]]] = None,
        n_units: Optional[int] = None,
        num_groups: Optional[int] = None,
        eps: float = 0.1,
        min_units: int = 0,
        caps: Optional[Sequence[int]] = None,
        smooth: float = 0.5,
        backend: str = "torch",
        detector: Optional[Any] = None,
        analytic_tol: Optional[float] = None,
        completion: str = "auto",
        groups: Optional[Sequence[int]] = None,
        max_group_knots: int = 64,
        device="cuda",
        dtype=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if completion not in ("auto", "threshold", "greedy"):
            raise ValueError(f"unknown completion mode {completion!r}")
        if policy is Policy.HIER and groups is None:
            raise ValueError("policy=HIER requires a groups= assignment")
        # "auto" = threshold count on monotone banks on the device bank, the
        # exact per-unit greedy otherwise (always on the numpy host path).
        self.completion = completion
        self.policy = policy
        self.grid = grid
        self.eps = float(eps)
        self.min_units = int(min_units)
        self.caps = list(caps) if caps is not None else None
        self.smooth = float(smooth)
        self.n_units = int(n_units) if n_units is not None else None
        self.analytic_tol = analytic_tol
        self._backend = backend
        on_card = (store.backend if store is not None else backend) == "torch"
        self._device = resolve_device(device) if on_card else device
        self._dtype = dtype
        if store is None and num_groups is not None:
            store = SpeedStore.empty(
                int(num_groups), backend=backend, dtype=dtype, device=self._device
            )
        self.store = store
        self.detector = detector
        # two-level routing (core/hierarchy.py): a groups= assignment sends
        # every flat partition through the hierarchy
        self.groups = [int(v) for v in groups] if groups is not None else None
        self.max_group_knots = int(max_group_knots)
        # online state
        self.d: List[int] = (
            _even(self.n_units, self.num_groups)
            if self.n_units is not None and self.num_groups
            else []
        )
        self._ema: Dict[Tuple[int, int], float] = {}
        self.rebalances = 0
        self.steps_observed = 0

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_models(
        cls,
        models: Sequence[Any],
        *,
        backend: str = "torch",
        policy: Policy = Policy.DFPA,
        analytic_tol: Optional[float] = None,
        analytic_hi: Optional[float] = None,
        device="cuda",
        dtype=None,
        **kw,
    ) -> "Scheduler":
        store = SpeedStore.from_models(
            models, backend=backend, analytic_tol=analytic_tol,
            analytic_hi=analytic_hi, device=device, dtype=dtype,
        )
        return cls(store, policy=policy, backend=store.backend, device=device, dtype=dtype, **kw)

    @classmethod
    def from_speeds(
        cls, speeds: Sequence[float], *, policy: Policy = Policy.CPM,
        backend: str = "torch", device="cuda", **kw,
    ) -> "Scheduler":
        store = SpeedStore.from_speeds(speeds, backend=backend, device=device)
        return cls(store, policy=policy, backend=backend, device=device, **kw)

    # -- shape / introspection ------------------------------------------------

    @property
    def num_groups(self) -> int:
        return self.store.p if self.store is not None else 0

    @property
    def backend(self) -> str:
        return self.store.backend if self.store is not None else self._backend

    @property
    def models(self) -> List[Any]:
        return self.store.models

    @property
    def dtype(self):
        """The session's device-bank dtype policy (the store's, when one
        exists)."""
        return self.store.dtype if self.store is not None else self._dtype

    def _completion_for(self, store: SpeedStore) -> str:
        """``"threshold"`` is demoted to ``"auto"`` on scalar-backed stores
        (they only have the exact per-unit loop)."""
        if self.completion == "threshold" and store.backend == "scalar":
            return "auto"
        return self.completion

    # -- two-level routing (core/hierarchy.py) --------------------------------

    def set_groups(self, groups: Optional[Sequence[int]]) -> None:
        """Replace (or, with ``None``, clear) the two-level assignment; the
        next partition routes through the new grouping.  The models are
        untouched."""
        if groups is None:
            if self.policy is Policy.HIER:
                raise ValueError("policy=HIER requires a groups= assignment")
            self.groups = None
            return
        if len(groups) != self.num_groups:
            raise ValueError(
                f"groups must be a length-p assignment "
                f"(got {len(groups)} for p={self.num_groups})"
            )
        self.groups = [int(v) for v in groups]

    def _hier_partition(self, n, caps, mu) -> Tuple[List[int], float]:
        store = self.store
        if store.backend == "scalar":
            raise ValueError(
                "hierarchical partitioning requires a banked store "
                '(backend "numpy" or "torch")'
            )
        on_card = store.backend == "torch"
        h = Hierarchy.from_bank(
            store.bank(),
            self.groups,
            backend="torch" if on_card else "numpy",
            max_group_knots=self.max_group_knots,
            dtype=self.dtype,
            device=store.device if on_card else "cpu",
        )
        return h.partition_units(
            n, caps, min_units=mu,
            completion=self._completion_for(store), with_t=True,
        )

    @property
    def imbalance_estimate(self) -> float:
        ts = [
            m.time(di)
            for m, di in zip(self.store.models, self.d)
            if di > 0 and getattr(m, "num_points", 1)
        ]
        return imbalance(ts)

    # -- one-shot partitioning (paper step 3) ---------------------------------

    def partition(
        self,
        n: Optional[int] = None,
        caps: Optional[Sequence[int]] = None,
        min_units: Optional[int] = None,
        *,
        eps: Optional[float] = None,
        persist_caps: bool = False,
        objective: str = "time",
        energy_cap: Optional[float] = None,
    ) -> Partition:
        """Compute one optimal distribution from the current models and make
        it the scheduler's current distribution ``d``.  Per-call ``caps``
        apply to this call only unless ``persist_caps=True``.  A grid
        scheduler takes ``n=(M, N)`` and partitions through
        :meth:`partition_grid`.

        ``objective``/``energy_cap`` route the bi-objective dispatch (see
        ``core/energy.py``; call :meth:`attach_energy` first): ``"energy"``
        balances per-processor energy, ``"pareto"`` picks the knee of the
        makespan/energy front — or, with ``energy_cap``, the fastest point
        within the budget.  Not supported in grid or hierarchical mode.
        """
        if self.grid is not None:
            if objective != "time" or energy_cap is not None:
                raise ValueError("grid scheduler: objective='time' only")
            if isinstance(n, (tuple, list)) and len(n) == 2:
                return self.partition_grid(int(n[0]), int(n[1]), eps=eps)
            raise ValueError("grid scheduler: pass n=(M, N) or call partition_grid()")
        if n is None:
            n = self.n_units
        if n is None:
            raise ValueError("no unit count: pass n or construct with n_units")
        n = int(n)
        self.n_units = n
        caps_now = self.caps
        if caps is not None:
            caps_now = list(caps)
            if persist_caps:
                self.caps = list(caps)
        mu = self.min_units if min_units is None else int(min_units)
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t0 = tel.clock()
        if self.groups is not None:
            if objective != "time" or energy_cap is not None:
                raise ValueError("hierarchical scheduler: objective='time' only")
            d, t_star = self._hier_partition(n, caps_now, mu)
        else:
            d, t_star = self.store.partition(
                n, caps_now, min_units=mu, completion=self._completion_for(self.store),
                objective=objective, energy_cap=energy_cap,
            )
        if rec:
            tel.span_at("scheduler.partition", t0, tel.clock(),
                        n=n, objective=objective,
                        hier=self.groups is not None)
        self.d = list(d)
        return self._flat_result(d, t_star, eps=self.eps if eps is None else eps)

    def attach_energy(self, models: Sequence) -> "Scheduler":
        """Attach per-processor energy models (energy-rate FPMs, see
        ``core/energy.py:energy_model``), enabling the ``objective=`` /
        ``energy_cap=`` dispatch and :meth:`pareto_front`."""
        self.store.attach_energy(models)
        return self

    def pareto_front(self, n: Optional[int] = None, caps=None, *,
                     min_units: Optional[int] = None, num_points: int = 17):
        """The makespan/total-energy Pareto front for ``n`` units (energy
        models must be attached).  Does not update ``d``."""
        if n is None:
            n = self.n_units
        if n is None:
            raise ValueError("no unit count: pass n or construct with n_units")
        mu = self.min_units if min_units is None else int(min_units)
        return self.store.pareto_front(
            int(n), self.caps if caps is None else caps,
            min_units=mu, num_points=num_points,
            completion=self._completion_for(self.store),
        )

    def repartition(self) -> Partition:
        """Force a re-partition from the current estimates."""
        old = list(self.d)
        part = self.partition(self.n_units, min_units=self.min_units)
        if old and part.allocations != old:
            self.rebalances += 1
        return part

    def _flat_result(self, d: List[int], t_star: Optional[float], *, eps: float) -> Partition:
        times = self.store.times([float(v) for v in d])
        pts = self.store.num_points
        valid = [
            float(t)
            for t, di, k in zip(times, d, pts)
            if di > 0 and k > 0 and np.isfinite(t)
        ]
        imb = imbalance(valid)
        return Partition(
            allocations=list(d),
            t_star=t_star,
            makespan=max(valid) if valid else None,
            imbalance=imb,
            converged=imb <= eps,
            iterations=0,
            policy=self.policy,
            backend=self.backend,
            times=[float(t) if np.isfinite(t) else 0.0 for t in times],
        )

    # -- the online loop (paper steps 4-5) ------------------------------------

    def observe(self, times: Sequence[float]) -> bool:
        """Fold one round's per-group times in; returns True if the
        distribution changed (callers must re-split the next round's units).
        EMA smoothing (``smooth``) de-noises wall-clock measurements.

        Records a ``scheduler.observe`` span around the whole call and a
        ``scheduler.repartition`` counter when the distribution changed."""
        tel = _obs_active()
        if tel is None or not tel.enabled:
            return self._observe(times)
        t0 = tel.clock()
        changed = self._observe(times)
        if changed:
            tel.counter("scheduler.repartition")
        tel.span_at("scheduler.observe", t0, tel.clock(), repartitioned=changed)
        return changed

    def _observe(self, times: Sequence[float]) -> bool:
        if len(times) != self.num_groups:
            raise ValueError("times length != num_groups")
        if self.n_units is None:
            raise ValueError("observe() needs n_units (construct with n_units=...)")
        self.steps_observed += 1
        speeds = [1.0] * self.num_groups
        valid = [False] * self.num_groups
        for i, (di, ti) in enumerate(zip(self.d, times)):
            if di <= 0 or ti <= 0:
                continue
            key = (i, di)
            ema = self._ema.get(key)
            ema = ti if ema is None else (1 - self.smooth) * ema + self.smooth * ti
            self._ema[key] = ema
            speeds[i], valid[i] = di / ema, True
        self.store.fold_in([float(di) for di in self.d], speeds, valid)
        tel = _obs_active()
        if tel is not None and tel.enabled:
            tel.counter("scheduler.observe")
        if imbalance(times) <= self.eps:  # zero-allocation groups are ignored
            return False
        if self.groups is not None:
            new_d, _ = self._hier_partition(self.n_units, self.caps, self.min_units)
        else:
            new_d = self.store.partition_units(
                self.n_units, self.caps, min_units=self.min_units,
                completion=self._completion_for(self.store),
            )
        if new_d == self.d:
            return False
        self.d = new_d
        self.rebalances += 1
        return True

    # -- the DFPA measurement loop --------------------------------------------

    def autotune(
        self,
        executor: Executor,
        n: Optional[int] = None,
        eps: Optional[float] = None,
        *,
        max_iter: int = 100,
        caps: Optional[Sequence[int]] = None,
        min_units: Optional[int] = None,
        warm_start_d: Optional[Sequence[int]] = None,
        probe_budget: Optional[int] = None,
    ) -> Partition:
        """Run the paper's DFPA loop over ``executor``:

          1. run the even distribution (or the warm-start partition when the
             store already holds estimates), gather times;
          2. imbalance <= eps -> done;
          3. fold observations into the partial FPM estimates;
          4. re-partition optimally for the current estimates, execute,
             measure; goto 3 — with the deterministic local-probe escape
             when the partitioner reaches a fixed point short of eps.

        Leaves the scheduler warm: the estimates, ``n_units`` and the final
        distribution stay on the session.
        """
        p = executor.num_procs
        if p < 1:
            raise ValueError("need at least one processor")
        n = int(n if n is not None else self.n_units)
        if n < p:
            raise ValueError(f"DFPA requires n >= p (n={n}, p={p})")
        eps = float(eps if eps is not None else self.eps)
        if eps <= 0:
            raise ValueError("eps must be positive")
        if caps is None:
            caps = self.caps
        mu = self.min_units if min_units is None else int(min_units)

        if self.store is None:
            self.store = SpeedStore.empty(
                p, backend=self._backend, dtype=self._dtype, device=self._device
            )
        elif self.store.p != p:
            raise ValueError(
                f"store has {self.store.p} models but executor has {p} processors"
            )
        store = self.store
        models = store.models

        history: List[Tuple[List[int], List[float]]] = []
        seen: Dict[Tuple[int, ...], List[float]] = {}
        if probe_budget is None:
            probe_budget = 2 * p
        probes_left = probe_budget
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        t_tune = tel.clock() if rec else 0.0

        def measure(d: List[int]) -> List[float]:
            times = executor.run(d)
            history.append((list(d), list(times)))
            seen[tuple(d)] = list(times)
            darr = [float(di) for di in d]
            sarr = [di / ti if (di > 0 and ti > 0) else 1.0 for di, ti in zip(d, times)]
            valid = [di > 0 and ti > 0 for di, ti in zip(d, times)]
            store.fold_in(darr, sarr, valid)  # s_i(d_i) = d_i / t_i
            return list(times)

        def repartition() -> List[int]:
            return store.partition_units(
                n, caps, min_units=mu, completion=self._completion_for(store)
            )

        # Step 1: initial distribution — even split (paper), or the
        # warm-start partition when prior estimates exist.
        if warm_start_d is not None:
            d = list(map(int, warm_start_d))
            if sum(d) != n or len(d) != p:
                raise ValueError("warm_start_d must be a length-p partition of n")
        elif all(getattr(m, "num_points", 0) > 0 for m in models):
            d = repartition()
        else:
            d = _even(n, p)
        times = measure(d)
        it = 1

        best_d, best_t, best_imb = list(d), list(times), imbalance(times)

        def finish(d, t, it, converged, imb) -> Partition:
            self.n_units = n
            self.d = list(d)
            self.eps = eps
            if rec:
                tel.span_at("scheduler.autotune", t_tune, tel.clock(),
                            n=n, iterations=it, converged=bool(converged),
                            imbalance=float(imb),
                            probes_used=probe_budget - probes_left)
            return Partition(
                allocations=list(d),
                t_star=None,
                makespan=max(t) if t else None,
                imbalance=imb,
                converged=converged,
                iterations=it,
                policy=self.policy,
                backend=store.backend,
                times=list(t),
                diagnostics={
                    "history": history,
                    "models": models,
                    "probes_used": probe_budget - probes_left,
                },
            )

        while True:
            imb = imbalance(times)
            if imb < best_imb:
                best_d, best_t, best_imb = list(d), list(times), imb
            if imb <= eps:
                return finish(list(d), list(times), it, True, imb)
            if it >= max_iter:
                return finish(best_d, best_t, it, False, best_imb)
            # Steps 3+5 happened inside measure(); step 4: re-partition.
            d_new = repartition()
            if tuple(d_new) in seen:
                t_seen = seen[tuple(d_new)]
                imb_seen = imbalance(t_seen)
                if imb_seen < best_imb:
                    best_d, best_t, best_imb = list(d_new), list(t_seen), imb_seen
                probe = (
                    _probe_neighbour(d_new, t_seen, seen, caps, mu)
                    if probes_left > 0
                    else None
                )
                if probe is None:
                    return finish(best_d, best_t, it, best_imb <= eps, best_imb)
                probes_left -= 1
                d_new = probe
            d = d_new
            times = measure(d)
            it += 1

    # -- straggler detection --------------------------------------------------

    def straggler_actions(self, times: Sequence[float], *, auto_reprofile: bool = True):
        """Scan one round's observed times against the models' predictions
        (the host bank, ``store.bank()``); returns one ``StragglerAction``
        per group.  REPROFILE actions are applied automatically (stale
        estimates invalidated) unless ``auto_reprofile=False``; QUARANTINE
        is reported for the caller to act on (``leave(group)``)."""
        from ..runtime.straggler import StragglerAction, StragglerDetector

        if self.detector is None:
            self.detector = StragglerDetector()
        actions = self.detector.update_batch(self.store.bank(), self.d, times)
        if auto_reprofile:
            for g, act in enumerate(actions):
                if act is StragglerAction.REPROFILE:
                    self.reprofile(g)
        return actions

    def reprofile(self, group: int) -> None:
        """Invalidate a group's estimate (keep only the point at its current
        allocation, so the partitioner stays feasible), clear its EMA state
        and drop the device carry, which is rebuilt lazily."""
        tel = _obs_active()
        if tel is not None and tel.enabled:
            tel.event("scheduler.reprofile", group=int(group))
        m = self.store.models[group]
        if getattr(m, "num_points", 0) > 1:
            di = self.d[group] if self.d else 0
            pts = [(x, s) for x, s in m.as_points() if x == float(di)]
            self.store.reset_row(group, pts)
        for k in [k for k in self._ema if k[0] == group]:
            del self._ema[k]
        if self.store._tbank is not None:
            self.store.drop_carry()

    # -- elastic membership ---------------------------------------------------

    def resize(
        self,
        surviving: Sequence[int],
        joined: int = 0,
        *,
        caps=_UNSET,
    ) -> "Scheduler":
        """New scheduler for a changed group set: survivors keep their FPM
        points (§3.2's reuse of previous benchmarks); joiners start from an
        optimistic single-point estimate borrowed from the fastest survivor
        (corrected by their first measurement).  The new store has this
        session's backend, dtype and device, so a session on the card stays
        on the card.  Re-partitions immediately when every group has at
        least one point."""
        old_models = self.store.models
        models: List[PiecewiseLinearFPM] = [
            PiecewiseLinearFPM.from_points(old_models[i].as_points()) for i in surviving
        ]
        donor = None
        donor_pos = 0
        for pos, m in enumerate(models):
            if m.num_points:
                cand = max(m.as_points(), key=lambda pt: pt[1])
                if donor is None or cand[1] > donor[1]:
                    donor, donor_pos = cand, pos
        for _ in range(joined):
            models.append(
                PiecewiseLinearFPM.from_points([donor]) if donor else PiecewiseLinearFPM()
            )
        if caps is _UNSET:
            if self.caps is None:
                caps = None
            else:
                # joiners inherit n_units as their cap, or the most generous
                # survivor cap while the session has no unit count yet
                join_cap = (
                    self.n_units
                    if self.n_units is not None
                    else max((self.caps[i] for i in surviving), default=None)
                )
                if joined and join_cap is None:  # no survivors, no n_units
                    caps = None
                else:
                    caps = [self.caps[i] for i in surviving] + [join_cap] * joined
        groups = None
        if self.groups is not None:
            # survivors keep their group ids; joiners enter the donor's group
            groups = [self.groups[i] for i in surviving]
            join_group = groups[donor_pos] if groups else 0
            groups = groups + [join_group] * joined
        # the detector's strike counts are keyed by group index: remap them
        # (departed groups drop out, joiners start clean)
        detector = (
            self.detector.remap(surviving, joined)
            if self.detector is not None
            else None
        )
        store = self.store
        new = Scheduler(
            SpeedStore.from_models(
                models, backend=self.backend, dtype=self.dtype, device=store.device
            ),
            policy=self.policy,
            n_units=self.n_units,
            eps=self.eps,
            min_units=self.min_units,
            caps=caps,
            smooth=self.smooth,
            backend=self.backend,
            detector=detector,
            completion=self.completion,
            groups=groups,
            max_group_knots=self.max_group_knots,
            device=store.device,
            dtype=self.dtype,
        )
        if all(m.num_points for m in models) and new.n_units is not None:
            new.d = new.store.partition_units(
                new.n_units, new.caps, min_units=new.min_units,
                completion=new._completion_for(new.store),
            )
        return new

    def _adopt(self, other: "Scheduler") -> None:
        self.store = other.store
        self.d = list(other.d)
        self.caps = other.caps
        self.groups = list(other.groups) if other.groups is not None else None
        self._ema = {}  # group indices shifted; stale EMA keys are invalid
        self.detector = other.detector  # remapped by resize() for the same reason

    def join(self, count: int = 1, *, caps=_UNSET) -> "Scheduler":
        """``count`` new groups join; warm re-partition, in place."""
        self._adopt(self.resize(list(range(self.num_groups)), joined=count, caps=caps))
        return self

    def leave(self, groups, *, caps=_UNSET) -> "Scheduler":
        """Group (or groups) leave; survivors keep their estimates and the
        units are redistributed immediately, in place."""
        gone = {int(groups)} if np.isscalar(groups) else {int(g) for g in groups}
        surviving = [i for i in range(self.num_groups) if i not in gone]
        self._adopt(self.resize(surviving, caps=caps))
        return self

    # -- nested 2-D partitioning (paper §3.2) ---------------------------------

    def partition_grid(
        self,
        M: int,
        N: int,
        *,
        eps: Optional[float] = None,
        max_outer: int = 40,
        inner_max_iter: int = 15,
        width_tol: float = 0.02,
        min_units: int = 1,
    ) -> Partition:
        """Partition an ``M x N`` block matrix over the ``p x q`` grid of
        speed functions the scheduler was constructed with, by the policy:

          * ``GRID2D`` / ``DFPA`` — the paper's nested algorithm: per-column
            DFPA row partitions (online partial models), outer column-width
            rebalancing, with all of §3.2's cost optimizations;
          * ``FFMPA`` — full models given, zero benchmark cost (with
            ``analytic_tol`` the analytic models are sample-and-banked onto
            the session's bank backend);
          * ``CPM``   — one benchmark round, proportional split.

        ``grid[i][j](m_b, n_b)`` is processor ``(i, j)``'s speed in units/s
        for an ``m_b x n_b`` block: a simulator's ground truth, or a
        callable that runs and times the block (each call is then one
        measurement).
        """
        if self.grid is None:
            raise ValueError("no grid: construct Scheduler(grid=...) first")
        eps = float(eps if eps is not None else self.eps)
        if self.policy in (Policy.GRID2D, Policy.DFPA):
            return self._grid_dfpa(
                M, N, eps, max_outer=max_outer, inner_max_iter=inner_max_iter,
                width_tol=width_tol, min_units=min_units,
            )
        if self.policy is Policy.FFMPA:
            return self._grid_ffmpa(M, N, eps, max_outer=max_outer)
        if self.policy is Policy.CPM:
            return self._grid_cpm(M, N)
        raise ValueError(f"policy {self.policy} cannot partition a grid")

    def _grid_result(
        self, widths, rows, outer, total_rounds, bench_cost, converged, imb, times
    ) -> Partition:
        flat = [int(r) for col in rows for r in col]
        flat_t = [t for col in times for t in col]
        pos = [t for t in flat_t if t > 0]
        return Partition(
            allocations=flat,
            t_star=None,
            makespan=max(pos) if pos else None,
            imbalance=imb,
            converged=converged,
            iterations=outer,
            policy=self.policy,
            backend=self.backend,
            times=flat_t,
            col_widths=list(widths),
            row_heights=[list(r) for r in rows],
            diagnostics={"total_rounds": total_rounds, "bench_cost": bench_cost,
                         "times": [list(t) for t in times]},
        )

    def _bank_backend(self) -> str:
        """The bank backend of the CPM and banked-FFMPA column stores: the
        session's device bank on ``"torch"``, the host bank otherwise."""
        return "torch" if self._backend == "torch" else "numpy"

    def _grid_dfpa(
        self, M, N, eps, *, max_outer, inner_max_iter, width_tol, min_units
    ) -> Partition:
        grid = self.grid
        p, q = len(grid), len(grid[0])
        widths = [N // q + (1 if j < N % q else 0) for j in range(q)]
        rows: List[Optional[List[int]]] = [None] * q  # warm-start rows per column
        # FPM estimates per (i, j), in ROW units at the width they were
        # observed; reused across widths by rescaling rows/s by (old_w/new_w).
        fpms: List[List[PiecewiseLinearFPM]] = [
            [PiecewiseLinearFPM() for _ in range(q)] for _ in range(p)
        ]
        fpm_width: List[List[Optional[int]]] = [[None] * q for _ in range(p)]

        total_rounds = 0
        bench_cost = 0.0
        times: List[List[float]] = [[0.0] * p for _ in range(q)]
        prev_widths: Optional[List[int]] = None
        best: Optional[Partition] = None

        # The per-column inner DFPA loops run through the fleet driver: the
        # columns re-benchmarked in an outer round become jobs of ONE
        # FleetScheduler on the session's backend, dtype and device, so
        # their measurement rounds advance in lock-step (one stacked device
        # partition and fold-in per inner round on the torch backend).  Per
        # column the results are bit-identical to sequential child
        # Scheduler.autotune loops, and each job's bench cost sums its
        # rounds' max(times) + alpha + beta * p in round order.
        from ..fleet import FleetScheduler, JobSpec

        for outer in range(1, max_outer + 1):
            col_round_costs = [0.0] * q
            run_cols: List[int] = []
            for j in range(q):
                if (
                    prev_widths is not None
                    and rows[j] is not None
                    and widths[j] == prev_widths[j]
                ):
                    # Paper's optimization: width unchanged -> keep the
                    # column's partition; no re-benchmark needed.
                    times[j] = _col_times(grid, j, widths, rows[j])
                else:
                    run_cols.append(j)
            if run_cols:
                fleet = FleetScheduler(
                    p, backend=self._backend, dtype=self.dtype, device=self._device
                )
                for j in run_cols:
                    w = widths[j]
                    # Rescale surviving FPM points to the new width (g ~
                    # const in w): one batched speed-scale over the column's
                    # bank.
                    warm = None
                    if all(
                        fpm_width[i][j] is not None and fpms[i][j].num_points > 0
                        for i in range(p)
                    ):
                        col_bank = ModelBank.from_models([fpms[i][j] for i in range(p)])
                        scale = [fpm_width[i][j] / w for i in range(p)]
                        warm = col_bank.scaled(scale).to_models()
                    fleet.admit(
                        JobSpec(
                            name=f"col{j}", n=M, eps=eps, min_units=min_units,
                            max_iter=inner_max_iter, completion=self.completion,
                            warm_start_d=rows[j],
                            # Probe fixed points only on the COLD first
                            # partition of a column; warm refinements rely on
                            # the outer width update for fresh information
                            # (unbounded probing churns rounds).
                            probe_budget=p if warm is None else 0,
                        ),
                        models=warm,
                    )

                def col_batch_time(X, cols=tuple(run_cols), ws=tuple(widths)):
                    # one speed-function call per measured (column, row)
                    T = np.zeros_like(X)
                    for k, j in enumerate(cols):
                        w = ws[j]
                        for i in range(p):
                            r = X[k, i]
                            T[k, i] = (
                                (r * w) / grid[i][j](float(r), float(w)) if r > 0 else 0.0
                            )
                    return T

                fleet.run(
                    BatchedSimulatedExecutor2D(
                        time_fn_batch_2d=col_batch_time, p=p, q=len(run_cols),
                        job_names=[f"col{j}" for j in run_cols],
                    )
                )
                for j in run_cols:
                    res = fleet.result(f"col{j}")
                    rows[j] = list(res.allocations)
                    times[j] = list(res.times)
                    col_models = res.diagnostics["models"]
                    for i in range(p):
                        fpms[i][j] = col_models[i]
                        fpm_width[i][j] = widths[j]
                    total_rounds += res.iterations
                    col_round_costs[j] = res.diagnostics["bench_cost"]
            # Columns run their inner DFPA in parallel -> cost = slowest col.
            bench_cost += max(col_round_costs) if col_round_costs else 0.0

            imb = _flat_imbalance(times)
            snap = self._grid_result(
                widths, rows, outer, total_rounds, bench_cost, imb <= eps, imb, times
            )
            if best is None or imb < best.imbalance:
                best = snap
            if imb <= eps:
                return snap

            # Outer step (ii): columns' widths ∝ column speed sums (damped).
            # Paper's freeze optimization: revert sub-tolerance width changes
            # (skipping their columns' re-benchmark next round) and hand the
            # residual to the columns that did move.
            prev_widths = list(widths)
            widths = _rebalance_widths(widths, times, rows, N)
            moved = [
                j for j in range(q)
                if abs(widths[j] - prev_widths[j]) > width_tol * prev_widths[j]
            ]
            if moved and len(moved) < q:
                for j in range(q):
                    if j not in moved:
                        widths[j] = prev_widths[j]
                diff = N - sum(widths)
                k = 0
                while diff != 0:
                    j = moved[k % len(moved)]
                    step = 1 if diff > 0 else -1
                    if widths[j] + step >= 1:
                        widths[j] += step
                        diff -= step
                    k += 1
            elif not moved:
                widths = list(prev_widths)

        return self._grid_result(
            best.col_widths, best.row_heights, max_outer, total_rounds,
            bench_cost, best.converged, best.imbalance, best.diagnostics["times"],
        )

    def _grid_cpm(self, M, N) -> Partition:
        """The conventional baseline: ONE benchmark round at the even
        distribution gives each processor a speed constant; rows/columns
        split proportionally.  ``diagnostics["bench_cost"]`` carries the
        single round's cost."""
        grid = self.grid
        p, q = len(grid), len(grid[0])
        w0, r0 = N // q, M // p
        speeds = [[grid[i][j](float(r0), float(w0)) for j in range(q)] for i in range(p)]
        bench_cost = max(
            (r0 * w0) / speeds[i][j] for i in range(p) for j in range(q)
        )
        col_speed = [sum(speeds[i][j] for i in range(p)) for j in range(q)]
        kw = dict(backend=self._bank_backend(), device=self._device)
        widths = SpeedStore.from_speeds(col_speed, **kw).partition_units(N)
        rows = [
            SpeedStore.from_speeds([speeds[i][j] for i in range(p)], **kw).partition_units(M)
            for j in range(q)
        ]
        times = [_col_times(grid, j, widths, rows[j]) for j in range(q)]
        return self._grid_result(
            widths, rows, 1, 1, bench_cost, True, _flat_imbalance(times), times
        )

    def _grid_ffmpa(self, M, N, eps, *, max_outer) -> Partition:
        """FFMPA baseline [18]: the FULL models are given (pre-built), so the
        nested iteration runs entirely without benchmarks.  Rows are
        partitioned directly in ROW units.  With ``analytic_tol`` set the
        analytic models are sample-and-banked so this baseline rides the
        session's bank backend; the default keeps the scalar path."""
        grid = self.grid
        p, q = len(grid), len(grid[0])
        widths = [N // q + (1 if j < N % q else 0) for j in range(q)]
        rows: List[List[int]] = [[M // p] * p for _ in range(q)]
        times: List[List[float]] = [[0.0] * p for _ in range(q)]
        best: Optional[Partition] = None
        banked = self.analytic_tol is not None
        for outer in range(1, max_outer + 1):
            for j in range(q):
                w = widths[j]
                models = [
                    AnalyticModel(
                        (lambda i_: lambda r: (r * w) / grid[i_][j](float(r), float(w)) if r > 0 else 0.0)(i)
                    )
                    for i in range(p)
                ]
                col_store = SpeedStore.from_models(
                    models,
                    backend=self._bank_backend() if banked else "auto",
                    analytic_tol=self.analytic_tol,
                    analytic_hi=float(M) if banked else None,
                    dtype=self.dtype,
                    device=self._device,
                )
                rows[j] = col_store.partition_units(
                    M, min_units=1, completion=self._completion_for(col_store)
                )
                times[j] = _col_times(grid, j, widths, rows[j])
            imb = _flat_imbalance(times)
            if best is None or imb < best.imbalance:
                best = self._grid_result(
                    widths, rows, outer, 0, 0.0, imb <= eps, imb, times
                )
            if imb <= eps:
                return best
            new_widths = _rebalance_widths(widths, times, rows, N)
            if new_widths == widths:
                return best
            widths = new_widths
        return best

    def repartition_grid(
        self,
        fpms: Sequence[Sequence[PiecewiseLinearFPM]],
        fpm_width: Sequence[Sequence[Optional[int]]],
        widths: Sequence[int],
        M: int,
        *,
        min_units: int = 1,
    ) -> List[List[int]]:
        """Re-partition EVERY column's rows from surviving FPM estimates in
        one call — no new benchmarks (the refresh used when widths move but
        no fresh benchmarks are wanted).

        ``fpms[i][j]`` / ``fpm_width[i][j]`` are the per-(row, column)
        estimates and the widths they were observed at; each column's bank is
        rescaled to its current width and, on the torch backend, all ``q``
        banks are stacked into one ``[q, p, k]`` device bank whose ``t*``
        bisections and completions run together.  Returns ``rows[j][i]``.
        """
        p, q = len(fpms), len(widths)
        for i in range(p):
            for j in range(q):
                if fpm_width[i][j] is None or fpms[i][j].num_points == 0:
                    raise ValueError(f"no FPM estimate for processor ({i}, {j})")
        col_banks = []
        for j in range(q):
            bank = ModelBank.from_models([fpms[i][j] for i in range(p)])
            scale = [fpm_width[i][j] / widths[j] for i in range(p)]
            col_banks.append(bank.scaled(scale))
        if self._backend == "torch":
            stacked = TorchModelBank.stack(
                [TorchModelBank.from_bank(b, device=self._device, dtype=self.dtype) for b in col_banks]
            )
            d = stacked.partition_units(
                M, min_units=min_units, completion=self.completion
            )
            return [[int(v) for v in row] for row in d]
        rows = []
        for b in col_banks:
            store = SpeedStore.from_bank(b)
            rows.append(
                store.partition_units(
                    M, min_units=min_units, completion=self._completion_for(store)
                )
            )
        return rows

    # -- persistence ----------------------------------------------------------

    def state_dict(self) -> Dict:
        """Config, estimates, EMA state and the current distribution, in the
        reference's schema (version 1)."""
        store_state = self.store.state_dict()
        return {
            "version": 1,
            "energy_points": store_state.get("energy_points"),
            "policy": self.policy.value,
            "backend": self.backend,
            "n_units": self.n_units,
            "num_groups": self.num_groups,
            "eps": self.eps,
            "min_units": self.min_units,
            "smooth": self.smooth,
            "completion": self.completion,
            "caps": list(self.caps) if self.caps is not None else None,
            "groups": list(self.groups) if self.groups is not None else None,
            "max_group_knots": self.max_group_knots,
            "d": list(self.d),
            "points": store_state["points"],
            "dtype": store_state["dtype"],
            "ema": [[int(g), int(du), float(v)] for (g, du), v in self._ema.items()],
            "rebalances": self.rebalances,
            "steps_observed": self.steps_observed,
        }

    @classmethod
    def from_state(cls, state: Dict, *, device="cuda", **overrides) -> "Scheduler":
        """Restore a scheduler saved by :meth:`state_dict` — this package's
        or the reference's (its ``"jax"`` backend restores as ``"torch"``).
        ``overrides`` replace individual config fields (e.g.
        ``backend="numpy"``)."""
        from .convert import scheduler_state_from_reference

        state = scheduler_state_from_reference(state)
        cfg = dict(
            policy=Policy(state.get("policy", Policy.DFPA.value)),
            n_units=state.get("n_units"),
            eps=state.get("eps", 0.1),
            min_units=state.get("min_units", 0),
            caps=state.get("caps"),
            smooth=state.get("smooth", 0.5),
            backend=state.get("backend", "numpy"),
            completion=state.get("completion", "auto"),
            groups=state.get("groups"),
            max_group_knots=state.get("max_group_knots", 64),
            dtype=state.get("dtype"),
        )
        cfg.update(overrides)
        backend = cfg.pop("backend")
        models = [PiecewiseLinearFPM.from_points(p) for p in state["points"]]
        sched = cls(
            SpeedStore.from_models(models, backend=backend, dtype=cfg["dtype"], device=device),
            backend=backend,
            device=device,
            **cfg,
        )
        sched.d = list(state.get("d", sched.d))
        if state.get("energy_points"):
            sched.store.attach_energy(
                [PiecewiseLinearFPM.from_points(p) for p in state["energy_points"]]
            )
        sched._ema = {(int(g), int(du)): float(v) for g, du, v in state.get("ema", [])}
        sched.rebalances = int(state.get("rebalances", 0))
        sched.steps_observed = int(state.get("steps_observed", 0))
        return sched
