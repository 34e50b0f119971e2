"""Scheduler: the facade over the paper's partitioning lifecycle.

One session object over a :class:`~.speedstore.SpeedStore` (backend resolved
once) plus a :class:`Policy`:

  * ``partition(n, caps, min_units)`` — one optimal distribution from the
    current models (the paper's step 3);
  * ``observe(times)``               — fold one round's measured times into
    the estimates (step 5), EMA-smoothed, repartitioning when the imbalance
    exceeds ``eps``;
  * ``repartition()``                — force a re-partition;
  * ``autotune(executor, n, eps)``   — the paper's DFPA measurement loop;
  * ``state_dict()`` / ``from_state()`` — config, estimates, EMA state and
    the current distribution round-trip, so a restored scheduler produces
    bit-identical next rounds.  ``from_state`` also reads the reference
    package's ``Scheduler.state_dict()`` as it is (``core/convert.py``).

Every constructor defaults to ``backend="torch"`` on ``device="cuda"``: the
bank and every partition live on the card, and a missing card raises at
construction.  ``backend="numpy"`` / ``"scalar"`` keep their host meaning
(the parity references), and ``device="cpu"`` runs the torch bank on the
host.

Later slices of the port bring the 2-D grid partitioner (``grid=``,
``Policy.GRID2D``), the two-level path (``groups=``, ``Policy.HIER``),
energy objectives, straggler handling and elastic membership; asking for
them raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .executor import Executor
from .fpm import PiecewiseLinearFPM, imbalance
from .modelbank_torch import resolve_device
from .speedstore import BACKENDS, SpeedStore

__all__ = ["Policy", "Partition", "Scheduler"]


class Policy(Enum):
    """Which performance-model policy drives the distribution.

    * ``CPM``    — constant performance models (the conventional baseline);
    * ``FFMPA``  — pre-built full functional models (partition once);
    * ``DFPA``   — the paper's algorithm: partial models built online;
    * ``GRID2D`` — the nested 2-D partitioner (a later slice of the port);
    * ``HIER``   — the two-level path (a later slice of the port).
    """

    CPM = "cpm"
    FFMPA = "ffmpa"
    DFPA = "dfpa"
    GRID2D = "grid2d"
    HIER = "hier"


@dataclass
class Partition:
    """One partitioning outcome — the single result type of the facade;
    ``allocations[i]`` is processor ``i``'s unit count."""

    allocations: List[int]
    t_star: Optional[float]  # continuous equal-time point (None for loop results)
    makespan: Optional[float]  # estimated (or measured) slowest-processor time
    imbalance: float  # max |t_i - t_j| / t_i over working processors
    converged: bool
    iterations: int
    policy: Policy
    backend: str
    times: Optional[List[float]] = None  # per-processor times backing the metrics
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
        completion: str = "auto",
        groups: Optional[Sequence[int]] = None,
        device="cuda",
        dtype=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if completion not in ("auto", "threshold", "greedy"):
            raise ValueError(f"unknown completion mode {completion!r}")
        if grid is not None or policy is Policy.GRID2D:
            raise NotImplementedError(
                "the 2-D grid partitioner comes with the grid slice of the port "
                "(core/partition2d.py)"
            )
        if groups is not None or policy is Policy.HIER:
            raise NotImplementedError(
                "groups= / Policy.HIER come with the hierarchy slice of the port "
                "(core/hierarchy.py)"
            )
        # "auto" = threshold count on monotone banks on the device bank, the
        # exact per-unit greedy otherwise (always on the numpy host path).
        self.completion = completion
        self.policy = policy
        self.eps = float(eps)
        self.min_units = int(min_units)
        self.caps = list(caps) if caps is not None else None
        self.smooth = float(smooth)
        self.n_units = int(n_units) if n_units is not None else None
        self._backend = backend
        on_card = (store.backend if store is not None else backend) == "torch"
        self._device = resolve_device(device) if on_card else device
        self._dtype = dtype
        if store is None and num_groups is not None:
            store = SpeedStore.empty(
                int(num_groups), backend=backend, dtype=dtype, device=self._device
            )
        self.store = store
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
    ) -> Partition:
        """Compute one optimal distribution from the current models and make
        it the scheduler's current distribution ``d``.  Per-call ``caps``
        apply to this call only unless ``persist_caps=True``."""
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
        d, t_star = self.store.partition(
            n, caps_now, min_units=mu, completion=self._completion_for(self.store),
        )
        self.d = list(d)
        return self._flat_result(d, t_star, eps=self.eps if eps is None else eps)

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
        EMA smoothing (``smooth``) de-noises wall-clock measurements."""
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
        if imbalance(times) <= self.eps:  # zero-allocation groups are ignored
            return False
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

    # -- persistence ----------------------------------------------------------

    def state_dict(self) -> Dict:
        """Config, estimates, EMA state and the current distribution, in the
        reference's schema (version 1)."""
        store_state = self.store.state_dict()
        return {
            "version": 1,
            "policy": self.policy.value,
            "backend": self.backend,
            "n_units": self.n_units,
            "num_groups": self.num_groups,
            "eps": self.eps,
            "min_units": self.min_units,
            "smooth": self.smooth,
            "completion": self.completion,
            "caps": list(self.caps) if self.caps is not None else None,
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
        sched._ema = {(int(g), int(du)): float(v) for g, du, v in state.get("ema", [])}
        sched.rebalances = int(state.get("rebalances", 0))
        sched.steps_observed = int(state.get("steps_observed", 0))
        return sched
