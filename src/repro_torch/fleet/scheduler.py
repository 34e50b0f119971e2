"""FleetScheduler: q concurrent jobs, one stacked bank, one partition and one
fold-in per measurement round.

``Scheduler`` (``core/scheduler.py``) owns ONE job; q concurrent jobs driven
through it cost q sequential Python DFPA loops and q separate device banks:
every outer round issues q ``t*``-bisection solves and q fold-ins, and the
launch overhead — not the math — dominates at serving scale.

``FleetScheduler`` multiplexes the SAME per-job state machine as
``Scheduler.autotune`` (measure → fold → eps test → repartition → seen-set
probe escape), but lock-steps all admitted jobs so that one *fleet round*
is:

  1. ONE stacked repartition — every job needing a new distribution gets it
     from a single ``[q, p, k]`` ``TorchModelBank.partition_units`` call
     (per-job ``n``, caps, ``min_units`` and per-lane completion routing all
     ride the batch dims);
  2. ONE batched measurement — a :class:`~repro_torch.core.executor.
     FleetExecutor` (e.g. ``BatchedSimulatedExecutor2D``) runs every
     measuring job's distribution in one call;
  3. ONE stacked fold-in — all jobs' observations enter the device carry
     through one vectorized sorted insert, written into the carry's own
     tensors.

Per-job results surface as the typed :class:`~repro_torch.core.scheduler.
Partition`, bit-identical — allocations AND folded estimates — to what q
independent ``Scheduler.autotune`` loops would have produced, including
through mid-flight ``admit``/``retire`` and adversarial non-monotone jobs
that demote only their own lane's completion (``tests/test_torch_fleet.py``
holds this against the reference package's fleet).

Backends
--------

``backend="torch"`` (the default, on ``device="cuda"``; a missing card
raises unless the caller passes ``device="cpu"``) keeps the stacked
``[q, p, k]`` :class:`~repro_torch.core.modelbank_torch.TorchModelBank` on
the device and spends one partition and one fold-in per round whatever q
is: ``device_dispatches`` counts them as the reference counts its jax
programs.  ``"numpy"`` and ``"scalar"`` (the seed per-model loop) run the
same state machine over per-job host paths — no batching, the same
results.  The reference's ``"jax"`` backend is refused.

Ownership and restacking
------------------------

The per-job scalar estimates (``PiecewiseLinearFPM`` lists) are the source
of truth; the stacked device bank is a derived carry, updated in place by
the per-round fold-in and REBUILT lazily ("restacked", ``_assign_lanes``)
only when the lane set changes — ``admit``/``retire`` and
``reprofile_replica`` mark it dirty and the next round pays one restack.
Jobs that converge stay in the stack (masked out of the repartition and
fold); their lanes are reclaimed at the next restack.  ``lane_buckets``
pads the lane count to the next power of two with dummy lanes, and
``reserve_knots`` reserves the padded knot width (``min_k``) up front.

The 2-D grid partitioner (``Scheduler._grid_dfpa``) drives its per-column
inner DFPA loops through this driver — one fleet per outer round, one job
per re-benchmarked column.

Profile registry
----------------

With a :class:`~repro_torch.fleet.registry.ProfileRegistry` attached (and
``device_classes`` naming each processor's hardware class), ``admit`` merges
previously saved partial estimates keyed by ``(device_class,
spec.workload)`` into the new job's models, so it warm-starts from a
repartition instead of the cold even split; ``retire`` folds what the job
learned back into the registry.

Warm profiles can be STALE (driver update, thermal re-limit): with
``staleness_tol`` set, a warm-started job's FIRST measured round is compared
against what the warm models predicted for the distribution it just ran; a
device class whose rows deviate beyond the tolerance has its registry entry
dropped (``registry.drop``) with a ``UserWarning``, and the job continues
from its fresh measurements.

Hierarchical fleets
-------------------

With ``groups=`` (a per-processor group assignment, the convention of
``Scheduler(groups=...)``), every repartition and ``rebalance`` routes
through the two-level :class:`~repro_torch.core.hierarchy.Hierarchy` solve.
The reference builds each job's hierarchy on zero-copy host views of its
stacked carry, which are free only on a CPU device.  The port takes the
jobs' host mirrors instead (``job.bank()``): in a sync round they hold the
values the carry holds, so no device-to-host copy of the carry is made.
On ``"torch"`` the inner solves run on the device (``Hierarchy(backend=
"torch")``, one stacked inner solve per job, each counted in
``device_dispatches`` as the reference counts its per-job inner programs);
the carry keeps taking the one-program fold-in.

Round lifecycle: sync vs pipelined
----------------------------------

The default round (``pipeline=False``, "sync") is a fork-join barrier::

    partition(carry G_r) -> measure -> fold -> carry G_{r+1}

Every stage waits for the previous one: the stacked repartition of round
``r+1`` reads the carry produced by round ``r``'s fold and reads its
allocations back before the round goes on.

``pipeline=True`` restructures the round as the reference does, over
DOUBLE-BUFFERED fold-in carries:

1. the fold of round ``r``'s observations writes new tensors
   (``TorchModelBank.fold_in(donate=False)``), so the previous generation
   ``G_{r-1}`` stays valid beside ``G_r``;
2. round ``r+1``'s stacked repartition is PRE-DISPATCHED before ``step``
   (or ``observe``) returns: ``partition_units(defer=True)`` queues the
   whole solve on the card with every loop count fixed on the host and no
   device-to-host read, so the host goes on with the round's bookkeeping
   (convergence settle, admit/retire, registry writes, the caller's own
   work) while the card solves;
3. round ``r+1``'s Phase 2 merely FETCHES the pre-dispatched result — the
   one read.  The serving cycle gets the same treatment: ``observe`` folds
   AND pre-dispatches the next epoch's partition over every admitted
   tenant, which a no-argument ``rebalance()`` fetches.

One CUDA stream carries the fold and the pre-dispatched solve, in that
order, so the double-buffered carries need no events: stream order is the
reference's dependency order.

``pipeline_depth`` is the staleness bound: a lane never partitions against
estimates more than ``pipeline_depth`` fold generations behind the newest
(``TorchModelBank.generation``).  ``depth=0`` keeps the pre-dispatch but
always reads the newest generation — bit-identical to sync; ``depth=1``
(the default) allows the one-generation lag as a SPECULATIVE read with
seen-set validation: the stale partition is consumed only when it moves
every job to a distribution it has not measured (``stale_reads``), and
otherwise the round partitions the newest carry again
(``speculative_misses``) — the program sync would have paid anyway.  On a
deterministic replay every speculation misses and the depth-1 trajectory
is bit-identical to sync.  The numpy backend reads per-job host snapshots
of the previous generation (``_stale_bank``) under the same validation, as
the reference's numpy backend does; so does the two-level route on either
backend, since it partitions the jobs' host mirrors.  The pipeline SYNCS
unconditionally (reads fresh, discards any pre-dispatched partition) on a
lane whose previous generation had no estimates, a power-capped
repartition of priced jobs, any membership change (admit, retire,
reprofile, restack: the restack rebuilds from fully folded host models and
resets the generation), and ``state_dict``, which :meth:`drain` s first.

The port compiles no device program, so the reference's jit-cache
recompile telemetry has no meaning here: :meth:`stats` keeps the
reference's keys and no ``fleet.recompile.*`` counter is ever emitted, as
on the reference's numpy backend.  ``sharding="shard_map"`` and
``compilation_cache_dir`` have no counterpart on one card and raise.

Telemetry
---------

With a ``repro_torch.obs`` sink installed the fleet records the
reference's sites: ``fleet.partition``, ``fleet.measure``, ``fleet.fold``
and ``fleet.round`` spans per round, ``fleet.rebalance`` /
``fleet.observe`` spans, ``fleet.power_cap`` spans with the
``fleet.power_cap.theta`` gauge, the ``fleet.restack``,
``fleet.predispatch``, ``fleet.stale_read`` and ``fleet.speculative_miss``
counters, the
``fleet.reprofile_replica`` and ``registry.stale_profile`` events, and the
``fleet.<key>`` gauges of :meth:`stats` after every round.  No site waits
for the card.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.fpm import PiecewiseLinearFPM, imbalance
from ..core.hierarchy import Hierarchy
from ..core.modelbank import ModelBank
from ..core.modelbank_torch import TorchModelBank, fetch_partition, resolve_device
from ..core.partition import (
    _partition_units_bank,
    _partition_units_scalar,
    _prep_unit_caps,
)
from ..core.scheduler import Partition, Policy, _even, _probe_neighbour
from .registry import ProfileRegistry

try:  # telemetry is optional: the fleet runs identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent

    def _obs_active():
        return None


__all__ = ["JobSpec", "FleetScheduler"]

BACKENDS = ("scalar", "numpy", "torch")


@dataclass
class JobSpec:
    """Everything one tenant asks of the fleet.

    ``n`` is the job's unit count (its own problem size; jobs need not
    agree), ``eps`` its convergence target, ``caps``/``min_units`` its
    per-processor allocation bounds, ``max_iter``/``probe_budget`` its DFPA
    loop limits (same defaults as ``Scheduler.autotune``), ``completion``
    its integer-completion routing ("auto" routes this job's lane by ITS
    bank's monotonicity), and ``workload`` the registry tag its profile is
    saved/warm-started under.
    """

    name: str
    n: int
    eps: float = 0.1
    caps: Optional[Sequence[int]] = None
    min_units: int = 0
    max_iter: int = 100
    probe_budget: Optional[int] = None
    completion: str = "auto"
    workload: Optional[str] = None
    warm_start_d: Optional[Sequence[int]] = None


@dataclass
class _Job:
    """One job's DFPA loop state — the exact per-job carry of
    ``Scheduler.autotune``, multiplexed by the fleet driver."""

    spec: JobSpec
    models: List[PiecewiseLinearFPM]
    probes_left: int
    probe_budget: int
    icaps: np.ndarray  # validated per-processor caps (admit/resize time)
    empty_rows: np.ndarray  # host-side counts==0 mirror, updated per fold
    lane: int = -1  # index into the current stacked bank
    status: str = "new"  # new -> running -> done
    d: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    pending_d: Optional[List[int]] = None  # chosen for this round's measure
    it: int = 0  # measurement rounds executed
    seen: Dict[Tuple[int, ...], List[float]] = field(default_factory=dict)
    history: List[Tuple[List[int], List[float]]] = field(default_factory=list)
    best_d: List[int] = field(default_factory=list)
    best_t: List[float] = field(default_factory=list)
    best_imb: float = float("inf")
    bench_cost: float = 0.0
    result: Optional[Partition] = None
    # observations not yet materialized into `models`: the device carry is
    # updated every round, but the scalar mirrors are only needed when
    # somebody reads them (restack, retire, registry save, results) —
    # deferring the per-point inserts keeps the round free of O(q p)
    # Python work.
    pending_obs: List[Tuple[List[float], List[float]]] = field(default_factory=list)
    # host-side bank cache over `models`, dropped on every fold
    _bank: Optional[ModelBank] = None
    # True when admit() warm-started this job from the profile registry —
    # arms the one-shot staleness check on the first measured round
    _warm_from_registry: bool = False
    # per-processor energy-rate models (er_i(x) = x / E_i(x), see
    # core/energy.py) — static per job, set at admit; None = unpriced
    energy_models: Optional[List[PiecewiseLinearFPM]] = None
    _ebank: Optional[ModelBank] = None
    # pipeline-mode staleness bookkeeping: whether any of this job's rows
    # were empty in the PREVIOUS carry generation (a stale repartition must
    # not read a lane that had no estimates then), and — numpy backend and
    # the two-level route — the host bank snapshot of that generation
    _prev_empty_any: bool = True
    _stale_bank: Optional[ModelBank] = None

    def flush(self) -> None:
        """Materialize deferred observations into the scalar models (same
        add_point order as an eager mirror, so the result is identical)."""
        for d, t in self.pending_obs:
            for i, (di, ti) in enumerate(zip(d, t)):
                if di > 0 and ti > 0:
                    self.models[i].add_point(float(di), di / ti)
        self.pending_obs.clear()

    def bank(self) -> ModelBank:
        if self._bank is None:
            self.flush()
            self._bank = ModelBank.from_models(self.models)
        return self._bank

    def ebank(self) -> Optional[ModelBank]:
        if self.energy_models is None:
            return None
        if self._ebank is None:
            self._ebank = ModelBank.from_models(self.energy_models)
        return self._ebank

    def invalidate(self) -> None:
        self._bank = None


class FleetScheduler:
    """Multi-tenant lock-step DFPA over one heterogeneous fleet.

    Construct for a fleet of ``num_procs`` processor groups, ``admit`` jobs,
    then drive rounds with :meth:`step` (or :meth:`run` until every job
    converges).  ``backend="torch"`` (default, ``device="cuda"``) keeps the
    single stacked ``[q, p, k]`` bank on the device and spends exactly one
    partition and one fold-in per round regardless of q; ``"numpy"`` (or
    ``"scalar"``, the seed per-model loop) runs the same state machine over
    per-job host paths (no batching, same results).
    """

    def __init__(
        self,
        num_procs: int,
        *,
        backend: str = "torch",
        dtype=None,
        device="cuda",
        registry: Optional[ProfileRegistry] = None,
        device_classes: Optional[Sequence[str]] = None,
        alpha: Optional[float] = None,  # collective-cost overrides for
        beta: Optional[float] = None,  # executors without alpha/beta attrs
        groups: Optional[Sequence[int]] = None,
        sharding: Optional[str] = None,
        max_group_knots: int = 64,
        staleness_tol: Optional[float] = None,
        compilation_cache_dir: Optional[str] = None,
        detector=None,
        reserve_knots: Optional[int] = None,
        quantize: float = 0.0,
        power_cap: Optional[float] = None,
        lane_buckets: bool = False,
        pipeline: bool = False,
        pipeline_depth: int = 1,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if pipeline and backend == "scalar":
            raise ValueError(
                'pipeline=True requires a banked backend ("numpy" or "torch")'
            )
        if int(pipeline_depth) not in (0, 1):
            raise ValueError(
                "pipeline_depth must be 0 or 1 (a lane never partitions "
                "against estimates more than one fold generation old)"
            )
        p = int(num_procs)
        if p < 1:
            raise ValueError("need at least one processor")
        if sharding not in (None, "shard_map"):
            raise ValueError(f"unknown sharding mode {sharding!r}")
        if sharding is not None:
            raise NotImplementedError(
                'sharding="shard_map" spreads the hierarchy\'s group blocks '
                "over several devices; the port runs on a single card, whose "
                "mesh (ROADMAP queue 1, item 10f: launch.mesh) has no second "
                "device to split them over"
            )
        if compilation_cache_dir is not None:
            raise NotImplementedError(
                "compilation_cache_dir persists the reference's compiled jax "
                "programs; the port compiles no device program, so there is "
                "nothing to cache"
            )
        if groups is not None:
            if backend == "scalar":
                raise ValueError(
                    'hierarchical fleet requires a banked backend '
                    '("numpy" or "torch")'
                )
            if len(groups) != p:
                raise ValueError(
                    f"groups must be a length-p assignment "
                    f"(got {len(groups)} for p={p})"
                )
            self.groups: Optional[List[int]] = [int(v) for v in groups]
        else:
            self.groups = None
        self.max_group_knots = int(max_group_knots)
        self.staleness_tol = float(staleness_tol) if staleness_tol is not None else None
        self.p = p
        self._backend = backend
        self._device = resolve_device(device) if backend == "torch" else device
        self.dtype = dtype
        self.registry = registry
        if device_classes is not None and len(device_classes) != p:
            raise ValueError("device_classes length != num_procs")
        self.device_classes = (
            [str(c) for c in device_classes] if device_classes is not None else None
        )
        self._alpha, self._beta = alpha, beta
        self._jobs: Dict[str, _Job] = {}
        self._stacked: Optional[TorchModelBank] = None  # the [q, p, k] carry
        self._stack_dirty = True
        # per-REPLICA straggler strike automaton (serving path); lazily
        # constructed by straggler_actions() when not passed in
        self.detector = detector
        # reserved padded knot capacity for the stacked carry: with a fixed
        # reservation the [q, p, k] shapes are predictable (k =
        # reserve_knots until a row outgrows it), so fold_in never pays a
        # width doubling mid-trace
        self.reserve_knots = int(reserve_knots) if reserve_knots is not None else None
        # fold-position grid pitch (relative, e.g. 0.05): when set, EVERY
        # fold in this fleet — measured rounds and observe() alike — snaps
        # its x onto one geometric grid.  A knot that is on the grid is
        # refreshed (replaced in place) by the next fold in its cell; a
        # single un-snapped fold would instead leave a knot no later
        # quantized fold can ever overwrite, and a drifting replica's
        # prediction at that exact x would stay stale forever.
        self.quantize = float(quantize)
        # fleet-wide energy budget per round (same units as the jobs' energy
        # models, see core/energy.py): every _repartition gets a post-pass
        # that, when the time-optimal round would overspend, walks all
        # priced jobs up a COMMON makespan-stretch factor theta along their
        # Pareto fronts until the predicted fleet energy fits — see
        # _apply_power_cap.  None = uncapped (bit-identical to before).
        if power_cap is not None and not (float(power_cap) > 0):
            raise ValueError("power_cap must be positive")
        self.power_cap = float(power_cap) if power_cap is not None else None
        # pad the stacked lane count to the next power of two with masked
        # dummy lanes so admit/retire within a bucket keeps the carry's
        # [q, p, k] shape (torch backend; see _assign_lanes)
        self.lane_buckets = bool(lane_buckets)
        # Pipelined rounds (see "Round lifecycle: sync vs pipelined" in the
        # module docstring).  pipeline=False (the default) is the lock-step
        # sync round.  pipeline=True double-buffers the fold-in carry and
        # pre-dispatches the next round's stacked repartition;
        # pipeline_depth bounds how many fold generations behind the newest
        # a repartition may read (0 = always the newest, 1 = the previous).
        self.pipeline = bool(pipeline)
        self.pipeline_depth = int(pipeline_depth)
        # Test seam: when set, called once per repartition — True means
        # "the previous fold already completed", forcing that round to read
        # the NEWEST carry; False/None keeps the in-flight assumption (stale
        # read).  It also disables the pre-dispatch, so each round's carry
        # choice is made at repartition time.
        self.fold_ready_hook = None
        self._stacked_stale: Optional[TorchModelBank] = None  # previous generation
        self._predispatched: Optional[Dict[str, Any]] = None
        self.rounds = 0
        self.restacks = 0
        # pipeline counters: speculative stale-generation repartitions that
        # were CONSUMED, speculations discarded by the seen-set validation
        # (the round fell back to the newest carry), and next-round
        # partitions dispatched early (consumed or discarded)
        self.stale_reads = 0
        self.speculative_misses = 0
        self.predispatches = 0
        # device solves launched (stacked partitions + fold-ins, and the
        # per-job inner solves of a hierarchical fleet): the count the
        # reference's fleet benchmark compares against q independent
        # Scheduler loops (which pay 2q per round).
        self.device_dispatches = 0

    # -- introspection --------------------------------------------------------

    @property
    def backend(self) -> str:
        return self._backend

    @property
    def num_procs(self) -> int:
        return self.p

    @property
    def jobs(self) -> List[str]:
        return list(self._jobs)

    @property
    def active_jobs(self) -> List[str]:
        return [n for n, j in self._jobs.items() if j.status != "done"]

    def stats(self) -> Dict[str, int]:
        """Public counter snapshot of the fleet session so far.

        Keys (all monotonically non-decreasing ints):

        * ``rounds`` — completed :meth:`observe`/:meth:`step`/
          :meth:`rebalance` rounds;
        * ``restacks`` — carry rebuilds on the torch backend;
        * ``device_dispatches`` — device solves launched (pre-dispatched
          ones included);
        * ``predispatches`` — pipelined solves queued ahead of the next
          round;
        * ``stale_reads`` — speculative results CONSUMED (the round used a
          partition of the previous generation);
        * ``speculation_hits`` — alias of ``stale_reads``;
        * ``speculative_misses`` — speculative partitions discarded because
          some job had measured their distribution already.

        When a telemetry sink is installed every key is also exported as a
        ``fleet.<key>`` gauge at the end of each round."""
        return {
            "rounds": self.rounds,
            "restacks": self.restacks,
            "device_dispatches": self.device_dispatches,
            "predispatches": self.predispatches,
            "stale_reads": self.stale_reads,
            "speculation_hits": self.stale_reads,
            "speculative_misses": self.speculative_misses,
        }

    def _stats_gauges(self, tel) -> None:
        for k, v in self.stats().items():
            tel.gauge(f"fleet.{k}", v)

    def _count(self, name: str) -> None:
        """Bump a telemetry counter iff a sink is installed (two attribute
        reads when disabled, no allocation)."""
        tel = _obs_active()
        if tel is not None and tel.enabled:
            tel.counter(name)

    def models(self, name: str) -> List[PiecewiseLinearFPM]:
        job = self._jobs[name]
        job.flush()
        return job.models

    def distribution(self, name: str) -> List[int]:
        return list(self._jobs[name].d)

    def bench_cost(self, name: str) -> float:
        return self._jobs[name].bench_cost

    def iterations(self, name: str) -> int:
        return self._jobs[name].it

    def result(self, name: str) -> Partition:
        job = self._jobs[name]
        if job.result is None:
            raise ValueError(f"job {name!r} has not finished")
        return job.result

    def snapshot(self, name: str) -> Partition:
        """Current state as a Partition — the finished result for done jobs,
        a live (non-converged) view for running ones."""
        job = self._jobs[name]
        if job.result is not None:
            return job.result
        job.flush()
        t = list(job.times)
        return Partition(
            allocations=list(job.d),
            t_star=None,
            makespan=max(t) if t else None,
            imbalance=imbalance(t) if t else float("inf"),
            converged=False,
            iterations=job.it,
            policy=Policy.DFPA,
            backend=self._backend,
            times=t,
            diagnostics={"history": job.history, "models": job.models,
                         "bench_cost": job.bench_cost},
        )

    # -- membership -----------------------------------------------------------

    def admit(
        self,
        spec: JobSpec,
        models: Optional[Sequence[Any]] = None,
        energy_models: Optional[Sequence[Any]] = None,
    ) -> str:
        """Admit one job.  Validation mirrors ``Scheduler.autotune`` (n >= p,
        eps > 0, cap feasibility) but fires here, naming the job, instead of
        mid-round.  ``models`` warm-starts from explicit estimates (copied);
        otherwise the profile registry is consulted under
        ``(device_class, spec.workload)``; otherwise the job starts cold
        (even first split, exactly the paper's step 1).

        ``energy_models`` (per-processor energy-rate FPMs, see
        ``core/energy.py:energy_model``) price the job for the fleet's
        ``power_cap``; omitted, the registry's energy entries are consulted
        the same way — a job with no energy pricing simply runs
        time-optimal and is excluded from the cap's budget."""
        name = str(spec.name)
        if name in self._jobs:
            raise ValueError(f"job {name!r} already admitted")
        if spec.completion not in ("auto", "threshold", "greedy"):
            raise ValueError(f"unknown completion mode {spec.completion!r}")
        n = int(spec.n)
        if n < self.p:
            raise ValueError(f"DFPA requires n >= p (n={n}, p={self.p})")
        if float(spec.eps) <= 0:
            raise ValueError("eps must be positive")
        icaps = _prep_unit_caps(self.p, n, spec.caps, int(spec.min_units))
        if spec.warm_start_d is not None:
            w = [int(v) for v in spec.warm_start_d]
            if sum(w) != n or len(w) != self.p:
                raise ValueError("warm_start_d must be a length-p partition of n")
        warm_from_registry = False
        from_registry = (
            self.registry is not None
            and spec.workload is not None
            and self.device_classes is not None
        )
        if models is not None:
            if len(models) != self.p:
                raise ValueError("models length != num_procs")
            job_models = [
                PiecewiseLinearFPM.from_points(m.as_points())
                if getattr(m, "num_points", 0) > 0
                else PiecewiseLinearFPM()
                for m in models
            ]
        elif from_registry:
            job_models = self.registry.warm_models(self.device_classes, spec.workload)
            warm_from_registry = any(
                getattr(m, "num_points", 0) > 0 for m in job_models
            )
        else:
            job_models = [PiecewiseLinearFPM() for _ in range(self.p)]
        if energy_models is not None:
            if len(energy_models) != self.p:
                raise ValueError("energy_models length != num_procs")
            job_emodels: Optional[List[PiecewiseLinearFPM]] = [
                PiecewiseLinearFPM.from_points(m.as_points()) for m in energy_models
            ]
        elif from_registry:
            job_emodels = self.registry.warm_energy_models(
                self.device_classes, spec.workload
            )
        else:
            job_emodels = None
        budget = int(spec.probe_budget) if spec.probe_budget is not None else 2 * self.p
        self._jobs[name] = _Job(
            spec=spec,
            models=job_models,
            probes_left=budget,
            probe_budget=budget,
            icaps=np.asarray(icaps, dtype=np.int64),
            empty_rows=np.asarray(
                [getattr(m, "num_points", 0) == 0 for m in job_models], dtype=bool
            ),
            _warm_from_registry=warm_from_registry,
            energy_models=job_emodels,
        )
        self._stack_dirty = True
        return name

    def retire(self, name: str, *, save_profile: bool = True) -> Optional[Partition]:
        """Remove a job (its lane is reclaimed at the next restack).  The
        learned profile is folded into the registry unless
        ``save_profile=False``.  Returns the final Partition — the converged
        result for done jobs, a best-so-far snapshot for running ones, None
        for jobs that never measured."""
        job = self._jobs.pop(name)
        job.flush()
        self._stack_dirty = True
        if (
            save_profile
            and self.registry is not None
            and self.device_classes is not None
        ):
            self.registry.record_job(
                self.device_classes, job.spec.workload, job.models,
                energy_models=job.energy_models,
            )
        if job.result is not None:
            return job.result
        if job.it == 0:
            return None
        self._finish(job, job.best_d, job.best_t, job.best_imb <= job.spec.eps,
                     job.best_imb)
        return job.result

    def resize(
        self,
        name: str,
        *,
        n: Optional[int] = None,
        caps=...,
        eps: Optional[float] = None,
        min_units: Optional[int] = None,
        max_iter: Optional[int] = None,
        probe_budget=...,
    ) -> None:
        """Change a running job's shape.  The job keeps its learned
        estimates but resets its loop state (seen set, best trackers, probe
        budget, round count) — from the next round it behaves exactly like a
        freshly admitted job warm-started from the same models (its first
        new-``n`` distribution is a repartition, not an even split, whenever
        every model has a point).  ``max_iter``/``probe_budget`` override
        the job's loop limits (a serving caller re-running a warm tenant
        for one measured round passes ``max_iter=1``)."""
        job = self._jobs[name]
        s = job.spec
        spec = JobSpec(
            name=s.name,
            n=int(n) if n is not None else s.n,
            eps=float(eps) if eps is not None else s.eps,
            caps=s.caps if caps is ... else caps,
            min_units=int(min_units) if min_units is not None else s.min_units,
            max_iter=int(max_iter) if max_iter is not None else s.max_iter,
            probe_budget=s.probe_budget if probe_budget is ... else probe_budget,
            completion=s.completion,
            workload=s.workload,
            warm_start_d=None,
        )
        if spec.n < self.p:
            raise ValueError(f"DFPA requires n >= p (n={spec.n}, p={self.p})")
        if float(spec.eps) <= 0:
            raise ValueError("eps must be positive")
        job.icaps = np.asarray(
            _prep_unit_caps(self.p, spec.n, spec.caps, int(spec.min_units)),
            dtype=np.int64,
        )
        job.spec = spec
        job.status = "new"
        job.result = None
        job.it = 0
        job.seen = {}
        job.history = []
        job.best_d, job.best_t, job.best_imb = [], [], float("inf")
        if probe_budget is not ...:
            job.probe_budget = (
                int(spec.probe_budget)
                if spec.probe_budget is not None
                else 2 * self.p
            )
        job.probes_left = job.probe_budget
        job.pending_d = None
        # the bank itself is unchanged — no restack needed

    # -- the lock-step round driver -------------------------------------------

    def step(self, executor) -> Dict[str, Partition]:
        """One fleet round: batched repartition -> batched measurement ->
        stacked fold-in -> per-job convergence settle.  Returns the jobs
        that FINISHED this round (name -> Partition)."""
        if executor.num_procs != self.p:
            raise ValueError(
                f"executor has {executor.num_procs} processors, fleet has {self.p}"
            )
        finished: Dict[str, Partition] = {}
        jobs = list(self._jobs.values())
        if not any(j.status != "done" for j in jobs):
            return finished
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t_round = tel.clock()

        # Phase 1: choose this round's distributions.  New jobs follow
        # autotune's initial rule (warm_start_d | warm repartition | even);
        # running jobs always repartition from the current estimates.
        to_repart: List[_Job] = []
        to_measure: List[_Job] = []
        for job in jobs:
            if job.status == "new":
                if job.spec.warm_start_d is not None:
                    job.pending_d = [int(v) for v in job.spec.warm_start_d]
                    to_measure.append(job)
                elif not bool(job.empty_rows.any()):
                    # every model has >= 1 point (the empty_rows mirror is
                    # maintained per fold, so deferred obs count): warm start
                    to_repart.append(job)
                else:
                    job.pending_d = _even(job.spec.n, self.p)
                    to_measure.append(job)
            elif job.status == "running":
                to_repart.append(job)

        # Phase 2: ONE stacked repartition for every job that needs one,
        # then the host-side seen-set / probe-escape logic per job.
        if to_repart:
            if rec:
                t0 = tel.clock()
            new_ds = self._repartition(to_repart)
            if rec:
                tel.span_at("fleet.partition", t0, tel.clock(),
                            jobs=len(to_repart))
            for job, d_new in zip(to_repart, new_ds):
                if job.status == "running":
                    key = tuple(d_new)
                    if key in job.seen:
                        t_seen = job.seen[key]
                        imb_seen = imbalance(t_seen)
                        if imb_seen < job.best_imb:
                            job.best_d, job.best_t, job.best_imb = (
                                list(d_new), list(t_seen), imb_seen,
                            )
                        probe = (
                            _probe_neighbour(
                                d_new, t_seen, job.seen, job.spec.caps,
                                int(job.spec.min_units),
                            )
                            if job.probes_left > 0
                            else None
                        )
                        if probe is None:
                            self._finish(
                                job, job.best_d, job.best_t,
                                job.best_imb <= job.spec.eps, job.best_imb,
                            )
                            finished[job.spec.name] = job.result
                            continue
                        job.probes_left -= 1
                        d_new = probe
                job.pending_d = [int(v) for v in d_new]
                to_measure.append(job)

        # Phase 3: ONE batched measurement for every measuring job
        # (addressed by name — the stable identity across restacks).
        if to_measure:
            names = [job.spec.name for job in to_measure]
            D = np.asarray([job.pending_d for job in to_measure], dtype=np.int64)
            if rec:
                t0 = tel.clock()
            T = np.asarray(executor.run_jobs(names, D), dtype=np.float64)
            if rec:
                tel.span_at("fleet.measure", t0, tel.clock(),
                            jobs=len(to_measure))
            alpha = self._alpha if self._alpha is not None else getattr(executor, "alpha", 0.0)
            beta = self._beta if self._beta is not None else getattr(executor, "beta", 0.0)

            # Phase 4: ONE stacked fold-in (device carry first — it restacks
            # from the PRE-fold host models if dirty — then the host
            # mirrors), and the per-job convergence settle of autotune.
            # With a quantize pitch the fold positions snap onto the grid
            # (convergence bookkeeping below stays on the exact d).
            if self.quantize > 0.0:
                Df, Tf = self._snap_grid(D.astype(np.float64), T, self.quantize)
            else:
                Df, Tf = D.astype(np.float64), T
            if rec:
                t0 = tel.clock()
            self._fold(to_measure, Df, Tf)
            if rec:
                tel.span_at("fleet.fold", t0, tel.clock(), jobs=len(to_measure))
            for k, job in enumerate(to_measure):
                d = job.pending_d
                times = [float(v) for v in T[k]]
                if job.it == 0 and job._warm_from_registry:
                    # job.models still hold the admit-time warm estimates
                    # (pending_obs defers the fold into the scalar mirrors),
                    # so this compares the warm PREDICTION for the round the
                    # job just ran against what was actually measured.
                    self._staleness_check(job, d, times)
                job.pending_obs.append(
                    ([float(v) for v in Df[k]], [float(v) for v in Tf[k]])
                )
                job.invalidate()
                job.history.append((list(d), list(times)))
                job.seen[tuple(d)] = list(times)
                job.d, job.times = list(d), times
                job.pending_d = None
                job.it += 1
                job.status = "running"
                job.bench_cost += max(times) + alpha + beta * self.p
                imb = imbalance(times)
                if imb < job.best_imb:
                    job.best_d, job.best_t, job.best_imb = list(d), list(times), imb
                if imb <= job.spec.eps:
                    self._finish(job, d, times, True, imb)
                    finished[job.spec.name] = job.result
                elif job.it >= job.spec.max_iter:
                    self._finish(job, job.best_d, job.best_t, False, job.best_imb)
                    finished[job.spec.name] = job.result

        self.rounds += 1
        if self.pipeline:
            # queue next round's stacked repartition on the card while the
            # host does the caller's work between rounds
            self._predispatch_next()
        if rec:
            tel.span_at("fleet.round", t_round, tel.clock(),
                        round=self.rounds, measured=len(to_measure),
                        finished=len(finished))
            self._stats_gauges(tel)
        return finished

    def rebalance(
        self, loads: Optional[Dict[str, Optional[int]]] = None
    ) -> Dict[str, List[int]]:
        """The serving fast path: recompute every (or the given) tenants'
        distributions from the CURRENT estimates in one stacked device
        solve — no measurement, no fold-in.  ``loads`` optionally updates
        unit counts first (tenant traffic drifted); a changed ``n`` clears
        that job's fixed-point ``seen`` set (distributions of different
        totals are never comparable), and a job whose distribution actually
        moves drops its cached autotune ``result`` — ``snapshot`` then
        reports the live distribution instead of a stale Partition."""
        if loads:
            for name, n in loads.items():
                job = self._jobs[name]
                if n is None or int(n) == job.spec.n:
                    continue
                n = int(n)
                if n < self.p:
                    raise ValueError(f"DFPA requires n >= p (n={n}, p={self.p})")
                job.icaps = np.asarray(
                    _prep_unit_caps(self.p, n, job.spec.caps, int(job.spec.min_units)),
                    dtype=np.int64,
                )
                # a fresh spec, never a mutation — the caller still owns the
                # JobSpec it admitted (same convention as resize())
                job.spec = replace(job.spec, n=n)
                job.seen = {}
        targets = [
            self._jobs[nm] for nm in (loads if loads is not None else self._jobs)
        ]
        if not targets:
            return {}
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t0 = tel.clock()
        ds = self._repartition(targets)
        out = {}
        for job, d in zip(targets, ds):
            d = list(d)
            if d != job.d:
                # the cached autotune result no longer describes what the
                # fleet is serving; snapshot() falls back to the live view
                # (times measured for the OLD distribution are dropped too)
                job.result = None
                job.times = []
            job.d = d
            out[job.spec.name] = list(d)
        self.rounds += 1
        if rec:
            tel.span_at("fleet.rebalance", t0, tel.clock(), jobs=len(targets))
            self._stats_gauges(tel)
        return out

    @staticmethod
    def _snap_grid(d: np.ndarray, t: np.ndarray, pitch: float):
        """Snap fold positions ``d`` onto the geometric grid of relative
        pitch ``pitch``; ``t`` is rescaled so the observed SPEED ``d/t`` is
        kept exact (only the knot position moves, by at most ``pitch``)."""
        d = np.asarray(d, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        h = np.log1p(float(pitch))
        ok = (d > 0) & (t > 0)
        safe = np.where(ok, d, 1.0)
        dq = np.where(ok, np.exp(np.round(np.log(safe) / h) * h), d)
        return dq, np.where(ok, t * dq / safe, t)

    def observe(
        self,
        times: Dict[str, Sequence[float]],
        *,
        quantize: Optional[float] = None,
    ) -> None:
        """The serving fast path's other half: fold externally-measured
        per-replica times for the given tenants' CURRENT distributions into
        the fleet's estimates — one stacked fold-in, no repartition (pair
        with :meth:`rebalance` for the full serving epoch; call
        :meth:`straggler_actions` BEFORE this so strike predictions come
        from the pre-epoch estimates).

        ``quantize`` (relative pitch, e.g. ``0.05``) snaps each fold's
        ``x`` onto a geometric grid — the observed SPEED is kept exact,
        only the knot position moves by at most ``quantize``.  Long-running
        sessions whose per-epoch allocations drift then touch a bounded
        knot set (duplicate-``x`` folds replace in place), so the stacked
        carry stops growing.  Defaults to the fleet's construction-time
        ``quantize`` pitch so measured rounds and serving folds share one
        grid (see __init__: mixed-grid folds leave knots that can never be
        refreshed)."""
        pitch = self.quantize if quantize is None else float(quantize)
        jobs: List[_Job] = []
        Ds: List[np.ndarray] = []
        Ts: List[np.ndarray] = []
        for name, t in times.items():
            job = self._jobs[name]
            t = np.asarray([float(v) for v in t], dtype=np.float64)
            if len(t) != self.p:
                raise ValueError(f"job {name!r}: times length != num_procs")
            if len(job.d) != self.p:
                raise ValueError(f"job {name!r} has no current distribution")
            observed = [float(v) for v in t]
            d = np.asarray(job.d, dtype=np.float64)
            if pitch > 0.0:
                d, t = self._snap_grid(d, t, pitch)
            jobs.append(job)
            Ds.append(d)
            Ts.append(t)
            job.times = observed  # live view keeps the un-snapped walls
        if not jobs:
            return
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t0 = tel.clock()
        D = np.asarray(Ds, dtype=np.float64)
        T = np.asarray(Ts, dtype=np.float64)
        self._fold(jobs, D, T)
        for job, d, t in zip(jobs, Ds, Ts):
            job.pending_obs.append(([float(v) for v in d], [float(v) for v in t]))
            job.invalidate()
        self.rounds += 1
        if rec:
            tel.span_at("fleet.observe", t0, tel.clock(), jobs=len(jobs))
            self._stats_gauges(tel)
        if self.pipeline:
            # queue the NEXT epoch's stacked repartition over every admitted
            # tenant — the serving cycle's no-argument rebalance() fetches it
            self._predispatch_next(jobs=list(self._jobs.values()))

    def straggler_actions(
        self, times: Dict[str, Sequence[float]], *, auto_reprofile: bool = True
    ):
        """Scan one serving epoch's observed per-replica times against the
        PRE-fold estimates (call before :meth:`observe`); returns one
        ``StragglerAction`` per REPLICA.

        A replica's health signal is the MEDIAN observed/predicted ratio
        across the tenants it served that epoch — a replica-wide throttle
        inflates every tenant's slice, while one tenant's own noise cannot
        strike the replica.  REPROFILE actions are applied via
        :meth:`reprofile_replica` unless ``auto_reprofile=False``;
        QUARANTINE is reported for the caller to act on (drop the replica
        and rebuild/resize the fleet)."""
        from ..runtime.straggler import StragglerAction, StragglerDetector

        if self.detector is None:
            self.detector = StragglerDetector()
        det = self.detector
        per_replica: List[List[Tuple[float, int, float, float]]] = [
            [] for _ in range(self.p)
        ]
        for name, t in times.items():
            job = self._jobs[name]
            bank = job.bank()
            d = np.asarray(job.d, dtype=np.float64)
            obs = np.asarray(t, dtype=np.float64)
            pred = bank.time(d)
            usable = (bank.counts > 0) & (d > 0) & (obs > 0) & (pred > 0)
            for i in np.nonzero(usable)[0]:
                i = int(i)
                per_replica[i].append(
                    (float(obs[i] / pred[i]), int(d[i]), float(pred[i]), float(obs[i]))
                )
        actions = [StragglerAction.NONE] * self.p
        for i, rows in enumerate(per_replica):
            if not rows:
                continue
            rows.sort()
            ratio, di, predicted, observed = rows[len(rows) // 2]
            det.history.append((i, di, predicted, observed, ratio))
            actions[i] = det._strike(i, ratio)
        if auto_reprofile:
            for i, act in enumerate(actions):
                if act is StragglerAction.REPROFILE:
                    self.reprofile_replica(i)
        return actions

    def reprofile_replica(self, i: int) -> None:
        """Invalidate replica ``i``'s estimate in EVERY job (its speed
        function is stale fleet-wide — thermal throttle, contention): keep
        only a point rebuilt from each job's LAST OBSERVATION at its current
        allocation so the partitioner stays feasible where possible, and
        mark the stack dirty so the carry rebuilds from the pruned models.
        A row left empty is healed by the next :meth:`observe` fold before
        any repartition needs it.

        The kept point must come from the observation, not from the old
        model: the model's knot at the current allocation is exactly the
        prediction that just struck (a quantized serving fleet folds on the
        grid beside it, so keeping ``x == d[i]`` would preserve the stale
        knot and discard every fresh one)."""
        i = int(i)
        tel = _obs_active()
        if tel is not None and tel.enabled:
            tel.event("fleet.reprofile_replica", replica=i, jobs=len(self._jobs))
        for job in self._jobs.values():
            job.flush()
            # a reprofile takes effect immediately: the pre-reprofile stale
            # snapshot must not serve another pipelined repartition
            job._stale_bank = None
            m = job.models[i]
            if getattr(m, "num_points", 0) == 0:
                continue
            pts = []
            if len(job.d) == self.p and len(job.times) == self.p:
                di, ti = float(job.d[i]), float(job.times[i])
                if di > 0 and ti > 0:
                    if self.quantize > 0.0:
                        dq, tq = self._snap_grid([di], [ti], self.quantize)
                        di, ti = float(dq[0]), float(tq[0])
                    pts = [(di, di / ti)]
            job.models[i] = (
                PiecewiseLinearFPM.from_points(pts) if pts else PiecewiseLinearFPM()
            )
            job.empty_rows[i] = getattr(job.models[i], "num_points", 0) == 0
            job.invalidate()
        self._stack_dirty = True

    def run(self, executor, *, max_rounds: Optional[int] = None) -> Dict[str, Partition]:
        """Drive rounds until every admitted job finishes (each is bounded
        by its own ``max_iter``); returns name -> Partition."""
        r = 0
        while any(j.status != "done" for j in self._jobs.values()):
            if max_rounds is not None and r >= max_rounds:
                break
            self.step(executor)
            r += 1
        return {
            name: job.result
            for name, job in self._jobs.items()
            if job.result is not None
        }

    # -- profiles -------------------------------------------------------------

    def save_profiles(self, registry: Optional[ProfileRegistry] = None) -> None:
        """Fold every current job's learned estimates into the registry
        (without retiring anyone) — the periodic checkpoint a serving fleet
        takes so the next session warm-starts."""
        reg = registry if registry is not None else self.registry
        if reg is None or self.device_classes is None:
            raise ValueError("no registry / device_classes to save profiles into")
        for job in self._jobs.values():
            job.flush()
            reg.record_job(
                self.device_classes, job.spec.workload, job.models,
                energy_models=job.energy_models,
            )

    # -- checkpointing --------------------------------------------------------

    def drain(self) -> None:
        """Complete every in-flight pipeline stage and drop derived device
        state: discards the pre-dispatched next-round partition and the
        stale generation, materializes every job's deferred observations
        into the scalar mirrors, and waits until the newest carry is
        computed (an event on the stream that queued it, not the whole
        device).  After a drain the host models ARE the carry generation —
        the quiescence :meth:`state_dict` requires."""
        self._predispatched = None
        self._stacked_stale = None
        for job in self._jobs.values():
            job.flush()
            job._stale_bank = None
        if self._stacked is not None and self._stacked.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._stacked.device))
            ready.synchronize()

    def state_dict(self) -> Dict[str, Any]:
        """Serializable checkpoint of the whole fleet session (plain data,
        JSON-safe) in the reference's schema (version 1).  Checkpointing
        mid-round is legal in pipeline mode: :meth:`drain` runs first, so
        the pending carry generation is captured through the flushed host
        models and the restored session continues as the drained donor
        does.  Runtime attachments (registry, detector, executor) are not
        serialized; pass them to :meth:`from_state`."""
        self.drain()
        jobs = []
        for name, job in self._jobs.items():
            s = job.spec
            res = job.result
            jobs.append({
                "spec": {
                    "name": s.name, "n": int(s.n), "eps": float(s.eps),
                    "caps": [int(c) for c in s.caps] if s.caps is not None else None,
                    "min_units": int(s.min_units), "max_iter": int(s.max_iter),
                    "probe_budget": (
                        int(s.probe_budget) if s.probe_budget is not None else None
                    ),
                    "completion": s.completion, "workload": s.workload,
                    "warm_start_d": (
                        [int(v) for v in s.warm_start_d]
                        if s.warm_start_d is not None else None
                    ),
                },
                "models": [
                    [[float(x), float(sp)] for x, sp in m.as_points()]
                    for m in job.models
                ],
                "energy_models": (
                    [
                        [[float(x), float(sp)] for x, sp in m.as_points()]
                        for m in job.energy_models
                    ]
                    if job.energy_models is not None else None
                ),
                "status": job.status,
                "d": [int(v) for v in job.d],
                "times": [float(v) for v in job.times],
                "it": int(job.it),
                "probes_left": int(job.probes_left),
                "probe_budget": int(job.probe_budget),
                "seen": [
                    [[int(v) for v in k], [float(v) for v in t]]
                    for k, t in job.seen.items()
                ],
                "history": [
                    [[int(v) for v in d], [float(v) for v in t]]
                    for d, t in job.history
                ],
                "best_d": [int(v) for v in job.best_d],
                "best_t": [float(v) for v in job.best_t],
                "best_imb": float(job.best_imb),
                "bench_cost": float(job.bench_cost),
                "warm_from_registry": bool(job._warm_from_registry),
                "result": (
                    {
                        "allocations": [int(v) for v in res.allocations],
                        "times": [float(v) for v in res.times],
                        "imbalance": float(res.imbalance),
                        "converged": bool(res.converged),
                        "iterations": int(res.iterations),
                    }
                    if res is not None else None
                ),
            })
        return {
            "version": 1,
            "config": {
                "num_procs": self.p,
                "backend": self._backend,
                "alpha": self._alpha, "beta": self._beta,
                "groups": list(self.groups) if self.groups is not None else None,
                "sharding": None,
                "max_group_knots": self.max_group_knots,
                "staleness_tol": self.staleness_tol,
                "reserve_knots": self.reserve_knots,
                "quantize": self.quantize,
                "power_cap": self.power_cap,
                "lane_buckets": self.lane_buckets,
                "pipeline": self.pipeline,
                "pipeline_depth": self.pipeline_depth,
                "device_classes": (
                    list(self.device_classes)
                    if self.device_classes is not None else None
                ),
            },
            "carry_generation": (
                int(self._stacked.generation) if self._stacked is not None else 0
            ),
            "rounds": int(self.rounds),
            "jobs": jobs,
        }

    @classmethod
    def from_state(
        cls, state: Dict[str, Any], *, registry=None, detector=None,
        device="cuda", dtype=None, **overrides,
    ) -> "FleetScheduler":
        """Rebuild a fleet session from :meth:`state_dict` output — this
        package's or the reference's (``core/convert.py``: its ``"jax"``
        backend restores as ``"torch"``).  The stacked device carry is
        rebuilt lazily from the serialized models on the first round;
        ``registry``/``detector`` re-attach the runtime pieces a checkpoint
        does not carry, ``overrides`` replace config fields (e.g.
        ``backend="numpy"``)."""
        from ..core.convert import fleet_state_from_reference

        state = fleet_state_from_reference(state)
        cfg = dict(state["config"])
        cfg.update(overrides)
        fleet = cls(
            cfg.pop("num_procs"), registry=registry, detector=detector,
            device=device, dtype=dtype, **cfg,
        )
        for js in state["jobs"]:
            sp = dict(js["spec"])
            spec = JobSpec(
                name=sp["name"], n=int(sp["n"]), eps=float(sp["eps"]),
                caps=sp["caps"], min_units=int(sp["min_units"]),
                max_iter=int(sp["max_iter"]), probe_budget=sp["probe_budget"],
                completion=sp["completion"], workload=sp["workload"],
                warm_start_d=sp["warm_start_d"],
            )
            models = [
                PiecewiseLinearFPM.from_points([tuple(pt) for pt in pts])
                if pts else PiecewiseLinearFPM()
                for pts in js["models"]
            ]
            emodels = (
                [
                    PiecewiseLinearFPM.from_points([tuple(pt) for pt in pts])
                    if pts else PiecewiseLinearFPM()
                    for pts in js["energy_models"]
                ]
                if js["energy_models"] is not None else None
            )
            job = _Job(
                spec=spec,
                models=models,
                probes_left=int(js["probes_left"]),
                probe_budget=int(js["probe_budget"]),
                icaps=np.asarray(
                    _prep_unit_caps(
                        fleet.p, spec.n, spec.caps, int(spec.min_units)
                    ),
                    dtype=np.int64,
                ),
                empty_rows=np.asarray(
                    [getattr(m, "num_points", 0) == 0 for m in models],
                    dtype=bool,
                ),
                _warm_from_registry=bool(js["warm_from_registry"]),
                energy_models=emodels,
            )
            job.status = js["status"]
            job.d = [int(v) for v in js["d"]]
            job.times = [float(v) for v in js["times"]]
            job.it = int(js["it"])
            job.seen = {tuple(k): list(t) for k, t in js["seen"]}
            job.history = [(list(map(int, d)), list(t)) for d, t in js["history"]]
            job.best_d = [int(v) for v in js["best_d"]]
            job.best_t = [float(v) for v in js["best_t"]]
            job.best_imb = float(js["best_imb"])
            job.bench_cost = float(js["bench_cost"])
            job._prev_empty_any = bool(job.empty_rows.any())
            r = js["result"]
            if r is not None:
                job.result = Partition(
                    allocations=[int(v) for v in r["allocations"]],
                    t_star=None,
                    makespan=max(r["times"]) if r["times"] else None,
                    imbalance=float(r["imbalance"]),
                    converged=bool(r["converged"]),
                    iterations=int(r["iterations"]),
                    policy=Policy.DFPA,
                    backend=fleet._backend,
                    times=[float(v) for v in r["times"]],
                    diagnostics={
                        "history": job.history,
                        "models": job.models,
                        "probes_used": job.probe_budget - job.probes_left,
                        "bench_cost": job.bench_cost,
                    },
                )
            fleet._jobs[spec.name] = job
        fleet.rounds = int(state.get("rounds", 0))
        fleet._stack_dirty = True
        return fleet

    # -- internals ------------------------------------------------------------

    def _staleness_check(self, job: _Job, d, times) -> None:
        """One-shot after a warm-started job's first measured round: a device
        class whose warm prediction misses the measurement beyond
        ``staleness_tol`` (median relative error over its rows — robust to a
        single straggler) has its registry entry dropped with a warning."""
        job._warm_from_registry = False
        if (
            self.staleness_tol is None
            or self.registry is None
            or self.device_classes is None
            or job.spec.workload is None
        ):
            return
        errs: Dict[str, List[float]] = {}
        for i, cls_ in enumerate(self.device_classes):
            di, ti = int(d[i]), float(times[i])
            m = job.models[i]
            if di <= 0 or ti <= 0 or getattr(m, "num_points", 0) == 0:
                continue  # cold or unmeasured row: nothing was predicted
            pred = float(m.time(float(di)))
            if not (pred > 0):
                continue
            errs.setdefault(cls_, []).append(abs(ti - pred) / pred)
        for cls_, es in errs.items():
            med = sorted(es)[len(es) // 2]
            if med > self.staleness_tol and self.registry.drop(
                cls_, job.spec.workload
            ):
                tel = _obs_active()
                if tel is not None and tel.enabled:
                    tel.event(
                        "registry.stale_profile",
                        device_class=cls_,
                        workload=job.spec.workload,
                        median_rel_err=float(med),
                        tol=float(self.staleness_tol),
                    )
                warnings.warn(
                    f"stale warm profile ({cls_!r}, {job.spec.workload!r}): "
                    f"first measured round deviates {med:.0%} from the warm "
                    f"prediction (tol {self.staleness_tol:.0%}); entry "
                    "dropped, job continues from fresh measurements",
                    UserWarning,
                    stacklevel=3,
                )

    def _finish(self, job: _Job, d, t, converged: bool, imb: float) -> None:
        job.flush()  # diagnostics["models"] surfaces the live estimates
        job.status = "done"
        job.result = Partition(
            allocations=[int(v) for v in d],
            t_star=None,
            makespan=max(t) if t else None,
            imbalance=imb,
            converged=converged,
            iterations=job.it,
            policy=Policy.DFPA,
            backend=self._backend,
            times=[float(v) for v in t],
            diagnostics={
                "history": job.history,
                "models": job.models,
                "probes_used": job.probe_budget - job.probes_left,
                "bench_cost": job.bench_cost,
            },
        )

    def _device_bank(self, bank: ModelBank) -> TorchModelBank:
        return TorchModelBank.from_bank(bank, device=self._device, dtype=self.dtype)

    def _assign_lanes(self) -> Optional[TorchModelBank]:
        """(Re)build the lane order; on the torch backend also restack the
        device carry from the per-job host models (the lazy restack that
        admit/retire/reprofile scheduled)."""
        names = list(self._jobs)
        for lane, nm in enumerate(names):
            self._jobs[nm].lane = lane
        # A restack is a pipeline sync point: the new carry is rebuilt from
        # the FULLY folded host models (generation 0), so the previous
        # generation, the per-job stale snapshots and any pre-dispatched
        # next-round partition are all obsolete.
        self._stacked_stale = None
        self._predispatched = None
        for nm in names:
            job = self._jobs[nm]
            job._stale_bank = None
            job._prev_empty_any = bool(job.empty_rows.any())
        if self.reserve_knots is not None:
            # Keep the reservation binding: rows past half the budget are
            # thinned (even decimation, endpoints kept) so the padded width
            # stays exactly reserve_knots — registry-merged warm models can
            # arrive with arbitrarily many knots — and the remaining half is
            # fold headroom before any width doubling.
            budget = max(self.reserve_knots // 2, 2)
            for nm in names:
                job = self._jobs[nm]
                job.flush()
                thinned = False
                for i, m in enumerate(job.models):
                    if getattr(m, "num_points", 0) > budget:
                        pts = m.as_points()
                        idx = sorted(set(
                            int(round(v))
                            for v in np.linspace(0, len(pts) - 1, budget)
                        ))
                        job.models[i] = PiecewiseLinearFPM.from_points(
                            [pts[j] for j in idx]
                        )
                        thinned = True
                if thinned:
                    job.invalidate()
        if self._backend == "torch" and names:
            banks = [self._device_bank(self._jobs[nm].bank()) for nm in names]
            if self.lane_buckets:
                # Pad the lane count to the next power of two with dummy
                # monotone single-knot lanes: the stacked [q, p, k] shape is
                # shared by every fleet size in the bucket.  Dead lanes
                # carry n=0 / caps=0 / valid=False through the partition and
                # the fold (both are exact no-ops for such lanes).
                q_pad = 1
                while q_pad < len(names):
                    q_pad *= 2
                if q_pad > len(names):
                    dummy = self._device_bank(
                        ModelBank.from_models(
                            [PiecewiseLinearFPM.from_points([(1.0, 1.0)])] * self.p
                        )
                    )
                    banks.extend([dummy] * (q_pad - len(names)))
            self._stacked = TorchModelBank.stack(banks, min_k=self.reserve_knots)
            self.restacks += 1
            self._count("fleet.restack")
        self._stack_dirty = False
        return self._stacked

    def _ensure_stack(self) -> Optional[TorchModelBank]:
        if self._stack_dirty or self._stacked is None:
            self._assign_lanes()
        return self._stacked

    def _repartition(self, jobs: List[_Job]) -> List[List[int]]:
        """One distribution per job from the current estimates — a single
        stacked device solve on the torch backend, per-job host banks on
        numpy.  Identical per-lane math to q independent
        ``SpeedStore.partition_units`` calls.  With ``power_cap`` set the
        time-optimal answer gets the energy post-pass
        (:meth:`_apply_power_cap`)."""
        ds = self._repartition_time(jobs)
        if self.power_cap is not None:
            ds = self._apply_power_cap(jobs, ds)
        return ds

    def _apply_power_cap(self, jobs: List[_Job], ds: List[List[int]]) -> List[List[int]]:
        """Fit the round's predicted fleet energy under ``power_cap`` by
        walking every PRICED job (one with energy models) up a COMMON
        makespan-stretch factor ``theta``: job k's allocation is re-solved
        as the min-max-energy partition among the allocations reachable
        within time ``theta * t_opt_k`` (``core.energy
        .capped_energy_partition`` — the same count-under-threshold caps
        the Pareto front sweeps, so the capped answer sits ON the job's
        front).  ``theta`` is bisected over ``[1, theta_hi]`` where
        ``theta_hi`` makes each job's pure energy-optimal point reachable;
        the feasible (hi) side is kept, so the returned allocations'
        predicted energy fits the cap whenever ANY common stretch does —
        an infeasible cap degrades to the pure energy-optimal allocations
        (best effort).  theta=1 is NOT a no-op: allocations with the same
        makespan but lower energy are already taken there (the free lunch).
        Host numpy, as in the reference (serving q is small; the device
        carry is untouched).  Unpriced jobs keep their time-optimal
        allocations and price out of the budget."""
        from ..core.energy import capped_energy_partition

        priced = [
            (k, job) for k, job in enumerate(jobs) if job.ebank() is not None
        ]
        if not priced:
            return ds
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t_cap = tel.clock()

        def job_energy(job: _Job, d) -> float:
            e = job.ebank().time(np.asarray(d, dtype=np.float64))
            darr = np.asarray(d, dtype=np.float64)
            return float(np.where((darr > 0) & np.isfinite(e), e, 0.0).sum())

        def makespan(job: _Job, d) -> float:
            t = job.bank().time(np.asarray(d, dtype=np.float64))
            darr = np.asarray(d, dtype=np.float64)
            act = t[(darr > 0) & np.isfinite(t)]
            return float(act.max()) if act.size else 0.0

        if sum(job_energy(job, ds[k]) for k, job in priced) <= self.power_cap:
            if rec:
                tel.gauge("fleet.power_cap.theta", 1.0)
                tel.span_at("fleet.power_cap", t_cap, tel.clock(),
                            jobs=len(priced), feasible=True, capped=False)
            return ds

        # Per-job anchors: the time-optimal makespan (theta=1) and the pure
        # energy-optimal allocation (the far end of the job's front).
        t_opt, d_energy, theta_hi = {}, {}, 1.0
        for k, job in priced:
            t_opt[k] = makespan(job, ds[k])
            de, _ = _partition_units_bank(
                job.ebank(), int(job.spec.n), [int(c) for c in job.icaps],
                min_units=int(job.spec.min_units),
            )
            d_energy[k] = [int(v) for v in de]
            if t_opt[k] > 0:
                theta_hi = max(theta_hi, makespan(job, de) / t_opt[k])

        def solve(theta: float):
            out = {}
            for k, job in priced:
                d = capped_energy_partition(
                    job.bank(), job.ebank(), int(job.spec.n),
                    [int(c) for c in job.icaps], theta * t_opt[k],
                    floor_d=ds[k], min_units=int(job.spec.min_units),
                )
                out[k] = d if d is not None else d_energy[k]
            return out, sum(job_energy(job, out[k]) for k, job in priced)

        d_hi, e_hi = solve(theta_hi)
        theta_used, feasible = theta_hi, True
        if e_hi > self.power_cap:
            # No common stretch fits: best effort = pure energy-optimal.
            d_hi = dict(d_energy)
            feasible = False
        else:
            lo, hi = 1.0, theta_hi
            d_lo, e_lo = solve(lo)
            if e_lo <= self.power_cap:
                d_hi = d_lo  # the free lunch already fits
                theta_used = 1.0
            else:
                for _ in range(40):
                    mid = 0.5 * (lo + hi)
                    d_mid, e_mid = solve(mid)
                    if e_mid <= self.power_cap:
                        hi, d_hi = mid, d_mid
                    else:
                        lo = mid
                theta_used = hi
        if rec:
            tel.gauge("fleet.power_cap.theta", float(theta_used))
            tel.span_at("fleet.power_cap", t_cap, tel.clock(),
                        jobs=len(priced), feasible=feasible, capped=True)
        out = [list(d) for d in ds]
        for k, _ in priced:
            out[k] = [int(v) for v in d_hi[k]]
        return out

    def _repartition_time(self, jobs: List[_Job]) -> List[List[int]]:
        for job in jobs:
            # cheap incremental mirror of the store's empty-FPM feasibility
            # check, with the job named (the batched call couldn't say who)
            if bool(np.any((job.icaps > 0) & job.empty_rows)):
                raise ValueError(f"job {job.spec.name!r}: empty FPM")
        if self.groups is not None:
            return self._repartition_hier(jobs)
        if self._backend == "scalar":
            # The seed per-model loop (always the exact completion — the
            # session-knob demotion semantics of Scheduler._completion_for).
            out = []
            for job in jobs:
                job.flush()
                d, _ = _partition_units_scalar(
                    job.models, job.spec.n, [int(c) for c in job.icaps],
                    min_units=int(job.spec.min_units),
                )
                out.append([int(v) for v in d])
            return out
        if self._backend == "numpy":

            def solve(bank_of):
                out = []
                for job in jobs:
                    d, _ = _partition_units_bank(
                        bank_of(job),
                        job.spec.n, [int(c) for c in job.icaps],
                        min_units=int(job.spec.min_units),
                        completion=job.spec.completion,
                    )
                    out.append([int(v) for v in d])
                return out

            return self._speculate(jobs, solve)
        self._ensure_stack()
        carry = self._select_carry(jobs)
        pre, self._predispatched = self._predispatched, None
        if (
            pre is not None
            and pre["carry"] is carry
            and pre["fingerprint"] == self._repart_fingerprint(jobs)
        ):
            # the pre-dispatched partition (queued while the host finished
            # the last round) is exactly this repartition: fetch it (its
            # dispatch was counted when it was queued)
            d = fetch_partition(pre["deferred"])
        else:
            d = self._stacked_partition(jobs, carry)
        ds = [[int(v) for v in d[job.lane]] for job in jobs]
        if carry is not self._stacked:
            if self._speculation_hits(jobs, ds):
                self.stale_reads += 1
                self._count("fleet.stale_read")
                return ds
            # speculation missed: partition the newest carry — the stale
            # result is discarded and the round pays the fresh partition
            # sync would have paid, never more
            self.speculative_misses += 1
            self._count("fleet.speculative_miss")
            d = self._stacked_partition(jobs, self._stacked)
            ds = [[int(v) for v in d[job.lane]] for job in jobs]
        return ds

    def _stacked_partition(self, jobs: List[_Job], carry: TorchModelBank, defer: bool = False):
        """One stacked ``partition_units`` over ``carry`` for ``jobs``
        (counted in ``device_dispatches``)."""
        n_arr, caps_arr, mu_arr, lanes, auto = self._stack_args(jobs, carry, defer)
        d = carry.partition_units(
            n_arr, caps_arr, min_units=mu_arr, completion_lanes=lanes,
            auto_lanes=auto, defer=defer,
        )
        self.device_dispatches += 1
        return d

    def _stack_args(self, jobs: List[_Job], carry: TorchModelBank, defer: bool = False):
        """The stacked ``partition_units`` arguments for ``jobs`` over
        ``carry`` (non-participating lanes ride along as n=0 no-ops).

        Per-lane completion routing, resolved like q independent stores
        would: forced modes set their lanes, and ``"auto"`` lanes follow the
        stacked bank's per-lane monotonicity.  A sync call resolves those
        from ``carry.monotone_lanes()`` (one device reduction and read per
        fold, skipped when every job forces a mode); a deferred one passes
        them as ``auto`` for ``partition_units`` to resolve on the device."""
        q = int(carry.counts.shape[0])  # padded lane count under buckets
        n_arr = np.zeros(q, dtype=np.int64)
        mu_arr = np.zeros(q, dtype=np.int64)
        caps_arr = np.zeros((q, self.p), dtype=np.int64)
        lanes = np.zeros(q, dtype=bool)
        auto = np.zeros(q, dtype=bool)
        for job in jobs:
            n_arr[job.lane] = job.spec.n
            mu_arr[job.lane] = int(job.spec.min_units)
            caps_arr[job.lane] = job.icaps
            lanes[job.lane] = job.spec.completion == "threshold"
            auto[job.lane] = job.spec.completion == "auto"
        if not defer:
            if auto.any():
                lanes = np.where(auto, carry.monotone_lanes(), lanes)
            auto = None
        return n_arr, caps_arr, mu_arr, lanes, auto

    def _speculate(self, jobs: List[_Job], solve) -> List[List[int]]:
        """The host-snapshot form of the pipeline's speculative read (numpy
        backend, two-level route): partition the jobs' previous-generation
        snapshots when the pipeline allows it and keep the result if it
        moves every job; otherwise partition the current host mirrors."""
        if self._stale_usable(jobs) and all(job._stale_bank is not None for job in jobs):
            ds = solve(lambda job: job._stale_bank)
            if self._speculation_hits(jobs, ds):
                self.stale_reads += 1
                self._count("fleet.stale_read")
                return ds
            self.speculative_misses += 1
            self._count("fleet.speculative_miss")
        return solve(lambda job: job.bank())

    def _stale_usable(self, jobs: List[_Job]) -> bool:
        """Whether this repartition may read one fold generation behind the
        newest: pipeline mode with a positive depth, every target lane had
        estimates in the previous generation, no power-capped priced job
        (``_apply_power_cap`` must see host banks and carry from ONE
        generation), and — when the test seam is installed — the previous
        fold did not complete first."""
        return (
            self.pipeline
            and self.pipeline_depth > 0
            and all(not job._prev_empty_any for job in jobs)
            and not (
                self.power_cap is not None
                and any(job.ebank() is not None for job in jobs)
            )
            and not (self.fold_ready_hook is not None and self.fold_ready_hook())
        )

    def _select_carry(self, jobs: List[_Job]) -> TorchModelBank:
        """The carry generation this repartition reads (torch backend): the
        previous (stale) generation when the pipeline allows it — never more
        than ``pipeline_depth`` folds behind — else the newest."""
        stale = self._stacked_stale
        if (
            stale is not None
            and self._stacked.generation - stale.generation <= self.pipeline_depth
            and self._stale_usable(jobs)
        ):
            return stale
        return self._stacked

    def _speculation_hits(self, jobs: List[_Job], ds: List[List[int]]) -> bool:
        """Validate a speculative (stale-generation) repartition: it is
        consumed only when it advances EVERY job.  A distribution already in
        a job's seen set means the stale estimates taught that lane nothing
        new — the fold->partition dependency was real this round — so the
        caller falls back to the newest generation, and the seen-set probe
        escape only ever fires on fresh evidence."""
        return not any(tuple(d) in job.seen for job, d in zip(jobs, ds))

    def _repart_fingerprint(self, jobs: List[_Job]):
        """Identity of a stacked repartition's host inputs — a pre-dispatched
        partition is only consumed when the participant set and every
        per-job knob it was built from are unchanged."""
        return tuple(
            (
                job.spec.name, job.lane, int(job.spec.n),
                int(job.spec.min_units), job.spec.completion,
                job.icaps.tobytes(),
            )
            for job in jobs
        )

    def _predispatch_next(self, jobs: Optional[List[_Job]] = None) -> None:
        """Queue the NEXT round's stacked repartition on the card before this
        round returns (pipeline mode, torch backend): the deferred program
        reads nothing back, so the host returns at once and the card solves
        while the host does the round's bookkeeping and the caller's work;
        next round's Phase 2 fetches the result instead of dispatching.
        Skipped whenever the inputs might change before they are used
        (membership changes mark the stack dirty), on the two-level route,
        under a power cap and with the test seam installed.

        ``jobs`` names the anticipated next-round participants: ``step``
        uses the still-running jobs, the serving cycle (:meth:`observe`)
        every admitted tenant — what a no-argument ``rebalance`` targets."""
        if (
            not self.pipeline
            or self._backend != "torch"
            or self.groups is not None
            or self.power_cap is not None
            or self.fold_ready_hook is not None
            or self._stack_dirty
            or self._stacked is None
        ):
            return
        if jobs is None:
            jobs = [j for j in self._jobs.values() if j.status == "running"]
        if not jobs or any(bool(np.any((j.icaps > 0) & j.empty_rows)) for j in jobs):
            return
        carry = self._select_carry(jobs)
        deferred = self._stacked_partition(jobs, carry, defer=True)
        self.predispatches += 1
        self._count("fleet.predispatch")
        self._predispatched = {
            "carry": carry,
            "fingerprint": self._repart_fingerprint(jobs),
            "deferred": deferred,
        }

    def _repartition_hier(self, jobs: List[_Job]) -> List[List[int]]:
        """The two-level route (``groups=`` set): one ``Hierarchy`` solve per
        job over the job's host mirror (``job.bank()``, which in a sync
        round holds the carry's values — no device-to-host copy of the
        carry).  On ``"torch"`` each job's inner solves run as one stacked
        device solve (``device_dispatches`` += 1 per job, as the reference
        counts its per-job inner programs); the carry keeps taking the
        one-program fold-in.  In pipeline mode the previous generation is
        each job's host snapshot (``_stale_bank``), under the flat route's
        validation."""

        def solve(bank_of):
            out = []
            for job in jobs:
                h = Hierarchy.from_bank(
                    bank_of(job),
                    self.groups,
                    backend="torch" if self._backend == "torch" else "numpy",
                    max_group_knots=self.max_group_knots,
                    dtype=self.dtype,
                    device=self._device if self._backend == "torch" else "cpu",
                )
                d = h.partition_units(
                    int(job.spec.n),
                    np.asarray(job.icaps, dtype=np.int64),
                    min_units=int(job.spec.min_units),
                    completion=job.spec.completion,
                )
                if self._backend == "torch":
                    self.device_dispatches += 1
                out.append([int(v) for v in d])
            return out

        return self._speculate(jobs, solve)

    def _fold(self, measured: List[_Job], D: np.ndarray, T: np.ndarray) -> None:
        """One stacked fold-in of this round's observations (torch backend;
        rows of non-measuring lanes masked invalid).  The host mirrors are
        updated by the caller AFTER this, so a dirty stack rebuilt here
        never double-counts the round.

        In pipeline mode (positive depth) the fold is double-buffered: the
        pre-fold carry is kept as the stale generation and the fold writes
        new tensors (``fold_in(donate=False)``), so the next round's
        repartition may read the old generation — bounded by
        ``pipeline_depth``.  Per-job ``_prev_empty_any`` / ``_stale_bank``
        snapshots taken here are what a stale repartition may consume."""
        ok = (D > 0) & (T > 0)
        pipelined = self.pipeline and self.pipeline_depth > 0
        # Pre-fold snapshots (what the generation becoming stale contains),
        # applied only after _ensure_stack below: a dirty restack inside
        # this fold resyncs _prev_empty_any to the CURRENT host state, but
        # the carry it builds predates this round's observations.
        prev_any = (
            [bool(job.empty_rows.any()) for job in measured] if pipelined else None
        )
        if pipelined and (self._backend != "torch" or self.groups is not None):
            for job in measured:
                job._stale_bank = job.bank()
        stacked = self._ensure_stack() if self._backend == "torch" else None
        for k, job in enumerate(measured):
            if pipelined:
                job._prev_empty_any = prev_any[k]
            job.empty_rows = job.empty_rows & ~ok[k]
        if stacked is None:
            return
        q = int(stacked.counts.shape[0])  # padded lane count under buckets
        lanes = [job.lane for job in measured]
        x = np.zeros((q, self.p), dtype=np.float64)
        s = np.ones((q, self.p), dtype=np.float64)
        valid = np.zeros((q, self.p), dtype=bool)
        x[lanes] = D
        s[lanes] = np.where(ok, D / np.where(T > 0, T, 1.0), 1.0)
        valid[lanes] = ok
        if pipelined:
            self._stacked_stale = stacked
            self._stacked = stacked.fold_in(x, s, valid, donate=False)
        else:
            self._stacked = stacked.fold_in(x, s, valid)
        self.device_dispatches += 1
