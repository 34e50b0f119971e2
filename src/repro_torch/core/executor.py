"""Executor protocol: how DFPA runs a distribution and observes times.

The paper's step 4 executes ``d_i`` computation units on every processor in
parallel and gathers the times.  ``Executor.run(d) -> times`` abstracts it,
so one DFPA loop drives:

* ``SimulatedExecutor`` / ``BatchedSimulatedExecutor`` — the cluster
  simulator (benchmarks, tests);
* ``CallableExecutor`` — real per-processor callables, such as the
  ``matmul_update`` kernel on row panels, timed by the clock of the device
  they run on;
* ``BatchedSimulatedExecutor2D`` — a :class:`FleetExecutor`: every
  measuring job of a fleet round (``fleet/scheduler.py``) in one call;
* ``DelayedBatchedExecutor`` — wraps a :class:`FleetExecutor` and records
  when each job's measurement would have completed on an asynchronous
  platform, for the fleet's pipelined rounds.

``run`` returns per-processor execution times for one parallel round; the
round's wall-clock cost is ``max(times)`` plus the collective overhead the
executor models.  ``TraceExecutor2D`` is the trace-driven fleet executor
of the serving harness: its time function reads a trace clock.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Protocol, Sequence, Set

import numpy as np
import torch

from .modelbank_torch import resolve_device

try:  # telemetry is optional: the executors run identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent
    def _obs_active():
        return None

__all__ = [
    "Executor",
    "FleetExecutor",
    "SimulatedExecutor",
    "BatchedSimulatedExecutor",
    "BatchedSimulatedExecutor2D",
    "CallableExecutor",
    "DelayedBatchedExecutor",
    "TraceExecutor2D",
    "RoundLog",
    "FleetRoundLog",
]


@dataclass
class RoundLog:
    """One DFPA round: the distribution sent out and the times gathered.

    ``t_wall`` is the monotonic wall-clock timestamp the round was logged at
    (the logging component's injectable clock; 0.0 when the producer does
    not stamp).  Excluded from equality so replay comparisons stay
    timestamp-agnostic."""

    d: List[int]
    times: List[float]
    wall_cost: float  # max(times) + modelled collective overhead
    t_wall: float = field(default=0.0, compare=False)


@dataclass
class FleetRoundLog:
    """One multi-tenant fleet round on a TIME-SLICED fleet: every measuring
    tenant's distribution and per-processor times, costed by the busiest
    processor's SUM across tenants — the round's true wall-clock when each
    processor serves its tenants back to back.  (Logging one ``RoundLog``
    per tenant at ``max(times)`` each under-reports the round by up to q×:
    a tenant's own slice finishing fast does not free the processor that is
    still working through the other tenants' slices.)"""

    names: List[str]
    D: List[List[int]]  # D[k][i]: units of tenant k on processor i
    times: List[List[float]]  # per-(tenant, processor) slice times
    proc_busy: List[float]  # per-processor sum across tenants
    wall_cost: float  # max(proc_busy) + modelled collective overhead
    t_wall: float = field(default=0.0, compare=False)  # see RoundLog.t_wall


class Executor(Protocol):
    @property
    def num_procs(self) -> int: ...

    def run(self, d: Sequence[int]) -> List[float]:
        """Execute ``d[i]`` units on processor ``i`` in parallel; return times."""
        ...

    def round_cost(self, times: Sequence[float]) -> float:
        """Wall-clock cost of one parallel round (incl. collectives)."""
        ...


class FleetExecutor(Protocol):
    """Multi-job executor: one round runs several jobs' distributions over
    the SAME fleet of ``num_procs`` processors at once (the
    ``FleetScheduler``'s measurement primitive).  ``run_jobs`` receives the
    NAME of every job measuring this round (names are the stable identity —
    stack lanes shift when jobs retire) plus their distributions
    ``D[len(names), p]`` and returns the matching times — the batched
    analogue of ``Executor.run``."""

    @property
    def num_procs(self) -> int: ...

    def run_jobs(self, names: Sequence[str], D) -> "object":
        """Run ``D[k, i]`` units of job ``names[k]`` on processor ``i``;
        return times of the same ``[len(names), p]`` shape."""
        ...


@dataclass
class SimulatedExecutor:
    """Drives DFPA against ground-truth time functions ``time_fns[i](x)``.

    ``alpha + beta * p`` models the paper's gather of ``p`` times and scatter
    of ``p`` allocations; ``noise`` optionally perturbs observations
    (multiplicative, reproducible via the numpy Generator ``rng``).
    """

    time_fns: Sequence[Callable[[float], float]]
    alpha: float = 1e-4  # collective latency (s)
    beta: float = 1e-6  # per-rank cost (s)
    noise: float = 0.0
    rng: object = None  # numpy Generator when noise > 0
    logs: List[RoundLog] = field(default_factory=list)

    @property
    def num_procs(self) -> int:
        return len(self.time_fns)

    def run(self, d: Sequence[int]) -> List[float]:
        times = []
        for i, di in enumerate(d):
            t = float(self.time_fns[i](float(di))) if di > 0 else 0.0
            if self.noise > 0.0 and self.rng is not None and di > 0:
                t *= 1.0 + self.noise * float(self.rng.standard_normal())
                t = max(t, 1e-12)
            times.append(t)
        self.logs.append(RoundLog(list(map(int, d)), times, self.round_cost(times)))
        return times

    def round_cost(self, times: Sequence[float]) -> float:
        return max(times) + self.alpha + self.beta * self.num_procs

    @property
    def total_cost(self) -> float:
        return sum(l.wall_cost for l in self.logs)


@dataclass
class BatchedSimulatedExecutor:
    """Fleet-scale simulator: ONE vector-valued time function for all ``p``
    processors (e.g. ``simulator.time_fn_1d_batch``), so a round costs one
    array op.  Mirrors ``SimulatedExecutor``'s overhead and noise model."""

    time_fn_batch: Callable  # x[p] -> t[p], 0 where x <= 0
    p: int
    alpha: float = 1e-4
    beta: float = 1e-6
    noise: float = 0.0
    rng: object = None
    logs: List[RoundLog] = field(default_factory=list)

    @property
    def num_procs(self) -> int:
        return self.p

    def run(self, d: Sequence[int]) -> List[float]:
        x = np.asarray(d, dtype=np.float64)
        t = np.asarray(self.time_fn_batch(x), dtype=np.float64)
        t = np.where(x > 0, t, 0.0)
        if self.noise > 0.0 and self.rng is not None:
            jitter = 1.0 + self.noise * self.rng.standard_normal(self.p)
            t = np.where(x > 0, np.maximum(t * jitter, 1e-12), 0.0)
        times = [float(v) for v in t]
        self.logs.append(RoundLog(list(map(int, d)), times, self.round_cost(times)))
        return times

    def round_cost(self, times: Sequence[float]) -> float:
        return max(times) + self.alpha + self.beta * self.num_procs

    @property
    def total_cost(self) -> float:
        return sum(l.wall_cost for l in self.logs)


@dataclass
class BatchedSimulatedExecutor2D:
    """Multi-job fleet simulator: ONE ``[q, p]``-valued time function for all
    ``q`` jobs x ``p`` processors, so a whole fleet round — every admitted
    job's measurement — costs one array op instead of ``q * p`` Python
    calls.  This is the measurement half of the stacked-bank round driver
    (``fleet/scheduler.py``); the 2-D grid partitioner drives its per-column
    inner DFPA loops through it too (one executor for all ``q`` columns).

    ``time_fn_batch_2d(X) -> T`` must accept the full ``[q, p]`` row space
    (rows of jobs not measuring this round are zero; its values there are
    discarded).  ``job_names`` maps job names to rows of that space (row =
    index into the list); without it, names must be integer-like and index
    the rows directly.  Mirrors ``SimulatedExecutor``'s collective-overhead
    and noise model per job: one job's round costs ``max(times) + alpha +
    beta * p``.
    """

    time_fn_batch_2d: Callable  # X[q, p] -> T[q, p], values at X <= 0 ignored
    p: int
    q: int
    job_names: Optional[Sequence[str]] = None  # row k serves job_names[k]
    alpha: float = 1e-4
    beta: float = 1e-6
    noise: float = 0.0
    rng: object = None
    logs: List[RoundLog] = field(default_factory=list)  # one per (job, round)

    @property
    def num_procs(self) -> int:
        return self.p

    def _row(self, name) -> int:
        if self.job_names is not None:
            rows = getattr(self, "_row_of", None)
            if rows is None:
                rows = {nm: i for i, nm in enumerate(self.job_names)}
                self._row_of = rows  # job_names is fixed at construction
            return rows[name]
        return int(name)

    def run_jobs(self, names: Sequence[str], D):
        rows = [self._row(nm) for nm in names]
        X = np.zeros((self.q, self.p), dtype=np.float64)
        X[rows] = np.asarray(D, dtype=np.float64)
        T = np.asarray(self.time_fn_batch_2d(X), dtype=np.float64)
        T = np.where(X > 0, T, 0.0)
        if self.noise > 0.0 and self.rng is not None:
            jitter = 1.0 + self.noise * self.rng.standard_normal((self.q, self.p))
            T = np.where(X > 0, np.maximum(T * jitter, 1e-12), 0.0)
        out = T[rows]
        for k, r in enumerate(rows):
            times = [float(v) for v in out[k]]
            self.logs.append(
                RoundLog([int(v) for v in X[r]], times, self.round_cost(times))
            )
        return out

    def run(self, d: Sequence[int]) -> List[float]:
        """Single-job adapter (row 0), so the 2-D executor also satisfies
        the plain ``Executor`` protocol for one-job fleets."""
        name = self.job_names[0] if self.job_names is not None else 0
        return [float(v) for v in self.run_jobs([name], [list(d)])[0]]

    def round_cost(self, times: Sequence[float]) -> float:
        return max(times) + self.alpha + self.beta * self.num_procs

    @property
    def total_cost(self) -> float:
        return sum(l.wall_cost for l in self.logs)


@dataclass
class DelayedBatchedExecutor:
    """Async-completion test double for the pipelined fleet rounds: wraps an
    inner :class:`FleetExecutor` and models WHEN each job's measurement would
    have completed on a real asynchronous platform — without perturbing the
    returned times, so every bit-parity check against the bare inner executor
    still holds.

    Each ``run_jobs`` call delegates to ``inner`` unchanged, then computes a
    simulated finish instant per job: the job's slowest lane time plus a
    configurable per-job ``lane_latency`` (dict or callable ``name ->
    seconds``, e.g. a straggler NIC on one replica).  Ties are broken by a
    seeded permutation, so runs with equal latencies still exercise a
    reproducible *non-submission* completion order.  The observed order is
    appended to ``completions`` as ``(finish_clock, name)`` events and the
    simulated ``clock`` advances to the round's last finish — tests replay
    exact interleavings from these events instead of relying on real
    asynchronous timing.
    """

    inner: object  # FleetExecutor (e.g. BatchedSimulatedExecutor2D)
    lane_latency: object = None  # dict/callable name -> extra seconds, or None
    seed: int = 0
    completions: List[tuple] = field(default_factory=list)  # (clock, name)
    clock: float = 0.0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def num_procs(self) -> int:
        return self.inner.num_procs

    def _latency(self, name) -> float:
        lat = self.lane_latency
        if lat is None:
            return 0.0
        if callable(lat):
            return float(lat(name))
        return float(lat.get(name, 0.0))

    def run_jobs(self, names: Sequence[str], D):
        T = self.inner.run_jobs(names, D)
        arr = np.asarray(T, dtype=np.float64)
        finish = [
            self.clock + float(arr[k].max()) + self._latency(nm)
            for k, nm in enumerate(names)
        ]
        tie = self._rng.permutation(len(finish))
        for k in sorted(range(len(finish)), key=lambda k: (finish[k], int(tie[k]))):
            self.completions.append((float(finish[k]), str(names[k])))
        if finish:
            self.clock = max(finish)
        return T

    def run(self, d: Sequence[int]) -> List[float]:
        times = self.inner.run(d)
        finish = self.clock + float(np.max(np.asarray(times))) if times else self.clock
        self.completions.append((float(finish), "job"))
        self.clock = finish
        return times

    def round_cost(self, times: Sequence[float]) -> float:
        return self.inner.round_cost(times)

    @property
    def logs(self):
        return self.inner.logs

    @property
    def total_cost(self) -> float:
        return self.inner.total_cost


@dataclass
class TraceExecutor2D:
    """Trace-driven fleet executor: the ground-truth time function takes the
    current TRACE CLOCK — ``time_fn_trace_2d(X[q, p], t) -> T[q, p]`` — so
    drifting speed functions, diurnal thermal effects and straggler
    throttles are functions of *when* a round runs, not of how many rounds
    ran.  The serving harness advances ``now`` between epochs (simulated
    trace seconds); each ``run_jobs`` call evaluates the fleet at that
    instant and logs ONE :class:`FleetRoundLog` with the time-sliced round
    cost (the busiest processor's sum across tenants).  Noise mirrors
    ``BatchedSimulatedExecutor2D`` (multiplicative, seeded numpy ``rng``).
    Host numpy, like the other simulated executors."""

    time_fn_trace_2d: Callable  # (X[q, p], t) -> T[q, p], X <= 0 ignored
    p: int
    now: float = 0.0  # the trace clock, advanced by the harness
    alpha: float = 0.0
    beta: float = 0.0
    noise: float = 0.0
    rng: object = None
    logs: List[FleetRoundLog] = field(default_factory=list)

    @property
    def num_procs(self) -> int:
        return self.p

    def run_jobs(self, names: Sequence[str], D):
        X = np.asarray(D, dtype=np.float64)
        T = np.asarray(self.time_fn_trace_2d(X, float(self.now)), dtype=np.float64)
        T = np.where(X > 0, T, 0.0)
        if self.noise > 0.0 and self.rng is not None:
            jitter = 1.0 + self.noise * self.rng.standard_normal(X.shape)
            T = np.where(X > 0, np.maximum(T * jitter, 1e-12), 0.0)
        busy = T.sum(axis=0)
        self.logs.append(
            FleetRoundLog(
                names=[str(nm) for nm in names],
                D=[[int(v) for v in row] for row in X],
                times=[[float(v) for v in row] for row in T],
                proc_busy=[float(v) for v in busy],
                wall_cost=float(busy.max()) + self.alpha + self.beta * self.p,
            )
        )
        return T

    def run(self, d: Sequence[int]) -> List[float]:
        """Single-job adapter, so the trace executor also satisfies the
        plain ``Executor`` protocol for one-tenant fleets."""
        return [float(v) for v in self.run_jobs(["job"], [list(d)])[0]]

    def round_cost(self, times: Sequence[float]) -> float:
        return max(times) + self.alpha + self.beta * self.p

    @property
    def total_cost(self) -> float:
        return sum(log.wall_cost for log in self.logs)


@dataclass
class CallableExecutor:
    """Times real per-processor work ``fns[i](d_i)`` on ``device``.

    On a CUDA device the callables only enqueue kernels, so a host clock
    around them measures the launch, not the work.  Each processor's time is
    therefore read from the device's own clock: a CUDA event recorded on the
    current stream before the callable and one after it, the end event
    synchronized, ``elapsed_time / 1e3`` seconds.  On the CPU
    (``device="cpu"``) the host clock is the device clock.

    Each processor runs once untimed before its first timed run (the
    warm-up: first-use set-up such as building a kernel is not round time).
    On a single host the "parallel" round runs sequentially and is costed as
    ``max(times)`` — the quantity the paper's parallel rounds expose.

    With a telemetry sink (``repro_torch.obs``, or ``torch.profiler``
    recording) each timed run records an ``executor.proc`` span on the
    host, from before the start event to after the end event's
    synchronization, with the seconds read as ``device_s``.
    """

    fns: Sequence[Callable[[int], None]]
    device: object = "cuda"
    logs: List[RoundLog] = field(default_factory=list)
    warmed: Set[int] = field(default_factory=set, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def num_procs(self) -> int:
        return len(self.fns)

    def _timed(self, i: int, di: int) -> float:
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t_span = tel.clock()
        if self.device.type != "cuda":
            t0 = _time.perf_counter()
            self.fns[i](di)
            seconds = _time.perf_counter() - t0
        else:
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self.fns[i](di)
            end.record(stream)
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        if rec:
            tel.span_at("executor.proc", t_span, tel.clock(),
                        proc=i, units=di, round=len(self.logs), device_s=seconds)
        return seconds

    def run(self, d: Sequence[int]) -> List[float]:
        d = [int(v) for v in d]
        cold = [i for i, di in enumerate(d) if di > 0 and i not in self.warmed]
        for i in cold:
            self.fns[i](d[i])
            self.warmed.add(i)
        if cold and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        times = [self._timed(i, di) if di > 0 else 0.0 for i, di in enumerate(d)]
        self.logs.append(RoundLog(d, times, self.round_cost(times)))
        return times

    def round_cost(self, times: Sequence[float]) -> float:
        return max(times)

    @property
    def total_cost(self) -> float:
        return sum(l.wall_cost for l in self.logs)
