"""Serving: the single-replica prefill/decode engine and DFPA-balanced
request dispatch across replicas.

``ServeEngine`` is the port's copy of the reference's
(``src/repro/runtime/serve_loop.py:60-93``): prefill the prompt into a
fixed KV budget, then decode greedily one token at a time.  Where the
reference jit-compiles prefill and decode, the port runs them eagerly
under ``torch.inference_mode``; on the card prefill reaches the
``flash_attention`` kernel (and ``rglru_scan`` for recurrent layers) and
decode runs plain torch.

``ReplicaDispatcher`` runs DFPA over request chunks: a replica's time for
``x`` chunks is a nonlinear function of ``x`` (the weight-read floor of a
small batch, the GEMMs' tile waves, memory past a batch threshold) — a
speed function unknown in advance on a heterogeneous fleet.

Serving under traffic
---------------------

The online lifecycle keeps the warm state across epochs.  Per traffic
epoch:

1. ``balance_fleet(tenants)`` at tenant-set changes (admit/retire ride the
   WARM fleet session — jobs, the stacked carry and per-lane caches all
   persist; only a backend or replica-count change pays a fresh session,
   and even then an attached registry carries the profiles over);
2. ``fleet.rebalance(loads)`` every epoch as tenant traffic drifts — one
   stacked partition, no measurement;
3. ``fleet.straggler_actions(times)`` on the epoch's measured per-replica
   times BEFORE folding them (predictions must come from the pre-epoch
   estimates) — REPROFILE re-learns a throttled replica, QUARANTINE tells
   the caller to drop it;
4. ``fleet.observe(times)`` folds the epoch's observations into the
   stacked carry (one fold-in).

Epoch wall-clock on a time-sliced fleet is the busiest replica's SUM across
tenants (``FleetRoundLog.wall_cost``), not any single tenant's max.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.executor import FleetRoundLog, RoundLog
from ..core.modelbank_torch import resolve_device
from ..core.scheduler import Partition, Policy, Scheduler
from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_cache, prefill

try:  # telemetry is optional: serving runs identically without obs/
    from ..obs.telemetry import active as _obs_active
except ImportError:  # pragma: no cover - obs layer absent

    def _obs_active():
        return None


__all__ = ["ServeEngine", "ReplicaDispatcher"]


class ServeEngine:
    """Single-replica engine: prefill + greedy decode with a fixed KV budget,
    on ``device`` (the model's parameters must already lie there)."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int, seq_budget: int, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        off = {p.device for p in params.parameters()} - {self.device}
        if off:
            raise ValueError(f"parameters lie on {sorted(map(str, off))}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.seq_budget = seq_budget

    def new_cache(self):
        return init_cache(self.cfg, self.batch, self.seq_budget, self.cfg.dtype, self.device)

    def generate(self, tokens: torch.Tensor, max_new: int, *, greedy: bool = True) -> torch.Tensor:
        """tokens: (B, S_prompt) -> (B, max_new) generated ids.

        As in the reference, the prompt plus the new tokens may run past
        ``seq_budget``: a local layer keeps a ring of ``min(seq_budget,
        window)`` slots, a global layer's ``seq_budget`` slots wrap the same
        way (its oldest positions are overwritten), and the RG-LRU state
        does not depend on the budget.

        Records an ``engine.generate`` span: the host time of the call (the
        cache made, prefill and decode enqueued; it does not wait for the
        card)."""
        if not greedy:
            raise NotImplementedError("only greedy decoding, as in the reference")
        B, S = tokens.shape
        if B != self.batch:
            raise ValueError(f"tokens {tuple(tokens.shape)} do not fit batch {self.batch}")
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if rec:
            t0 = tel.clock()
        tokens = tokens.to(self.device)
        with torch.inference_mode():
            logits, caches = prefill(self.params, self.cfg, tokens, self.new_cache())
            tok = torch.argmax(logits, -1)[:, None]
            out = [tok]
            pos = S
            for _ in range(1, max_new):
                logits, caches = decode_step(self.params, self.cfg, tok, pos, caches)
                tok = torch.argmax(logits, -1)[:, None]
                out.append(tok)
                pos += 1
            generated = torch.cat(out, dim=1)
        if rec:
            tel.span_at("engine.generate", t0, tel.clock(), batch=B, prompt_tokens=S, new_tokens=max_new)
        return generated


@dataclass
class ReplicaDispatcher:
    """DFPA over request chunks across heterogeneous serving replicas.

    ``replica_run(i, x)`` must process ``x`` request chunks on replica ``i``
    and return the wall time (real engines or simulators both fit).  The
    dispatcher is an ``Executor``; :meth:`balance` drives it through the
    ``Scheduler`` facade and leaves the warm session on ``self.scheduler``
    for the online lifecycle (``observe`` / ``join`` / ``leave``).

    Fleet mode (multi-tenant serving): :meth:`balance_fleet` admits one job
    per tenant request stream into a ``FleetScheduler`` — one stacked bank,
    one partition + one fold-in per round for ALL tenants — and leaves the
    warm fleet session on ``self.fleet`` for the online lifecycle
    (``admit`` / ``retire`` / ``resize`` / further ``step`` s).  Repeated
    ``balance_fleet`` calls REUSE that warm session (new tenants admitted,
    absent ones retired, changed ``n`` resized) so the stacked carry and
    per-lane caches survive; only a backend or replica-count change pays a
    fresh session.  With a ``ProfileRegistry`` (plus ``device_classes``) and
    per-tenant ``workload`` tags, tenants warm-start from profiles saved by
    earlier sessions instead of paying cold CPM probes.

    ``device`` is where every ``Scheduler`` and torch ``FleetScheduler`` the
    dispatcher builds keeps its bank (``"cuda"`` by default; pass
    ``device="cpu"`` to run on the host).
    """

    replica_run: Callable[[int, int], float]
    num_replicas: int
    eps: float = 0.1
    # The typed serving log: single-tenant rounds append RoundLog, fleet
    # rounds append FleetRoundLog — both stamped with ``clock()`` at append
    # time (``t_wall``), so post-hoc analysis can line rounds up against
    # external events without the dispatcher having run under telemetry.
    logs: List[Union[RoundLog, FleetRoundLog]] = field(default_factory=list)
    scheduler: Optional[Scheduler] = None
    fleet: object = None  # warm FleetScheduler session (balance_fleet)
    exec_host_s: float = 0.0  # host wall spent simulating/serving in run*()
    clock: Callable[[], float] = time.monotonic  # injectable log timestamper
    device: object = "cuda"

    @property
    def num_procs(self) -> int:
        return self.num_replicas

    def run(self, d: Sequence[int]) -> List[float]:
        t0 = time.perf_counter()
        times = [
            self.replica_run(i, int(x)) if x > 0 else 0.0 for i, x in enumerate(d)
        ]
        self.exec_host_s += time.perf_counter() - t0
        self.logs.append(
            RoundLog(list(map(int, d)), times, max(times), t_wall=self.clock())
        )
        return times

    def run_jobs(self, names: Sequence[str], D):
        """FleetExecutor protocol: one multi-tenant round — every measuring
        tenant's chunks on every replica (time-sliced per replica, so each
        (tenant, replica) cell is an independent ``replica_run`` call).

        Logs ONE :class:`FleetRoundLog` for the round, costed time-sliced:
        the round's wall-clock is the busiest replica's SUM across tenants
        (each replica serves its tenants' slices back to back), with the
        per-tenant slice times kept on the log."""
        t0 = time.perf_counter()
        out = []
        for k, _name in enumerate(names):
            out.append(
                [
                    self.replica_run(i, int(x)) if x > 0 else 0.0
                    for i, x in enumerate(D[k])
                ]
            )
        self.exec_host_s += time.perf_counter() - t0
        T = np.asarray(out, dtype=np.float64)
        busy = T.sum(axis=0) if len(out) else np.zeros(self.num_replicas)
        self.logs.append(
            FleetRoundLog(
                names=[str(nm) for nm in names],
                D=[[int(v) for v in row] for row in D],
                times=[[float(v) for v in row] for row in T],
                proc_busy=[float(v) for v in busy],
                wall_cost=float(busy.max()) if len(out) else 0.0,
                t_wall=self.clock(),
            )
        )
        tel = _obs_active()
        if tel is not None and tel.enabled and len(out):
            # Per-replica busy windows on per-replica tracks, laid out on the
            # SIMULATED serving timeline (epochs back to back) so the trace
            # viewer shows each replica's time-sliced load per epoch.
            if not hasattr(self, "_sim_t"):
                self._sim_t = tel.clock()
            t0_sim = self._sim_t
            for i, b in enumerate(busy):
                if b > 0:
                    tel.span_at("serve.replica_busy", t0_sim, t0_sim + float(b),
                                track=f"replica:{i}", tenants=len(names))
            self._sim_t = t0_sim + float(busy.max())
        return T

    def round_cost(self, times: Sequence[float]) -> float:
        return max(times)

    def balance(self, n_chunks: int, **kw) -> Partition:
        """Find the balanced chunk distribution for this fleet (the DFPA
        measurement loop, via the facade)."""
        if self.scheduler is None:
            self.scheduler = Scheduler(policy=Policy.DFPA, eps=self.eps, device=self.device)
        return self.scheduler.autotune(self, n_chunks, self.eps, **kw)

    def balance_fleet(
        self,
        tenants: Dict[str, int],
        *,
        backend: str = "torch",
        registry=None,
        device_classes: Optional[Sequence[str]] = None,
        workloads: Optional[Dict[str, str]] = None,
        reserve_knots: Optional[int] = None,
        quantize: Optional[float] = None,
        staleness_tol: Optional[float] = None,
        pipeline: bool = False,
        pipeline_depth: int = 1,
        **kw,
    ) -> Dict[str, Partition]:
        """Balance every tenant's chunk stream concurrently: ``tenants``
        maps tenant name -> its chunk count ``n``; returns tenant ->
        ``Partition``.  One ``FleetScheduler`` round serves all tenants
        (see the class docstring); extra ``kw`` become per-job ``JobSpec``
        fields (``min_units``, ``max_iter``, ...).

        Repeated calls REUSE the warm session on ``self.fleet`` whenever it
        is compatible (same backend, same replica count): absent tenants are
        retired, present ones resized to the requested ``n`` (keeping their
        learned estimates — the re-run warm-starts from a repartition), new
        ones admitted.  The stacked carry and per-lane caches survive, so a
        steady-state re-balance restacks nothing and captures no new CUDA
        graph.  Only a backend or replica-count change pays a fresh session
        — and when a registry is attached, the old session's learned
        profiles are checkpointed into it first so the fresh session
        warm-starts instead of re-probing cold.

        ``pipeline=``/``pipeline_depth=`` pick the round lifecycle (see
        "Round lifecycle: sync vs pipelined" in ``fleet/scheduler.py``);
        toggling the mode on a warm session drains the in-flight pipeline
        first, so the switch is safe mid-tenancy."""
        from ..fleet import FleetScheduler, JobSpec

        fleet = self.fleet
        warm = (
            fleet is not None
            and getattr(fleet, "num_procs", None) == self.num_replicas
            and getattr(fleet, "backend", None) == backend
        )
        if not warm:
            if fleet is not None:
                # carry what the incompatible session learned across
                reg = registry if registry is not None else fleet.registry
                if reg is not None and fleet.device_classes is not None:
                    fleet.save_profiles(reg)
            self.fleet = fleet = FleetScheduler(
                self.num_replicas,
                backend=backend,
                device=self.device,
                registry=registry,
                device_classes=device_classes,
                alpha=0.0,
                beta=0.0,
                reserve_knots=reserve_knots,
                quantize=quantize if quantize is not None else 0.0,
                staleness_tol=staleness_tol,
                pipeline=pipeline,
                pipeline_depth=pipeline_depth,
            )
        else:
            if bool(pipeline) != fleet.pipeline or int(
                pipeline_depth
            ) != fleet.pipeline_depth:
                # Mode toggles reuse the warm session: drain first so no
                # stale carry or pre-dispatched partition crosses the switch.
                if pipeline and fleet.backend == "scalar":
                    raise ValueError(
                        'pipeline=True requires a banked backend ("numpy" or "torch")'
                    )
                if pipeline_depth not in (0, 1):
                    raise ValueError("pipeline_depth must be 0 or 1")
                fleet.drain()
                fleet.pipeline = bool(pipeline)
                fleet.pipeline_depth = int(pipeline_depth)
            if quantize is not None:
                fleet.quantize = float(quantize)
            if staleness_tol is not None:
                fleet.staleness_tol = float(staleness_tol)
            if registry is not None:
                fleet.registry = registry
            if device_classes is not None:
                if len(device_classes) != self.num_replicas:
                    raise ValueError("device_classes length != num_replicas")
                fleet.device_classes = [str(c) for c in device_classes]
        current = set(fleet.jobs)
        for name in current - set(tenants):
            fleet.retire(name)
        resize_kw = {
            k: kw[k]
            for k in ("caps", "min_units", "max_iter", "probe_budget")
            if k in kw
        }
        for name, n in tenants.items():
            if name in current:
                # unconditional: reset the loop state so run() re-converges
                # this tenant from its learned estimates (bit-identical to a
                # fresh session admitted with the same models)
                fleet.resize(name, n=int(n), eps=self.eps, **resize_kw)
            else:
                fleet.admit(
                    JobSpec(
                        name=name,
                        n=int(n),
                        eps=self.eps,
                        workload=(workloads or {}).get(name),
                        **kw,
                    )
                )
        tel = _obs_active()
        rec = tel is not None and tel.enabled
        if not rec:
            return fleet.run(self)
        # The live rebalance-vs-serve wall split: everything fleet.run spends
        # outside the dispatcher's own replica_run calls is scheduling host
        # work (partition/fold/settle), exported per balance.
        t0 = time.perf_counter()
        eh0 = self.exec_host_s
        out = fleet.run(self)
        total = time.perf_counter() - t0
        serve_s = self.exec_host_s - eh0
        sched_s = max(total - serve_s, 0.0)
        tel.gauge("serve.split.serve_host_s", serve_s)
        tel.gauge("serve.split.sched_host_s", sched_s)
        return out
