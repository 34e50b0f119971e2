"""The paper's self-adaptable matrix multiplication, on processors emulated
on one card.

``C = A B`` (``N x K`` by ``K x N``, bf16) is split into units of
``unit_rows`` rows.  Processor ``i`` owns the rows its allocation gives it,
in processor order, so an iteration computes the whole product: it zeroes
its rows of C and runs the program's ``matmul_update`` on its panel ``r_i``
times over (its slowness; ``r_i`` comes from the traffic's ``platform``).
The program's ``CallableExecutor`` runs the processors.

Set-up balances the platform once: the program's ``Scheduler.autotune``,
from a cold ``SpeedStore``, over the processors' fixed timing model
(``r_i * UNIT_S`` a unit), so that the distribution depends on the
platform alone and not on one run's timings.
The window then runs application iterations at that distribution with no
scheduler call.  Each iteration records its distribution, each processor's
CUDA-event time and a sample of C's rows (drawn from the seed) with the
``r_i`` of the processor that wrote each.  The check compares those rows
with the plain product and replays the balance and every iteration's
distribution with the frozen partitioner.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import CallableExecutor, Scheduler, SimulatedExecutor, SpeedStore
from repro_torch.kernels import ops

from bench.lib import counts, traffic
from bench.lib.clock import Span, sync
from bench.reference import matmul_rows as reference
from bench.reference.partitioner import replay

# a unit's time at r = 1 on the H100 (32 rows at ~1.25 us a row); it scales
# every processor's time alike, so the balanced distribution does not
# depend on it
UNIT_S = 4e-5


class Processors:
    """The emulated processors over one ``C``: ``fn(i)`` is processor
    ``i``'s work for ``units`` units, at the offset the current
    distribution gives it, timed by CUDA events."""

    def __init__(self, cfg: Dict, repeats: List[int], a, b, c, device):
        self.a, self.b, self.c, self.device = a, b, c, device
        self.unit_rows, self.blocks = int(cfg["unit_rows"]), dict(cfg["blocks"])
        self.repeats = list(repeats)
        self.offsets: List[int] = [0] * len(self.repeats)
        self.spans: List[tuple] = []

    def place(self, d) -> None:
        self.offsets = [self.unit_rows * int(v) for v in np.cumsum([0] + list(d[:-1]))]

    def fn(self, i: int):
        def run(units: int) -> None:
            lo, hi = self.offsets[i], self.offsets[i] + units * self.unit_rows
            c, a = self.c[lo:hi], self.a[lo:hi]
            with torch.profiler.record_function("bench.proc"), Span(self.device) as span:
                c.zero_()
                for _ in range(self.repeats[i]):
                    ops.matmul_update(c, a, self.b, **self.blocks)
            self.spans.append((i, hi - lo, self.repeats[i], span))
        return run


class RowsExecutor(CallableExecutor):
    """The program's ``CallableExecutor`` that places each processor's rows
    before a round and hands the round to ``after`` once it is timed."""

    def __init__(self, procs: Processors, device, after):
        super().__init__([procs.fn(i) for i in range(len(procs.repeats))], device=device)
        self.procs, self.after = procs, after

    def run(self, d):
        self.procs.place(d)
        self.procs.spans.clear()
        with torch.profiler.record_function("bench.round"):
            times = super().run(d)
        self.after(list(d), list(times))
        return times


class System:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        t0 = time.perf_counter()
        n, k = int(cfg["N"]), int(cfg["K"])
        g = traffic.device_generator(seed, 0, device)
        self.a = torch.randn((n, k), generator=g, device=device, dtype=torch.bfloat16)
        self.b = torch.randn((k, n), generator=g, device=device, dtype=torch.bfloat16)
        self.c = torch.zeros((n, n), device=device, dtype=torch.bfloat16)
        self.units, self.eps, self.min_units = int(cfg["units"]), float(cfg["eps"]), int(cfg["min_units"])
        self.procs = Processors(cfg, [int(r) for r in mix["platform"]], self.a, self.b, self.c, device)
        self.executor = RowsExecutor(self.procs, device, self._after_round)
        pick = traffic.rng(seed, 3)
        self.pool = np.sort(pick.choice(n, size=min(int(mix["check_pool"]), n), replace=False))
        self.pick, self.rounds, self.samples = pick, [], []
        self.stages = {"operands_s": time.perf_counter() - t0}
        self.warm_up()

    # -- set-up -----------------------------------------------------------------

    def warm_up(self) -> None:
        """One processor's first update (it loads the kernel; timed apart),
        the balance on the timing model, then one iteration at the balanced
        distribution (every processor's first run, which the executor does
        untimed, and every panel shape the window runs)."""
        t0 = time.perf_counter()
        self.procs.fn(0)(1)
        sync(self.device)
        self.stages["first_update_s"] = time.perf_counter() - t0
        model = SimulatedExecutor(time_fns=[(lambda r: lambda x: r * UNIT_S * x)(r) for r in self.procs.repeats],
                                  alpha=0.0, beta=0.0)
        store = SpeedStore.empty(len(self.procs.repeats), backend="torch", device=self.device)
        sched = Scheduler(store, backend="torch", device=self.device, eps=self.eps, min_units=self.min_units)
        sched.autotune(model, self.units, self.eps, min_units=self.min_units)
        self.d = [int(v) for v in sched.d]
        self.balance = [(log.d, log.times) for log in model.logs]
        self.executor.run(self.d)
        sync(self.device)
        print(f"bench: balanced r={self.procs.repeats} on the timing model in {len(self.balance)} rounds: "
              f"d={self.d}", file=sys.stderr)
        self.rounds.clear()
        self.samples.clear()
        self.stages["warm_up_s"] = time.perf_counter() - t0

    # -- the window ---------------------------------------------------------------

    def _after_round(self, d, times) -> None:
        spans = [(i, rows, r, span.seconds()) for i, rows, r, span in self.procs.spans]
        k = self.pick.choice(len(self.pool), size=int(self.mix["check_rows"]), replace=False)
        rows = self.pool[np.sort(k)]
        with torch.profiler.record_function("bench.sample"):
            got = self.c.index_select(0, torch.as_tensor(rows, device=self.device))
        owner = np.searchsorted(np.cumsum(d) * self.procs.unit_rows, rows, side="right")
        self.samples.append((rows, [self.procs.repeats[i] for i in owner], got))
        self.rounds.append({"d": d, "times": times, "proc_s": [s for *_, s in spans],
                            "makespan_s": max(s for *_, s in spans),
                            "launches": [(rows_i, r) for _, rows_i, r, _ in spans]})

    def window(self, seconds: float) -> Dict:
        """Application iterations at the balanced distribution until the
        window closes (the one in flight is finished)."""
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            self.executor.run(self.d)
        sync(self.device)
        return self._record()

    def _record(self) -> Dict:
        n, k = int(self.cfg["N"]), int(self.cfg["K"])
        launches = [(rows, r) for rnd in self.rounds for rows, r in rnd["launches"]]
        return {
            "iterations": len(self.rounds),
            "attempted": len(self.rounds),
            "failed": 0,
            "platform_s": sum(r["makespan_s"] for r in self.rounds),
            "work": {"matmul": {
                "flops": sum(counts.matmul_update_flops(rows, n, k) * r for rows, r in launches),
                "card_s": sum(sum(r["proc_s"]) for r in self.rounds),
            }},
            "bounds": {"matmul_update": {
                "launches": sum(r for _, r in launches),
                "bound_s": sum(counts.matmul_update_bound_s(rows, n, k) * r for rows, r in launches),
            }},
        }

    # -- after the window ---------------------------------------------------------

    def release(self) -> None:
        """Frees the program's state: C, the executor and its rounds' logs."""
        self.c = self.procs.c = self.executor = None

    def check(self, record: Dict, samples: Optional[List] = None) -> List[Dict]:
        """The sampled rows of C (or ``samples``, another computation's rows
        in their place) against the plain product, and the balance and
        every iteration's distribution against the frozen partitioner's
        replay."""
        want = reference.Product(self.a, self.b, self.pool)
        worst = max(want.error(rows, reps, got) for rows, reps, got in (samples or self.samples))
        rs = self.balance + [(r["d"], r["times"]) for r in self.rounds]
        faults = replay(rs, n=self.units, eps=self.eps, min_units=self.min_units,
                        balance_rounds=len(self.balance), observe=False)
        limits = self.cfg["limits"]
        return [
            {"name": "c_rows_rel_rms", "value": worst, "limit": limits["c_rows_rel_rms"],
             "ok": math.isfinite(worst) and worst <= limits["c_rows_rel_rms"]},
            {"name": "allocations_unlike_replay", "value": len(faults), "limit": 0, "ok": not faults,
             "detail": faults[:5]},
        ]

    def control(self, record: Dict) -> List[Dict]:
        """The check with the control in the program's place: the reference
        computed from fp8 operands gives the sampled rows."""
        low = reference.Product(self.a, self.b, self.pool, precision="fp8")
        return self.check(record, [(rows, reps, low.rows(rows, reps)) for rows, reps, _ in self.samples])
