"""Serving under traffic, in miniature: one drifting fleet, one straggler.

A small walkthrough of the serving-epoch loop a traffic-trace harness runs
at scale, built on the trace-driven fleet executor ``TraceExecutor2D`` —
the ground-truth time function takes the TRACE CLOCK, so speeds drift as
functions of *when* a round runs:

  1. converge two tenants through ``FleetScheduler.run`` (measured rounds);
  2. per serving epoch: ``rebalance`` -> one ``run_jobs`` round at the
     current trace instant -> ``straggler_actions`` (scan BEFORE fold) ->
     ``observe`` (fold the epoch's times into the stacked carry);
  3. a replica starts a runaway decay mid-trace: watch the strike automaton
     escalate REPROFILE -> QUARANTINE on exactly that replica, then resize
     the fleet through the survivors (detector strikes remapped).

The PyTorch twin of ``examples/serve_trace_walkthrough.py``: both fleets
keep their stacked banks on the card (``backend="torch"``); the trace
executor stays on the host.

    PYTHONPATH=src python examples_torch/serve_trace_walkthrough.py [--device cpu]
"""

import argparse
import math

import numpy as np

from repro_torch.core.executor import TraceExecutor2D
from repro_torch.fleet import FleetScheduler, JobSpec
from repro_torch.runtime.straggler import StragglerAction

P = 4
DT = 2.0  # trace seconds per epoch
BASE = np.array([800.0, 700.0, 400.0, 350.0])  # chunks/s at t=0
THROTTLE_AT = 30.0  # trace seconds; replica 2 then decays x0.6 per epoch


def speeds_at(t: float) -> np.ndarray:
    """Per-replica speeds at trace time t: slow sinusoidal drift, plus the
    runaway decay on replica 2 once the throttle kicks in."""
    drift = 1.0 + 0.15 * np.sin(2.0 * math.pi * t / 240.0 + np.arange(P))
    s = BASE * drift
    if t >= THROTTLE_AT:
        s[2] *= max(0.6 ** ((t - THROTTLE_AT) / DT + 1.0), 0.05)
    return s


def main(device="cuda") -> dict:
    ex = TraceExecutor2D(
        time_fn_trace_2d=lambda X, t: X / speeds_at(t)[None, :],
        p=P,
        noise=0.01,
        rng=np.random.default_rng(0),
    )

    # -- 1. converge two tenants (measured rounds, one stacked program each) -
    fleet = FleetScheduler(P, backend="torch", device=device, alpha=0.0, beta=0.0,
                           reserve_knots=32, quantize=0.05)
    fleet.admit(JobSpec(name="chat", n=1200, eps=0.08, min_units=1, max_iter=12))
    fleet.admit(JobSpec(name="embed", n=400, eps=0.08, min_units=1, max_iter=12))
    res = fleet.run(ex)
    for name, part in res.items():
        print(f"converged {name:6s} d={part.allocations} "
              f"(imbalance {part.imbalance:.3f})")

    # -- 2. serving epochs: rebalance -> serve -> scan -> fold ---------------
    quarantined = None
    for epoch in range(24):
        ex.now = epoch * DT
        ds = fleet.rebalance({"chat": None, "embed": None})
        names = list(ds)
        T = ex.run_jobs(names, [ds[nm] for nm in names])
        times = {nm: [float(v) for v in T[k]] for k, nm in enumerate(names)}
        acts = fleet.straggler_actions(times)  # predictions are pre-fold
        fleet.observe(times)
        wall = ex.logs[-1].wall_cost
        for i, act in enumerate(acts):
            if act is not StragglerAction.NONE:
                print(f"epoch {epoch:2d} (t={ex.now:5.1f}s) replica {i}: "
                      f"{act.value.upper():10s} wall {wall:.3f}s")
        if StragglerAction.QUARANTINE in acts:
            quarantined = acts.index(StragglerAction.QUARANTINE)
            break

    # -- 3. drop the quarantined replica: survivors keep their estimates -----
    assert quarantined == 2, "the throttled replica must be the one quarantined"
    survivors = [i for i in range(P) if i != quarantined]
    old = fleet
    fleet = FleetScheduler(len(survivors), backend="torch", device=device, alpha=0.0,
                           beta=0.0, reserve_knots=32, quantize=0.05,
                           detector=old.detector.remap(survivors))
    sub = TraceExecutor2D(
        time_fn_trace_2d=lambda X, t: X / speeds_at(t)[None, survivors],
        p=len(survivors), noise=0.01, rng=np.random.default_rng(1), now=ex.now,
    )
    for name, n in (("chat", 1200), ("embed", 400)):
        fleet.admit(JobSpec(name=name, n=n, eps=0.08, min_units=1, max_iter=6))
    res2 = fleet.run(sub)
    for name, part in res2.items():
        print(f"resized   {name:6s} d={part.allocations} over replicas "
              f"{survivors} (imbalance {part.imbalance:.3f})")
    print(f"total simulated serving: {ex.total_cost + sub.total_cost:.2f}s "
          f"across {len(ex.logs) + len(sub.logs)} fleet rounds")
    return {
        "claims": {"replica_2_quarantined": quarantined == 2},
        "converged": {name: list(part.allocations) for name, part in res.items()},
        "quarantined": quarantined,
        "quarantine_epoch": epoch,
        "resized": {name: list(part.allocations) for name, part in res2.items()},
        "rounds": len(ex.logs) + len(sub.logs),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
