"""Pipelined fleet rounds: a straggler lane keeps measuring while a
converged lane rebalances immediately.

``FleetScheduler(pipeline=True)`` restructures the round loop over
double-buffered fold-in carries (see "Round lifecycle: sync vs pipelined"
in ``fleet/scheduler.py``): round r's observations fold into the newest
carry while round r+1's stacked repartition is pre-dispatched against the
previous one — a SPECULATIVE read, consumed only when it advances every
job's trajectory (validated against the per-job seen sets), so a
deterministic replay stays bit-identical to the sync fleet while a live
serving fleet overlaps its device programs with host work.

Part 1 shows the mechanics on a mixed fleet: a ``straggler`` tenant still
deep in its DFPA measurement rounds shares the carry with a ``steady``
tenant that converged long ago and only rebalances.  The steady lane's
rebalance partitions against the previous fold generation — it never
waits on the straggler's in-flight fold — and the counters show which
speculative reads were consumed and which fell back to the fresh carry
(the fallback is what keeps the trajectory at the sync fixed point).

Part 2 shows where the overlap pays on the clock: a fully-converged
serving fleet whose epochs are ``rebalance()`` + ``observe(times)``.  The
sync epoch serializes fold -> partition; the pipelined epoch reads the
double-buffered carry and fetches the partition ``observe`` pre-dispatched
while the previous fold was still in flight.

The PyTorch twin of ``examples/fleet_pipeline_walkthrough.py``: the
stacked carries live on the card (``backend="torch"``).  Part 2 times each
epoch on the host clock with ``torch.cuda.synchronize()`` before the clock
is read, so every epoch's device work is inside its own time; its ms are
the device's, not the reference's.

    PYTHONPATH=src python examples_torch/fleet_pipeline_walkthrough.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import BatchedSimulatedExecutor2D, PiecewiseLinearFPM
from repro_torch.core.modelbank_torch import resolve_device
from repro_torch.fleet import FleetScheduler, JobSpec


def make_fleet_truth(q, p, seed):
    """Per-(job, replica) plateau/knee ground truth + 6-point warm banks."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1e-4, 5e-4, (q, p))
    knee = rng.uniform(30.0, 120.0, (q, p))

    def time_fn(X):  # X[q, p] -> T[q, p]
        return X * base * (1.0 + np.where(X > knee, 3.0 * (X - knee) / knee, 0.0))

    def learned(j):
        models = []
        for i in range(p):
            xs = np.geomspace(4.0, 8.0 * knee[j, i], 6)
            ts = xs * base[j, i] * (
                1.0
                + np.where(xs > knee[j, i], 3.0 * (xs - knee[j, i]) / knee[j, i], 0.0)
            )
            models.append(PiecewiseLinearFPM.from_points(list(zip(xs, xs / ts))))
        return models

    return time_fn, learned, base, knee


P = 8  # Part 1's replicas
Q, P2 = 8, 64  # Part 2's tenants and replicas


def main(device="cuda") -> dict:
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # --- Part 1: straggler lane overlapping a converged lane's rebalance ----
    time_fn, learned, base, knee = make_fleet_truth(2, P, seed=42)

    fleet = FleetScheduler(P, backend="torch", device=dev, pipeline=True, pipeline_depth=1)
    fleet.admit(JobSpec(name="steady", n=400, eps=0.1, min_units=1), models=learned(0))
    fleet.admit(JobSpec(name="straggler", n=640, eps=0.01, min_units=1, max_iter=10))
    ex = BatchedSimulatedExecutor2D(
        time_fn_batch_2d=time_fn, p=P, q=2, job_names=["steady", "straggler"]
    )

    print("Part 1 — mixed fleet, pipeline_depth=1:")
    for epoch in range(8):
        fleet.step(ex)  # the straggler's DFPA measurement round
        # the converged lane's serving cycle: its load drifts, its rebalance
        # reads the PREVIOUS fold generation — no wait on the in-flight fold
        ds = fleet.rebalance({"steady": 400 + epoch})
        x = np.asarray(ds["steady"], dtype=np.float64)
        t = x * base[0] * (1.0 + np.where(x > knee[0], 3.0 * (x - knee[0]) / knee[0], 0.0))
        fleet.observe({"steady": [float(v) for v in t]})
    strag = fleet.snapshot("straggler")
    print(
        f"  straggler: iterations={strag.iterations} imbalance={strag.imbalance:.4f}"
        f"  |  steady kept serving every epoch"
    )
    print(
        f"  speculative stale reads consumed: {fleet.stale_reads}, "
        f"misses (fell back to the fresh carry): {fleet.speculative_misses}, "
        f"pre-dispatched partitions: {fleet.predispatches}"
    )
    print(
        "  a consumed read overlapped the straggler's fold; a miss means the\n"
        "  stale estimates taught that lane nothing new, so the round paid the\n"
        "  same fresh partition sync would have — never more.\n"
    )

    # --- Part 2: the steady-state serving win (every tenant converged) ------
    time_fn, learned, base, knee = make_fleet_truth(Q, P2, seed=7)
    names = [f"tenant-{j}" for j in range(Q)]

    def serve_epochs(pipeline):
        fl = FleetScheduler(P2, backend="torch", device=dev, pipeline=pipeline, pipeline_depth=1)
        for j in range(Q):
            fl.admit(
                JobSpec(name=names[j], n=6400 + 7 * j, eps=1e-12, min_units=1),
                models=learned(j),
            )
        walls = []
        for epoch in range(12):
            sync()
            t0 = time.perf_counter()
            ds = fl.rebalance()  # one stacked partition for all tenants
            obs = {}
            for j, nm in enumerate(names):
                x = np.asarray(ds[nm], dtype=np.float64)
                t = x * base[j] * (
                    1.0 + np.where(x > knee[j], 3.0 * (x - knee[j]) / knee[j], 0.0)
                )
                obs[nm] = [float(v) for v in t]
            fl.observe(obs)  # one stacked fold (+ pre-dispatch when pipelined)
            sync()
            walls.append(time.perf_counter() - t0)
        return fl, walls[3:]  # skip the first epochs (allocation, graph capture)

    print(f"Part 2 — steady-state serving epochs (rebalance + observe), q={Q} p={P2}:")
    fl_sync, w_sync = serve_epochs(False)
    fl_pipe, w_pipe = serve_epochs(True)
    ms, mp = np.median(w_sync) * 1e3, np.median(w_pipe) * 1e3
    print(f"      sync: {ms:7.2f} ms/epoch  (fold -> partition serialized)")
    print(
        f" pipelined: {mp:7.2f} ms/epoch  ({ms / mp:.2f}x — "
        f"{fl_pipe.stale_reads} stale reads, "
        f"{fl_pipe.predispatches} pre-dispatched partitions)"
    )
    return {
        "claims": {"stale_reads_consumed": fleet.stale_reads > 0},
        "straggler_iterations": strag.iterations,
        "stale_reads": fleet.stale_reads,
        "speculative_misses": fleet.speculative_misses,
        "predispatches": fleet.predispatches,
        "sync_ms": float(ms),
        "pipelined_ms": float(mp),
        "pipe_stale_reads": fl_pipe.stale_reads,
        "pipe_predispatches": fl_pipe.predispatches,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
