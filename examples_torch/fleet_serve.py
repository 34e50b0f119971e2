"""Multi-tenant fleet scheduling: q concurrent jobs, one device program per
round, profiles that outlive the session.

Three tenants with different chunk counts and workload tags share one
heterogeneous replica fleet.  The ``FleetScheduler`` drives all of their
DFPA measurement rounds in lock-step from ONE stacked ``[q, p, k]`` device
bank — one batched repartition + one fold-in program per round, however
many tenants are admitted.  A fourth tenant is admitted mid-flight, one
retires, and the learned profiles are saved to a ``ProfileRegistry`` so a
second session warm-starts from them — the paper's "partial estimates
sufficient for a given accuracy", reused across sessions.

The PyTorch twin of ``examples/fleet_serve.py``: the stacked bank lives on
the card (``backend="torch"``); the replicas are simulated on the host, and
the registry is saved to and loaded from a temporary directory.

    PYTHONPATH=src python examples_torch/fleet_serve.py [--device cpu]
"""

import argparse
import os
import tempfile

from repro_torch.fleet import FleetScheduler, JobSpec, ProfileRegistry
from repro_torch.runtime.serve_loop import ReplicaDispatcher

# --- a heterogeneous replica fleet: per-replica nonlinear chunk->time -------
P = 6
CLASSES = ["a100", "a100", "h100", "h100", "l4", "l4"]
base = {"a100": 4e-4, "h100": 2.2e-4, "l4": 9e-4}
knee = {"a100": 36, "h100": 64, "l4": 18}


def replica_run(i, x):
    c = CLASSES[i]
    t = x * base[c]
    if x > knee[c]:
        t += (x - knee[c]) * base[c] * 4.0  # HBM-spill knee
    return t


def main(device="cuda") -> dict:
    # --- 1. three tenants balanced concurrently through the dispatcher ------
    disp = ReplicaDispatcher(replica_run, P, eps=0.12, device=device)
    results = disp.balance_fleet(
        {"chat": 96, "batch-eval": 240, "embed": 64},
        backend="torch",
        workloads={"chat": "decode", "batch-eval": "decode", "embed": "embed"},
        device_classes=CLASSES,
        min_units=1,
    )
    fleet = disp.fleet
    for name, part in results.items():
        print(
            f"{name:>10}: d={part.allocations} iters={part.iterations} "
            f"imb={part.imbalance:.3f} converged={part.converged}"
        )
    print(
        f"fleet: {fleet.rounds} rounds, {fleet.device_dispatches} device programs "
        f"(q independent loops would have paid ~{2 * 3}x per round)"
    )

    # --- 2. admit mid-flight / retire: lanes restack lazily -----------------
    fleet.admit(JobSpec(name="rerank", n=120, eps=0.12, min_units=1, workload="decode"))
    fleet.retire("embed")  # folds its learned profile into... no registry yet
    res = fleet.run(disp)
    print(f"\n    rerank: d={res['rerank'].allocations} iters={res['rerank'].iterations}")

    # --- 3. persist profiles; a NEW session warm-starts from them -----------
    reg = ProfileRegistry()
    fleet.registry = reg
    fleet.save_profiles()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profiles.json")
        reg.save(path)
        print(f"\nsaved {len(reg)} (device-class, workload) profiles -> {path}")
        reg2 = ProfileRegistry.load(path)
    fleet2 = FleetScheduler(
        P, backend="torch", device=device, registry=reg2, device_classes=CLASSES
    )
    fleet2.admit(JobSpec(name="chat-v2", n=96, eps=0.12, min_units=1, workload="decode"))
    disp2 = ReplicaDispatcher(replica_run, P, eps=0.12, device=device)
    res2 = fleet2.run(disp2)
    cold_iters = results["chat"].iterations
    warm_iters = res2["chat-v2"].iterations
    print(
        f"warm-started chat-v2: d={res2['chat-v2'].allocations} "
        f"iters={warm_iters} (cold session took {cold_iters}) — "
        "the first distribution came from yesterday's estimates, not an even split."
    )
    return {
        "claims": {"warm_fewer_iters_than_cold": warm_iters < cold_iters},
        "allocations": {name: list(part.allocations) for name, part in results.items()},
        "rounds": fleet.rounds,
        "device_dispatches": fleet.device_dispatches,
        "rerank": list(res["rerank"].allocations),
        "profiles": len(reg),
        "cold_iters": cold_iters,
        "warm_iters": warm_iters,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
