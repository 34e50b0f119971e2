"""Two-level hierarchical partitioning: host classes as groups, one-program
inner solves, and a mid-flight regroup.

A heterogeneous platform is rarely flat: hosts come in CLASSES (a rack of
a100 nodes, a rack of h100 nodes, a drawer of l4 cards), and the flat
``[p, k]`` bank stops fitting in cache long before p=10^6.  The two-level
path mirrors the platform:

1. each group is AGGREGATED behind one composite performance model
   (the exact sum-of-allocs-at-equal-time composition, ``aggregate_groups``);
2. the outer ``t*`` bisection runs on the tiny ``[g, k_g]`` group bank;
3. each group's integer share is partitioned over its members on the
   group's own ``[p_g, k]`` sub-bank — on the torch backend all groups in
   ONE stacked program on the card.

The PyTorch twin of ``examples/hierarchy_walkthrough.py``.  It builds a
3-class platform, partitions it flat and hierarchically on the card, shows
the single-group degeneration (bit-identical to flat) and regroups
MID-FLIGHT with ``Scheduler.set_groups`` after a host class is split in
two.  What differs on one card: the reference's section 4 spreads the group
blocks over several devices (``sharding="shard_map"``), which has no
one-card counterpart (ROADMAP item 10f).  Section 4 here holds the card's
one-program inner solve against the host's numpy solve instead, and counts
the bank elements the card holds.  The device bank is float64 by default,
so nothing needs switching on.

    PYTHONPATH=src python examples_torch/hierarchy_walkthrough.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import ModelBank, Scheduler, SpeedStore, TorchModelBank
from repro_torch.core.hierarchy import Hierarchy

CLASS_SPECS = {  # name -> (hosts, base speed, saturation knee)
    "a100": (8, 40.0, 600.0),
    "h100": (6, 90.0, 900.0),
    "l4": (10, 12.0, 200.0),
}


def main(device="cuda") -> dict:
    # --- 1. a 3-class platform: per-class speed curves, per-host jitter -----
    rng = np.random.default_rng(0)
    names, groups, pts = [], [], []
    for gid, (cls_, (hosts, base, knee)) in enumerate(CLASS_SPECS.items()):
        for h in range(hosts):
            jitter = rng.uniform(0.9, 1.1)
            xs = np.array([knee / 8, knee / 2, knee, 4 * knee])
            # speed rises toward the knee, then saturates: a classic FPM shape
            ss = base * jitter * np.array([0.7, 0.95, 1.0, 0.8])
            names.append(f"{cls_}-{h}")
            groups.append(gid)
            pts.append((list(xs), list(ss)))
    bank = ModelBank.from_point_lists(pts)
    p, n = bank.p, 12_000
    print(f"platform: p={p} hosts in {len(CLASS_SPECS)} classes, n={n} units")

    def store():  # a fresh device copy of the bank for each session
        return SpeedStore.from_torch_bank(TorchModelBank.from_bank(bank, device=device))

    # --- 2. flat vs hierarchical --------------------------------------------
    flat = Scheduler(store(), device=device).partition(n)
    hier = Scheduler(store(), groups=groups, device=device).partition(n)

    def makespan(d):
        d = np.asarray(d, dtype=np.float64)
        return float(np.max(np.where(d > 0, bank.time(np.maximum(d, 1.0)), 0.0)))

    per_class = {
        cls_: sum(hier.allocations[i] for i in range(p) if names[i].startswith(cls_))
        for cls_ in CLASS_SPECS
    }
    print(f"flat makespan {makespan(flat.allocations):.4f}  "
          f"hier makespan {makespan(hier.allocations):.4f}")
    print(f"hier class shares: {per_class} (sum {sum(hier.allocations)})")

    # --- 3. exactness tier 1: one group degenerates to the flat solve -------
    one = Scheduler(store(), groups=[0] * p, device=device).partition(n)
    single_is_flat = one.allocations == flat.allocations
    print(f"single group == flat, bit-identical: {single_is_flat}")

    # --- 4. the one-program inner solve on the card, against the host -------
    h_dev = Hierarchy.from_bank(bank, groups, backend="torch", device=device)
    h_np = Hierarchy.from_bank(bank, groups, backend="numpy")
    torch_is_numpy = h_dev.partition_units(n) == h_np.partition_units(n)
    print(f"shard_map: no one-card counterpart (ROADMAP item 10f); "
          f"one-program torch on {h_dev.device.type} == numpy: {torch_is_numpy}")
    print(f"per-device bank elements: {h_dev.max_shard_elems()} "
          f"(all {h_dev.g} group blocks on one device)")

    # --- 5. mid-flight regroup: the l4 drawer is split across two PDUs ------
    sched = Scheduler(store(), groups=groups, device=device)
    sched.partition(n)
    regrouped = [
        (3 if g == 2 and i % 2 else g) for i, g in enumerate(groups)
    ]
    sched.set_groups(regrouped)  # no rebuild of the store, just new routing
    after = sched.partition(n)
    print(f"after regroup (4 groups): makespan {makespan(after.allocations):.4f}, "
          f"sum {sum(after.allocations)}")
    return {
        "claims": {"single_group_is_flat": single_is_flat, "torch_is_numpy": torch_is_numpy},
        "flat": list(flat.allocations),
        "hier": list(hier.allocations),
        "single_group_is_flat": single_is_flat,
        "torch_is_numpy": torch_is_numpy,
        "max_shard_elems": h_dev.max_shard_elems(),
        "after_regroup": list(after.allocations),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
