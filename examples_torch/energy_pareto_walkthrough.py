"""Bi-objective time/energy walkthrough: one bank layout, two objectives.

A 2-class fleet where the energy ranking deliberately disagrees with the
speed ranking: the "old" parts are a touch faster but burn ~5x the power
of the "new" ones.  The energy subsystem banks per-processor energy laws
as energy-RATE models (``er(x) = x / E(x)``, see ``core/energy.py``) so
the whole speed-bank machinery — padded layout, fold-in, partition —
serves energy unchanged.  The walkthrough builds the makespan/energy
Pareto front, picks its knee, partitions under an explicit energy budget,
and runs one power-capped multi-tenant serving round.

The PyTorch twin of ``examples/energy_pareto_walkthrough.py``.  The
reference builds its store on the host's numpy bank; here the store and
both fleets keep their banks on the card (``backend="torch"``).  In
float64 the device bank's partitions, front and budgeted solve equal the
numpy bank's bit for bit, so the printed numbers are the reference's.

    PYTHONPATH=src python examples_torch/energy_pareto_walkthrough.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import PiecewiseLinearFPM, SpeedStore
from repro_torch.core.energy import energy_model
from repro_torch.fleet import FleetScheduler, JobSpec

# --- a 2-class fleet: new efficient parts vs old power hogs -----------------
P = 6
CLASSES = ["new", "new", "new", "old", "old", "old"]
SPEED = {"new": 420.0, "old": 500.0}  # chunks/s: the hogs are FASTER
ENERGY = {"new": (3.0, 0.25), "old": (8.0, 1.4)}  # E(x) = a + b*x joules
N = 2000


def main(device="cuda") -> dict:
    xs = np.geomspace(1.0, 4096.0, 7)
    speed_models = [
        PiecewiseLinearFPM.from_points([(1.0, SPEED[c]), (4096.0, SPEED[c])])
        for c in CLASSES
    ]
    energy_models = [
        energy_model([(x, ENERGY[c][0] + ENERGY[c][1] * x) for x in xs])
        for c in CLASSES
    ]

    # --- 1. one store, two banks: time and energy share the layout ----------
    store = SpeedStore.from_models(speed_models, backend="torch", device=device)
    store.attach_energy(energy_models)
    d_time, t_opt = store.partition(N)
    d_energy, _ = store.partition(N, objective="energy")
    print(f"time-optimal   d={d_time}  makespan {t_opt:.3f}s  "
          f"energy {store.fleet_energy(d_time):7.1f} J")
    print(f"energy-optimal d={d_energy}  makespan "
          f"{max(x / SPEED[c] for x, c in zip(d_energy, CLASSES)):.3f}s  "
          f"energy {store.fleet_energy(d_energy):7.1f} J")

    # --- 2. the Pareto front between them + its knee ------------------------
    front = store.pareto_front(N, num_points=9)
    k = front.knee()
    print(f"\nPareto front ({len(front)} points; * = knee):")
    for i in range(len(front)):
        mark = " *" if i == k else "  "
        print(f"{mark} t={front.times[i]:.3f}s  E={front.energies[i]:7.1f} J  "
              f"d={[int(v) for v in front.allocations[i]]}")

    # --- 3. an explicit energy budget picks the fastest point that fits -----
    cap = 0.65 * store.fleet_energy(d_time)
    d_cap, t_cap = store.partition(N, energy_cap=cap)
    e_cap = store.fleet_energy(d_cap)
    print(f"\nbudget {cap:.0f} J: d={d_cap}  makespan {t_cap:.3f}s  "
          f"energy {e_cap:.1f} J "
          f"(work moved off the hogs, bounded slowdown)")

    # --- 4. one power-capped multi-tenant serving round ---------------------
    loads = {"chat": 1400, "embed": 900}
    free = FleetScheduler(P, backend="torch", device=device)
    capped = FleetScheduler(P, backend="torch", device=device)
    for fleet in (free, capped):
        for name, n in loads.items():
            fleet.admit(JobSpec(name=name, n=n, min_units=0),
                        models=speed_models, energy_models=energy_models)

    def round_energy(ds):
        return sum(
            energy_models[i].time(float(di))
            for d in ds.values() for i, di in enumerate(d) if di > 0
        )

    ds_free = free.rebalance()
    budget = 0.75 * round_energy(ds_free)
    capped.power_cap = budget
    ds_cap = capped.rebalance()
    e_free, e_capped = round_energy(ds_free), round_energy(ds_cap)
    print(f"\nserving round, 2 tenants, fleet budget {budget:.0f} J:")
    for name in loads:
        print(f"  {name:6s} uncapped d={ds_free[name]} -> capped d={ds_cap[name]}")
    print(f"  fleet energy {e_free:.0f} J uncapped, "
          f"{e_capped:.0f} J capped (fits the budget)")
    return {
        "claims": {"capped_solve_fits_budget": e_cap <= cap, "capped_round_fits_budget": e_capped <= budget},
        "d_time": list(d_time),
        "d_energy": list(d_energy),
        "knee": k,
        "front_times": [float(t) for t in front.times],
        "cap": cap,
        "d_cap": list(d_cap),
        "energy_cap_round": e_cap,
        "fleet_budget": budget,
        "fleet_energy_free": e_free,
        "fleet_energy_capped": e_capped,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
