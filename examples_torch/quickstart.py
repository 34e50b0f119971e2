"""Quickstart: the paper's DFPA through the Scheduler facade, in 30 lines.

An application lands on an UNKNOWN heterogeneous cluster (here: the
calibrated HCL simulator).  One ``Scheduler`` session balances the workload
online, without any pre-built performance model, in a handful of rounds —
``autotune`` runs the paper's measurement loop and returns a typed
``Partition``; the warm session stays ready for ``observe``/``join``/
``leave``.

The PyTorch twin of ``examples/quickstart.py``: the session's bank lives on
the card (``backend="torch"``), where the ``t*`` bisection and the fold-in
run; the simulator stays on the host.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

from repro_torch.core import (
    Scheduler,
    SimulatedExecutor,
    make_hcl_time_fns,
    matmul_app_time_1d,
)

N = 5120  # matrix size: rows to distribute (1 unit = 1 row of A/C)
EPS = 0.025  # paper's tight accuracy


def main(device="cuda") -> dict:
    specs, time_fns = make_hcl_time_fns(N)
    row_fns = [(lambda tf: lambda rows: tf(rows * N))(tf) for tf in time_fns]

    executor = SimulatedExecutor(time_fns=row_fns)
    sched = Scheduler(device=device)  # DFPA policy, torch backend — resolved once, here
    result = sched.autotune(executor, N, EPS, min_units=1)
    app_time = matmul_app_time_1d(time_fns, result.allocations, N)

    print(f"processors        : {len(specs)} ({specs[0].name}..{specs[-1].name})")
    print(f"converged         : {result.converged} in {result.iterations} rounds")
    print(f"final imbalance   : {result.imbalance:.3f} (eps={EPS})")
    print(f"distribution      : min={min(result.allocations)} max={max(result.allocations)} rows")
    print(f"model points used : max {max(m.num_points for m in sched.models)} per processor")
    print(f"DFPA cost         : {executor.total_cost:.2f}s")
    print(f"matmul app time   : {app_time:.1f}s")
    print("=> partitioning cost is orders of magnitude below the app time,")
    print("   with no pre-built performance model — the paper's headline claim.")
    return {
        "claims": {"converged": result.converged, "imbalance<=eps": result.imbalance <= EPS},
        "converged": result.converged,
        "iterations": result.iterations,
        "imbalance": result.imbalance,
        "eps": EPS,
        "allocations": list(result.allocations),
        "dfpa_cost": executor.total_cost,
        "app_time": app_time,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
