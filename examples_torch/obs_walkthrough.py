"""Observing the scheduler: spans, counters, Chrome traces, flight recorder.

The paper's overhead claim — partial FPM estimation + repartitioning cost
orders of magnitude below the execution they optimize — is an observability
claim, so the stack carries a telemetry substrate.  This walkthrough:

  1. installs a ``Telemetry`` sink and runs a fleet serving session under
     it, then reads the recorded spans/counters/gauges directly;
  2. exports the session as a Chrome-trace JSON (chrome://tracing or
     https://ui.perfetto.dev) and summarizes it with ``repro_torch.obs.report``;
  3. forces a straggler QUARANTINE under a ``FlightRecorder`` and dumps the
     post-incident JSON naming the offender and its strike evidence.

Everything is off by default: with no sink installed every instrumentation
site short-circuits on a no-op.

The PyTorch twin of ``examples/obs_walkthrough.py``.  The reference runs
its fleet on the host's numpy bank; here the fleet's stacked bank lives on
the card (``backend="torch"``), so ``fleet.stats()`` and the report count
the device programs the numpy fleet does not have.  The trace and the
flight recorder's dump go to a temporary directory.

    PYTHONPATH=src python examples_torch/obs_walkthrough.py [--device cpu]
"""

import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch import obs
from repro_torch.core import PiecewiseLinearFPM
from repro_torch.fleet import FleetScheduler, JobSpec
from repro_torch.obs.report import MetricsSnapshot
from repro_torch.runtime.straggler import StragglerDetector


def main(device="cuda") -> dict:
    # --- 1. a fleet serving session under an installed sink ----------------
    p, q = 8, 3
    rng = np.random.default_rng(0)
    base = rng.uniform(1e-4, 4e-4, (q, p))

    def times_for(j, d):
        return [x * base[j, i] if x > 0 else 0.0 for i, x in enumerate(d)]

    tel = obs.Telemetry()  # unbounded; pass capacity= for a ring
    obs.install(tel)  # process-global: every layer now reports
    try:
        fleet = FleetScheduler(p, backend="torch", device=device)
        for j in range(q):
            # warm per-replica models (linear: speed 1/base), as a registry or
            # prior session would provide — rebalance needs non-empty FPMs
            warm = [
                PiecewiseLinearFPM.from_points([(1.0, 1.0 / base[j, i]),
                                                (1e6, 1.0 / base[j, i])])
                for i in range(p)
            ]
            fleet.admit(JobSpec(name=f"tenant{j}", n=800 + j, eps=0.05), models=warm)
        for _ in range(4):  # serving epochs: one rebalance + one fold each
            ds = fleet.rebalance()
            fleet.observe({f"tenant{j}": times_for(j, ds[f"tenant{j}"]) for j in range(q)})
    finally:
        obs.uninstall()  # back to the no-op

    print(f"recorded {len(tel.events)} events")
    spans = sorted({e.name for e in tel.spans()})
    print(f"span kinds: {spans}")
    print(f"counters: {dict(tel.counters)}")
    print(f"fleet.rounds gauge: {tel.gauges['fleet.rounds']}")
    stats = fleet.stats()
    print(f"public stats (same numbers, no telemetry needed): {stats}")

    with tempfile.TemporaryDirectory(prefix="obs_walkthrough_") as outdir:
        # --- 2. Chrome-trace export + the paper-style report ---------------
        trace_path = os.path.join(outdir, "fleet_trace.json")
        obs.export_chrome_trace(tel, trace_path)
        snap = MetricsSnapshot.from_file(trace_path)
        print(f"\n-> {trace_path} (open in chrome://tracing)")
        print(snap.table())

        # --- 3. flight recorder: forensics from a forced QUARANTINE --------
        flight = obs.FlightRecorder(capacity=256, snapshot_capacity=8)
        det = StragglerDetector(factor=1.5, patience=3, patience_hard=6)
        # healthy model: 10 units should take 0.01 s
        model = PiecewiseLinearFPM.from_points([(1.0, 1000.0), (100.0, 1000.0)])
        with obs.use(flight):
            action = None
            for step in range(8):
                flight.snapshot(f"step:{step}", {"predicted": model.time(10.0),
                                                 "observed": 0.04})
                # replica 2 persistently 4x slower than its model predicts
                action = det.update(2, model, d_units=10, observed_t=0.04)
                if action.value == "quarantine":
                    break
            rec_path = os.path.join(outdir, "quarantine.flightrec.json")
            flight.dump(rec_path, reason="quarantine",
                        context={"replica": 2, "action": action.value, "step": step})

        with open(rec_path) as f:
            dump = json.load(f)
    print(f"\n-> {rec_path}")
    print(f"flight recorder: reason={dump['reason']!r} context={dump['context']}")
    strikes = [e for e in dump["events"] if e["name"] == "straggler.strike"]
    print(f"ring held {len(dump['events'])} events incl. {len(strikes)} strike "
          f"events; last evidence: {strikes[-1]['attrs']}")
    print("\n(serve_trace.py --trace wires all of this into the serving "
          "benchmark: per-replica tracks, overhead gauges, auto-dump on "
          "QUARANTINE or gate failure.)")
    quarantined = dump["context"]["replica"] if dump["context"]["action"] == "quarantine" else None
    return {
        "claims": {"replica_2_quarantined": quarantined == 2},
        "events": len(tel.events),
        "spans": spans,
        "counters": dict(tel.counters),
        "stats": stats,
        "device_dispatches": stats["device_dispatches"],
        "quarantined": quarantined,
        "strikes": len(strikes),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
