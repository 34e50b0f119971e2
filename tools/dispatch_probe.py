"""Probe the serving dispatch over real replicas on one NVIDIA H100.

    python3 tools/dispatch_probe.py [--only sweep,runs,causes] [--runs 20] [--stride 1]
                                    [--cause-runs 10] [--out chiprun_out/dispatch_probe.jsonl]

Run on a machine with the card, from the root of a checkout.  It builds the
kernels, makes recurrentgemma-2b at full width as ``chip_smoke.py``'s
``dispatch`` phase does (seed 0, one set of weights for every replica) and
makes up to three measurements, each written as JSON lines to ``--out`` and
summed up on standard output:

1. ``sweep`` — the time of one replica (r = 1) serving x chunks of 128
   prompt tokens as one batch to their first token, x = 1 .. 192 in steps
   of ``--stride``, each the median of 3 CUDA-event timings, as the
   phase's replicas time a call.  A least-squares line t(x) = F + c x
   gives the per-batch floor F and the per-chunk cost c; the summary names
   the floor's share of a one-chunk call (its time less c), the weights'
   read time at the card's memory rate, and every x where t steps up by
   more than 3 % of t past the line's own increment (the GEMMs' tile
   waves).
   Replica i of the phase takes r_i times these times.
2. ``runs`` — ``chip_smoke.py``'s ``dispatch`` parts (b) and (c)
   (``dispatch_dfpa``, ``dispatch_cycle``), ``--runs`` times on the one
   model: for (b) convergence, rounds, the final distribution and its
   re-measured imbalance; for (c) every tenant's convergence and rounds,
   the steady epochs' straggler actions (false strikes) and their wall
   costs; each run's checks, and how many runs passed all of them.
3. ``causes`` — part (b) in the configurations of ``CAUSES``, which change
   one at a time what tells the three suspected causes of a dispatch that
   does not converge apart: the number of chunks n (granularity), the
   timings a call takes (a single timing), and how far a request is served
   (prefill only, or 15 decode steps more: work whose time barely moves
   with the batch).  Each runs ``--cause-runs`` times (decode
   configurations ``DECODE_RUNS`` at most); a run passes when it converged
   and its final distribution re-measured within 2 eps.  Not the default:
   name it in ``--only``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_FRACTION = 0.03  # a step: t(x+s) - t(x) exceeds the line's s*c by this share of t
CAUSES = {  # name: (n chunks, CUDA-event timings a call, tokens a request is served to)
    "n64_single_prefill": (64, 1, 1),  # n = 64, one timing a call: the suspect configuration
    "n64_median3_prefill": (64, 3, 1),
    "n192_single_prefill": (192, 1, 1),
    "n64_single_decode": (64, 1, 16),
    "n192_median3_decode": (192, 3, 16),  # (b)'s n and timings, decode chunks
}  # (b) itself, n = 192 with medians of 3 over prefill chunks, is what ``runs`` repeats
DECODE_RUNS = {"n64_single_decode": 3, "n192_median3_decode": 1}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_sweep(smoke, cfg, model, write, stride: int) -> None:
    rep = smoke.PrefillReplicas(cfg, model, [1], smoke.DISPATCH_PROMPT, smoke.DISPATCH_N)
    rep.time_ms(1, 1, 1)  # the first call's set-up is not a sample
    xs = list(range(1, smoke.DISPATCH_N + 1, stride))
    ms = []
    for x in xs:
        runs = rep.time_ms(x, 1, smoke.DISPATCH_SAMPLES)
        ms.append(float(np.median(runs)))
        write({"probe": "sweep", "x": x, "ms": runs, "median_ms": ms[-1]})
    c, floor = np.polyfit(np.asarray(xs, dtype=float), np.asarray(ms), 1)
    steps = []
    for (x0, t0), (x1, t1) in zip(zip(xs, ms), zip(xs[1:], ms[1:])):
        excess = (t1 - t0) - c * (x1 - x0)
        if excess > STEP_FRACTION * t1:
            steps.append({"x": x1, "ms_before": t0, "ms": t1, "excess_ms": excess})
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    summary = {
        "probe": "sweep", "points": len(xs), "stride": stride, "floor_ms": float(floor), "per_chunk_ms": float(c),
        "one_chunk_ms": ms[0], "floor_share_of_one_chunk": float((ms[0] - c) / ms[0]),
        "weight_read_ms_at_peak": weight_bytes / smoke.PEAK_BYTES * 1e3, "weight_bytes": weight_bytes,
        "ms_at": {str(x): t for x, t in zip(xs, ms) if x in (1, 2, 4, 8, 16, 23, 31, 46, 92, 192)},
        "max_rel_residual": float(np.max(np.abs(np.asarray(ms) - (floor + c * np.asarray(xs))) / np.asarray(ms))),
        "steps": steps,
    }
    write(summary)
    print(json.dumps(summary), flush=True)


def probe_runs(smoke, cfg, model, write, runs: int) -> None:
    passed = 0
    for i in range(runs):
        t0 = time.perf_counter()
        b = smoke.dispatch_dfpa(cfg, model)
        tb = time.perf_counter() - t0
        c = smoke.dispatch_cycle(cfg, model)
        tc = time.perf_counter() - t0 - tb
        checks = {**{f"b.{k}": v for k, v in b["checks"].items()}, **{f"c.{k}": v for k, v in c["checks"].items()}}
        ok = all(checks.values())
        passed += ok
        write({"probe": "run", "run": i, "b": b, "c": c})
        print(json.dumps({
            "probe": "run", "run": i, "passed": ok, "b_seconds": tb, "c_seconds": tc,
            "b": {"converged": b["converged"], "iterations": b["iterations"], "allocations": b["allocations"],
                  "final_imbalance": b["final_imbalance"],
                  "remeasured_imbalance_median": b["remeasured_imbalance_median"], "prefills": b["prefills"]},
            "c": {"converged": c["converged"], "iterations": c["iterations"], "allocations": c["allocations"],
                  "rounds": c["rounds"], "actions": [e["actions"] for e in c["epochs"]],
                  "false_strikes": sum(a != "none" for e in c["epochs"] for a in e["actions"]),
                  "epoch_wall_cost_ms": [e["wall_cost_ms"] for e in c["epochs"]]},
            "failed": [k for k, v in checks.items() if not v],
        }), flush=True)
    print(json.dumps({"probe": "runs", "runs": runs, "passed": passed}), flush=True)


def probe_causes(smoke, cfg, model, write, runs: int) -> None:
    eps = smoke.DISPATCH_EPS
    for name, (n, samples, new) in CAUSES.items():
        passed = converged = 0
        k = min(runs, DECODE_RUNS.get(name, runs))
        for i in range(k):
            t0 = time.perf_counter()
            b = smoke.dispatch_dfpa(cfg, model, n=n, samples=samples, new=new)
            ok = bool(b["converged"]) and b["remeasured_imbalance_median"] <= 2 * eps
            passed += ok
            converged += bool(b["converged"])
            write({"probe": "cause", "config": name, "run": i, "b": b})
            print(json.dumps({
                "probe": "cause", "config": name, "run": i, "passed": ok, "seconds": time.perf_counter() - t0,
                "converged": b["converged"], "iterations": b["iterations"], "allocations": b["allocations"],
                "final_imbalance": b["final_imbalance"],
                "remeasured_imbalance_median": b["remeasured_imbalance_median"],
                "rounds": [(r["d"], [round(v, 2) for v in r["times_ms"]]) for r in b["rounds"]],
            }), flush=True)
        print(json.dumps({"probe": "causes", "config": name, "n": n, "samples": samples, "new_tokens": new,
                          "runs": k, "converged": converged, "passed": passed}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="sweep,runs")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--cause-runs", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "dispatch_probe.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_probe: no CUDA device")
    smoke = _smoke()
    print(smoke.nvidia_smi(), flush=True)
    smoke._build.build(["flash_attention", "rglru_scan"])
    cfg, model = smoke.dispatch_model()
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        def write(obj):
            f.write(json.dumps(obj) + "\n")
            f.flush()

        t0 = time.perf_counter()
        for name in args.only.split(","):
            if name == "sweep":
                probe_sweep(smoke, cfg, model, write, args.stride)
            elif name == "runs":
                probe_runs(smoke, cfg, model, write, args.runs)
            elif name == "causes":
                probe_causes(smoke, cfg, model, write, args.cause_runs)
            else:
                raise SystemExit(f"dispatch_probe: unknown probe {name!r}")
        print(json.dumps({"probe_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
