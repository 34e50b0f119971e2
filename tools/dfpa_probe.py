"""Probe the DFPA loop's kernel and rounds on one NVIDIA H100.

    python3 tools/dfpa_probe.py [--src DIR] [--only rows,dfpa] [--runs 8]
                                [--out chiprun_out/dfpa_probe.jsonl]

Run on a machine with the card.  It builds ``matmul_update`` from the
``repro_torch`` package under ``--src`` (default: this checkout's ``src``;
point it at another checkout's to measure that one) and makes up to two
measurements, each written as JSON lines to ``--out`` and summed up on
standard output:

1. ``rows`` — one launch through ``ops.matmul_update`` against the panel's
   rows, 32 to 4096 in steps of 32 (every panel a processor of the DFPA loop
   can get), beside the ``"wgmma"`` kernel's block count and waves on the
   card's SMs, and the relative step in time from one unit to the next
   where it adds a wave, adds blocks within the last wave, or adds none;
2. ``dfpa`` — the DFPA loop as ``chip_smoke.py``'s ``dfpa`` phase runs it
   (eight processors sharing the card, r = [1,1,2,2,3,3,4,4] launches a
   round, 512 units of 32 rows of a 16384^3 bf16 update, eps 0.1),
   ``--runs`` times: rounds, convergence, wall seconds, round makespans,
   the scheduling overhead between rounds, and the spread of a processor's
   time over the rounds that gave it the same units.  After each run the
   final distribution is measured 30 times as the loop measures it, and 30
   times with the launches queued behind a device-side sleep, so that the
   card's clock sees no gap left by the host between them.

``rows`` counts blocks of the ``"wgmma"`` route's 64x128 tiles; ``dfpa``
runs on any checkout of the port.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

N = 16384
UNIT_ROWS = 32
UNITS = N // UNIT_ROWS
BLOCKS = dict(bm=32, bn=256, bk=512)
REPEATS = [1, 1, 2, 2, 3, 3, 4, 4]
EPS = 0.1
WGMMA_TILE = (64, 128)  # the "wgmma" route's output tile
SLEEP_CYCLES = 10_000_000  # ~5 ms at the H100's clock: longer than the host needs to queue a round


def _spread(xs) -> dict:
    xs = np.asarray(xs, dtype=float)
    return {"min": float(xs.min()), "median": float(np.median(xs)), "max": float(xs.max())}


def _cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _operands(M, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(
        torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)
        for shape in ((M, N), (M, N), (N, N))
    )


def probe_rows(write) -> None:
    from repro_torch.kernels import matmul_update

    bm, bn = WGMMA_TILE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    c, a, b = _operands(4096, 0)
    out = []
    for rows in range(UNIT_ROWS, 4096 + 1, UNIT_ROWS):
        blocks = -(-rows // bm) * -(-N // bn)
        ms = _cuda_ms(lambda: matmul_update(c[:rows], a[:rows], b, **BLOCKS), 10)
        out.append({"rows": rows, "blocks": blocks, "waves": blocks / sms, "ms": ms})
    write({"probe": "rows", "sms": sms, "points": out})
    # one more 32-row unit: the relative step in time where it adds a wave,
    # where it adds blocks within the last wave, and where it adds none
    steps = {"new_wave": [], "more_blocks": [], "same_blocks": []}
    for p, q in zip(out, out[1:]):
        kind = ("new_wave" if -(-q["blocks"] // sms) > -(-p["blocks"] // sms)
                else "more_blocks" if q["blocks"] > p["blocks"] else "same_blocks")
        steps[kind].append(q["ms"] / p["ms"] - 1)
    print(json.dumps({"probe": "rows", "sms": sms,
                      **{f"step_rel_{k}": _spread(v) for k, v in steps.items() if v}}), flush=True)
    del c, a, b


def _dfpa_once():
    """The loop of ``chip_smoke.py``'s ``dfpa`` phase, ungated."""
    from repro_torch.core import CallableExecutor, Scheduler, SpeedStore, imbalance
    from repro_torch.kernels import matmul_update

    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((N, N), generator=g, device="cuda", dtype=torch.bfloat16)
    b = torch.randn((N, N), generator=g, device="cuda", dtype=torch.bfloat16)
    c = torch.zeros((N, N), device="cuda", dtype=torch.bfloat16)

    def processor(r):
        def run(units):
            rows = units * UNIT_ROWS
            for _ in range(r):
                matmul_update(c[:rows], a[:rows], b, **BLOCKS)
        return run

    executor = CallableExecutor([processor(r) for r in REPEATS], device="cuda")
    store = SpeedStore.empty(len(REPEATS), backend="torch", device="cuda")
    overhead_ms = {"fold_in": [], "partition_units": []}

    def timed(name, method):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = method(*args, **kwargs)
            torch.cuda.synchronize()
            overhead_ms[name].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    for name in overhead_ms:
        setattr(store, name, timed(name, getattr(store, name)))
    sched = Scheduler(store, backend="torch", device="cuda")
    t0 = time.perf_counter()
    res = sched.autotune(executor, UNITS, EPS, min_units=1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    history = res.diagnostics["history"]
    out = {
        "converged": res.converged, "iterations": res.iterations, "final_imbalance": res.imbalance,
        "wall_s": wall_s, "round_ms_sum": sum(max(t) for _, t in history) * 1e3,
        "overhead_ms_sum": sum(overhead_ms["fold_in"]) + sum(overhead_ms["partition_units"]),
        "fold_in_ms": overhead_ms["fold_in"], "partition_units_ms": overhead_ms["partition_units"],
        "allocations": res.allocations,
        "rounds": [{"d": d, "imbalance": imbalance(t), "times_ms": [v * 1e3 for v in t]} for d, t in history],
    }
    return out, executor, imbalance


def _device_only_ms(fn, units: int) -> float:
    """``fn(units)`` timed by CUDA events with its launches queued behind
    a device-side sleep: the card's clock sees no host gap between them."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(units)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def probe_dfpa(write, runs: int) -> None:
    for i in range(runs):
        out, executor, imbalance = _dfpa_once()
        d = out["allocations"]
        by_proc = {}
        for r in out["rounds"]:
            for p, (units, ms) in enumerate(zip(r["d"], r["times_ms"])):
                by_proc.setdefault((p, units), []).append(ms)
        same_d = [max(v) / min(v) - 1 for v in by_proc.values() if len(v) > 1]
        loop_ms = [[v * 1e3 for v in executor.run(d)] for _ in range(30)]
        quiet_ms = [[_device_only_ms(fn, u) for fn, u in zip(executor.fns, d)] for _ in range(30)]
        summary = {
            "probe": "dfpa", "run": i, "converged": out["converged"], "iterations": out["iterations"],
            "final_imbalance": out["final_imbalance"], "wall_s": out["wall_s"],
            "round_ms_sum": out["round_ms_sum"], "overhead_ms_sum": out["overhead_ms_sum"],
            "round_imbalance": [r["imbalance"] for r in out["rounds"]],
            "same_units_rel_spread": _spread(same_d) if same_d else None,
            "final_d": d,
            "final_d_imbalance_as_the_loop_times": _spread([imbalance(t) for t in loop_ms]),
            "final_d_imbalance_device_only": _spread([imbalance(t) for t in quiet_ms]),
            "final_d_share_over_eps_as_the_loop_times": float(np.mean([imbalance(t) > EPS for t in loop_ms])),
            "final_d_share_over_eps_device_only": float(np.mean([imbalance(t) > EPS for t in quiet_ms])),
            "proc_rel_spread_as_the_loop_times": [max(c) / min(c) - 1 for c in zip(*loop_ms)],
            "proc_rel_spread_device_only": [max(c) / min(c) - 1 for c in zip(*quiet_ms)],
        }
        write({**out, "probe": "dfpa_run", "run": i})
        write({**summary, "loop_ms": loop_ms, "device_only_ms": quiet_ms})
        print(json.dumps(summary), flush=True)
        del executor


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ directory that holds repro_torch")
    ap.add_argument("--only", default="rows,dfpa")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "dfpa_probe.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dfpa_probe: no CUDA device")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "src": args.src, "package": _build.__file__}), flush=True)
    _build.build(["matmul_update"])
    probes = {"rows": probe_rows, "dfpa": lambda w: probe_dfpa(w, args.runs)}
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        def write(obj):
            f.write(json.dumps(obj) + "\n")
            f.flush()

        t0 = time.perf_counter()
        for name in args.only.split(","):
            probes[name](write)
        print(json.dumps({"probe_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
