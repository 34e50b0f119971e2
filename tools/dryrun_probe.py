"""Run ``chip_smoke.py``'s ``dryrun`` phase alone on one NVIDIA H100, and
the dry run's whole sweep.

    python3 tools/dryrun_probe.py [--runs 1] [--sweep DIR] [--no-phase]

Run on a machine with the card, from the root of a checkout.  It checks the
card as the ``device`` phase does, builds ``flash_attention`` and
``rglru_scan``, then runs ``chip_smoke.phase_dryrun`` ``--runs`` times with
every gate of the phase, each part one JSON line as the phase prints it.
``--sweep DIR`` then runs ``python -m repro_torch.launch.dryrun --arch all
--shape all --out DIR`` (the 40 cells, one process a cell, a core each)
and prints one table row a cell: status, resident GiB, fits, dominant
term, compute and memory ms, trace seconds.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_table(out_dir: str) -> list:
    """One row a cell of a sweep's JSON records, in the CLI's order."""
    from repro_torch.configs import ARCH_IDS, SHAPES

    rows = []
    for a in ARCH_IDS:
        for s in SHAPES:
            with open(os.path.join(out_dir, f"{a}_{s.name}_single.json")) as f:
                r = json.load(f)
            row = {"arch": a, "shape": s.name, "status": r["status"]}
            if r["status"] == "ok":
                row.update(resident_gib=r["mem"]["resident_bytes"] / 2**30, fits=r["fits_hbm"],
                           dominant=r["dominant"], compute_ms=r["terms"]["compute_s"] * 1e3,
                           memory_ms=r["terms"]["memory_s"] * 1e3, trace_s=r["trace_s"],
                           u1_resident_gib=r["cost_model"]["u1"]["resident_bytes"] / 2**30)
            else:
                row["detail"] = (r.get("reason") or r.get("error") or "")[:80]
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--sweep", default=None, help="run the 40-cell sweep into this directory")
    ap.add_argument("--no-phase", action="store_true", help="skip the phase (the sweep needs no card)")
    args = ap.parse_args()
    if not args.no_phase:
        if not torch.cuda.is_available():
            raise SystemExit("dryrun_probe: no CUDA device")
        smoke = _smoke()
        smoke.phase_device()
        smoke._build.build(["flash_attention", "rglru_scan"])
        for run in range(args.runs):
            t1 = time.perf_counter()
            launches = smoke.phase_dryrun()
            print(json.dumps({"phase": "dryrun", "run": run, "launches": launches,
                              "seconds": time.perf_counter() - t1}), flush=True)
    if args.sweep:
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all", "--shape", "all",
             "--out", args.sweep], env=env, cwd=ROOT,
        )
        print(json.dumps({"sweep": args.sweep, "exit": proc.returncode, "seconds": time.perf_counter() - t0}),
              flush=True)
        for row in sweep_table(args.sweep):
            print(json.dumps(row), flush=True)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
