"""The two readings each compared number's limit is set from, at a cell's
own size: the program's reading on many seeds, and the control's (the
plain reference computed in the next lower precision, fp8, put in the
program's place and judged by the run's own check) on a few.  All seeds
run in one process: each builds the cell's system from its seed, runs a
short window at the cell's own load, and reads the numbers the run's check
compares, and whether the check passed.

    python3 bench/tests/controls.py --workload hcl-matmul.steady --seeds 12 --control-seeds 3 --seconds 5

Prints one JSON line a seed.  Runs on the card; the tests call
``readings`` on the CPU at a small size.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
from typing import Dict, Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench.lib import loader  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device: torch.device, *, control: bool,
             overrides: Optional[Dict] = None) -> Dict:
    """The program's numbers (each check's value) and whether its check
    passed and, with ``control``, the same of the control, for one seed."""
    overrides = overrides or {}
    bench = loader.benchmark()
    entry = loader.workload(bench, cell)
    cfg = {**loader.config(bench, entry["config"]), **overrides.get("config", {})}
    mix = {**loader.traffic(entry["traffic"]), **overrides.get("traffic", {})}
    system = loader.system(cfg["system"]).System(cfg, mix, seed, device)
    record = system.window(seconds)
    system.release()
    checks = system.check(record)
    out = {"seed": seed, "program": {c["name"]: c["value"] for c in checks},
           "program_correct": all(c["ok"] for c in checks)}
    if control:
        checks = system.control(record)
        out.update(control={c["name"]: c["value"] for c in checks}, control_correct=all(c["ok"] for c in checks))
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("controls: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for k in range(args.seeds):
        row = readings(args.workload, args.first_seed + 7919 * k, args.seconds, device,
                       control=k < args.control_seeds)
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
