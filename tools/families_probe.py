"""Run ``chip_smoke.py``'s ``families`` phase alone on one NVIDIA H100.

    python3 tools/families_probe.py [--runs 1] [--profile]

Run on a machine with the card, from the root of a checkout.  It checks the
card as the ``device`` phase does, builds ``flash_attention``, then runs
``chip_smoke.phase_families`` (xlstm-350m, seamless-m4t-medium and
pixtral-12b served, xlstm-350m and seamless-m4t-medium trained, the cross
gradient, the smoke models) ``--runs`` times with every gate of the phase,
each part one JSON line as the phase prints it.  ``--profile`` then traces
one xlstm-350m prefill (``FAMILY_XLSTM``'s shape) and 8 decode steps with
``launch.serve.profile_serving``: wall, the card's busy time, idle share
and kernels by device time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("families_probe: no CUDA device")
    smoke = _smoke()
    smoke.phase_device()
    smoke._build.build(["flash_attention"])
    t0 = time.perf_counter()
    for run in range(args.runs):
        t1 = time.perf_counter()
        launches = smoke.phase_families()
        smoke.emit({"phase": "families", "run": run, "launches": launches, "seconds": time.perf_counter() - t1})
    if args.profile:
        from repro_torch.launch.serve import profile_serving

        t = smoke.FAMILY_XLSTM
        cfg = smoke.get_config(t["arch"])
        model = smoke.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        eng = smoke.ServeEngine(cfg, model, batch=t["batch"], seq_budget=t["prompt"] + t["new"], device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (t["batch"], t["prompt"]),
                               generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
        eng.generate(prompt, 2)  # warm-up
        profile_serving(eng, prompt)
    print(json.dumps({"probe_seconds": time.perf_counter() - t0}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
