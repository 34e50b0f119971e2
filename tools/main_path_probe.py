"""Time the port's serving, training and dispatch paths of one checkout on
one NVIDIA H100.

    python3 tools/main_path_probe.py [--root DIR] [--label NAME]

Run on a machine with the card.  The probe loads ``chip_smoke.py`` from
``--root`` (default: this checkout), so the package it drives is
``DIR/src/repro_torch`` and the kernels are built from ``DIR``'s sources.
To compare two commits, unpack the other one under ``build/`` (which
``.gitignore`` lists) with ``git archive``, and run the probe once for
each checkout in one call, in the order A, B, B, A.

It runs ``chip_smoke.py``'s ``device`` and ``build`` phases, then, with
every gate of the phase they come from:

- ``serve``: recurrentgemma-2b, batch 4, a 4,096-token prompt, 32 greedy
  tokens (``phase_serve``): prefill ms and decode ms a token;
- ``dispatch`` (c): two tenants over four replicas sharing the card, then
  the steady epochs (``dispatch_model``, ``dispatch_cycle``): each
  round's wall ms, the busiest replica's sum;
- gemma2-2b training at full width, 8 x 1,024, 6 steps
  (``train_gemma``): the median step ms of steps 2-6.

Each part prints one JSON line as the phase does; then one summary line
``{"label", "root", "serve_prefill_ms", "decode_ms_per_token",
"dispatch_c_round_ms", "train_step_ms", "train_peak_bytes", "seconds"}``
and the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import pathlib
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke(root: pathlib.Path):
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # puts root/src first on sys.path
    return mod


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    t0 = time.perf_counter()
    cs = _smoke(root)
    smi = cs.phase_device()
    cs.phase_build()
    serve = cs.phase_serve()
    _free()
    cfg, model = cs.dispatch_model()
    cycle = cs.dispatch_cycle(cfg, model)
    cs.emit({"phase": "dispatch", "part": "c", **cycle})
    if not all(cycle["checks"].values()):
        raise SystemExit(f"main_path_probe: dispatch (c) failed its checks: {cycle['checks']}")
    del model
    _free()
    train = {"phase": "train", "part": "gemma2-2b"}
    cs.train_gemma(train)
    cs.emit(train)
    cs.emit({
        "label": args.label, "root": str(root), "serve_prefill_ms": serve["prefill_ms"],
        "decode_ms_per_token": serve["decode_ms_per_token"],
        "dispatch_c_round_ms": cycle["round_wall_cost_ms"], "train_step_ms": train["step_ms"],
        "train_peak_bytes": train["peak_memory_bytes"], "seconds": time.perf_counter() - t0,
    })
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
