"""Run ``chip_smoke.py``'s ``examples`` phase alone on one NVIDIA H100.

    python3 tools/examples_probe.py [--against-cpu]

Run on a machine with the card, from the root of a checkout.  It checks the
card as the ``device`` phase does, builds ``flash_attention``, then runs
``chip_smoke.phase_examples`` once with every gate of the phase (each twin
one JSON line as the phase prints it; the twins' printed lines go to
``build/examples/<name>.txt``).  ``--against-cpu`` then runs each twin
again with ``device="cpu"`` and prints, a twin, the lines it printed on
the card that differ from those it printed on the host (the CPU tests hold
the host's lines to the reference's scripts).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import pathlib
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
    ap.add_argument("--against-cpu", action="store_true", help="diff each twin's lines against a host run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("examples_probe: no CUDA device")
    smoke = _smoke()
    print(smoke.phase_device(), flush=True)
    smoke._build.build(["flash_attention"])
    t0 = time.perf_counter()
    launches = smoke.phase_examples()
    print(json.dumps({"phase": "examples", "launches": launches, "seconds": time.perf_counter() - t0}), flush=True)
    if args.against_cpu:
        for name in smoke.EXAMPLES:
            card = (smoke.ARTIFACTS / "examples" / f"{name}.txt").read_text().splitlines()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                smoke._load_example(name).main(device="cpu")
            host = buf.getvalue().splitlines()
            differ = [{"line": i, "card": a, "cpu": b} for i, (a, b) in enumerate(zip(card, host)) if a != b]
            print(json.dumps({"example": name, "lines": [len(card), len(host)], "differ": differ,
                              "cpu_seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
