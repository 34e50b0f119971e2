"""Run ``chip_smoke.py``'s ``decoders`` phase alone on one NVIDIA H100.

    python3 tools/decoders_probe.py [--only gemma2-2b,deepseek-v2-236b] [--runs 1]
                                    [--no-timing] [--no-smoke]

Run on a machine with the card, from the root of a checkout.  It checks the
card as the ``device`` phase does, builds ``flash_attention``, then runs
``chip_smoke.decoder_full`` for each architecture of ``DECODERS`` named in
``--only`` (default: all six), ``--runs`` times each, with every gate of the
phase; then, unless told not to, the kernel's timing at gemma2-2b's prefill
shape and the six smoke models in float32 against the CPU.  Each result is
one JSON line, as the phase prints it.
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
    ap.add_argument("--only", default="")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--no-smoke", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decoders_probe: no CUDA device")
    smoke = _smoke()
    smoke.phase_device()
    smoke._build.build(["flash_attention"])
    names = [n for n in args.only.split(",") if n] or [d[0] for d in smoke.DECODERS]
    unknown = set(names) - {d[0] for d in smoke.DECODERS}
    if unknown:
        raise SystemExit(f"decoders_probe: not in DECODERS: {sorted(unknown)}")
    t0 = time.perf_counter()
    for arch, layers, batch, prompt_len, new, route in smoke.DECODERS:
        if arch not in names:
            continue
        for run in range(args.runs):
            t1 = time.perf_counter()
            row = {"phase": "decoders", "part": "full", "run": run}
            try:
                smoke.decoder_full(row, arch, layers, batch, prompt_len, new, route)
            finally:
                row["seconds"] = time.perf_counter() - t1
                smoke.emit(row)
    if not args.no_timing:
        cfg = smoke.get_config("gemma2-2b")
        kw = dict(causal=True, window=cfg.window, softcap=cfg.attn_softcap, scale=cfg.query_scale)
        _, _, batch, prompt_len, _, route = smoke.DECODERS[0]
        timing = smoke._flash_timing_at(batch, cfg.num_heads, cfg.num_kv_heads, prompt_len, cfg.head_dim, kw,
                                        route, "at gemma2-2b's prefill shape", seed=11)
        smoke.emit({"phase": "decoders", "part": "flash_timing", "timing": timing})
    if not args.no_smoke:
        for arch in names:
            smoke.emit({"phase": "decoders", "part": "smoke", **smoke._serve_smoke({}, arch)})
    print(json.dumps({"probe_seconds": time.perf_counter() - t0}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
