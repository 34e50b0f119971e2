"""Run ``chip_smoke.py``'s ``train`` phase alone on one NVIDIA H100.

    python3 tools/train_probe.py [--only gemma2-2b,recurrentgemma-2b,groups] [--runs 1]
    python3 tools/train_probe.py --profile
    python3 tools/train_probe.py --only gemma2-2b --xent function,checkpoint,checkpoint,function

Run on a machine with the card, from the root of a checkout.  It checks the
card as the ``device`` phase does, builds ``flash_attention`` and
``rglru_scan``, then runs the parts of ``chip_smoke.phase_train`` named in
``--only`` (default: the whole phase, the gradient and checkpoint checks
included), ``--runs`` times, with every gate of the phase.  Each result is
one JSON line, as the phase prints it; then the launches by kernel, the
probe's seconds and the card's name and power limit.

``--xent`` lists, run by run (and sets ``--runs`` to its length), how the
loss chunk is differentiated: ``function`` (``transformer._XentChunk``,
the hand-written backward the model uses) or ``checkpoint`` (autograd
through ``transformer._xent_chunk`` under ``torch.utils.checkpoint``,
non-reentrant: the reference's ``jax.checkpoint`` of the chunk), so the
two can be compared in one process; each part reports its own peak.

``--profile`` instead traces, with ``torch.profiler``, the first two
steps of the phase's gemma2-2b run (``TRAIN_SINGLE``, the in-place
update) and two single-unit steps of granite-moe-1b-a400m at the phase's
micro-batch: for each step the wall ms (CUDA events), the device's busy
ms and idle share, the kernels by device time and the host operations by
self CPU time.
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
PARTS = ("gemma2-2b", "recurrentgemma-2b", "groups")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile_steps(label: str, cfg, batch: int, seq: int, steps: int = 2) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.serve import _kernel_table
    from repro_torch.optim import warmup_cosine
    from repro_torch.runtime import init_train_state, make_train_step

    state = init_train_state(cfg, 0, device="cuda")
    step = make_train_step(cfg, warmup_cosine(3e-3, 1, steps), inplace=True)
    data = SyntheticLMData(cfg, batch, seq)
    for i in range(steps):
        b = data.next()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            state, metrics = step(state, b)
            end.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        table, busy, launched = _kernel_table(prof)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()),
                      key=lambda r: -r[1])[:15]
        print(json.dumps({
            "profile": f"{label} step {i}", "loss": float(metrics["loss"]), "wall_ms": wall,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / wall, "kernels_launched": launched,
            "kernels": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in table],
            "host_ops": [{"name": n[:120], "self_cpu_ms": ms, "count": c} for n, ms, c in host],
        }), flush=True)
    del state


class _CheckpointedXent:
    """``_XentChunk``'s interface over autograd through ``_xent_chunk``
    under ``torch.utils.checkpoint``."""

    @staticmethod
    def apply(h, w, y, cap):
        from torch.utils.checkpoint import checkpoint

        from repro_torch.models import transformer

        return checkpoint(transformer._xent_chunk, h, w, y, cap, use_reentrant=False)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--profile", action="store_true", help="trace two steps of gemma2-2b and of a MoE unit")
    ap.add_argument("--xent", default="", help="function / checkpoint, one a run, comma-separated")
    args = ap.parse_args()
    xents = [x for x in args.xent.split(",") if x]
    if set(xents) - {"function", "checkpoint"}:
        raise SystemExit(f"train_probe: --xent takes function and checkpoint, not {xents}")
    if xents:
        args.runs = len(xents)
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: no CUDA device")
    smoke = _smoke()
    smoke.phase_device()
    smoke._build.build(["flash_attention", "rglru_scan"])
    names = [n for n in args.only.split(",") if n]
    unknown = set(names) - set(PARTS)
    if unknown:
        raise SystemExit(f"train_probe: not a part of the train phase: {sorted(unknown)} (parts: {PARTS})")
    t0 = time.perf_counter()
    if args.profile:
        t = smoke.TRAIN_SINGLE
        _profile_steps("gemma2-2b", smoke.get_config(t["arch"]), t["batch"], t["seq"])
        torch.cuda.empty_cache()
        h = smoke.TRAIN_HETERO
        _profile_steps("granite-moe unit", smoke.get_config(h["arch"]), h["micro_batch"], h["seq"])
        args.runs = 0
    from repro_torch.models import transformer

    hand_written = transformer._XentChunk
    for run in range(args.runs):
        xent = xents[run] if xents else "function"
        transformer._XentChunk = hand_written if xent == "function" else _CheckpointedXent
        if not names:
            print(json.dumps({"run": run, "launches": smoke.phase_train()}), flush=True)
            continue
        parts = {"gemma2-2b": smoke.train_gemma, "recurrentgemma-2b": smoke.train_rec, "groups": smoke.train_groups}
        for name in names:
            row = {"phase": "train", "part": name, "run": run, "xent": xent}
            t1 = time.perf_counter()
            try:
                parts[name](row)
            finally:
                row["seconds"] = time.perf_counter() - t1
                smoke.emit(row)
    print(json.dumps({"probe_seconds": time.perf_counter() - t0}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
