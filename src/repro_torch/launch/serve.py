"""Serving CLI: batched prefill + greedy decode, and DFPA-balanced replica
dispatch.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 4 \\
        --prompt-len 4096 --new-tokens 32          # full width, on the card
    python -m repro_torch.launch.serve --smoke --replicas 4 --chunks 64
        # DFPA dispatch demo across emulated replicas, bank on --device

Weights are random, drawn from a ``torch.Generator`` seeded with
``--seed``; the prompt's tokens from another, seeded with ``--seed + 1``.
It prints the generated shape and tok/s: on the card timed with CUDA
events over one ``generate`` after the kernels' build and one untimed
warm-up ``generate``, on the CPU with the host clock.  ``--profile`` then traces one
prefill and 8 decode steps with ``torch.profiler`` and
prints, for each, the wall time, the device's busy time and idle share,
and the device time by kernel (one JSON line each).  ``--replicas N``
then runs the reference's dispatch demo: ``N`` emulated replicas whose
per-chunk cost is drawn from ``default_rng(0)`` and grows x4 past a drawn
capacity, balanced over ``--chunks`` chunks by
``ReplicaDispatcher.balance`` with its bank on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import _build
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.modelbank_torch import resolve_device
from ..models.transformer import decode_step, init_lm, prefill
from ..runtime.serve_loop import ReplicaDispatcher, ServeEngine

__all__ = ["demo_replica_run", "main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true", help="trace one prefill and 8 decode steps")
    ap.add_argument("--replicas", type=int, default=0, help=">0: DFPA dispatch demo")
    ap.add_argument("--chunks", type=int, default=64)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    budget = args.prompt_len + args.new_tokens
    eng = ServeEngine(cfg, params, batch=args.batch, seq_budget=budget, device=device)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g, device=device)

    if device.type == "cuda":
        _build.build(["flash_attention", "rglru_scan"])  # the kernels' build is set-up, not serving
        eng.generate(toks, args.new_tokens)  # warm-up, untimed
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = eng.generate(toks, args.new_tokens)
        end.record()
        end.synchronize()
        dt, clock = start.elapsed_time(end) / 1e3, "CUDA events"
    else:
        t0 = time.perf_counter()
        out = eng.generate(toks, args.new_tokens)
        dt, clock = time.perf_counter() - t0, "host clock"
    print(f"generated {tuple(out.shape)} in {dt:.3f}s ({args.batch * args.new_tokens / dt:.1f} tok/s, {clock})")
    print("sample:", out[0][:12].tolist())
    if args.profile:
        profile_serving(eng, toks)
    if args.replicas > 0:
        dispatch_demo(args.replicas, args.chunks, device)
    return out


def demo_replica_run(replicas: int, chunks: int):
    """The reference demo's replicas: a per-chunk cost drawn per replica
    from ``default_rng(0)``, growing x4 past a drawn capacity (the FPM
    speed function of serving).  Returns ``replica_run(i, x)`` in seconds."""
    rng = np.random.default_rng(0)
    base = rng.uniform(2e-4, 8e-4, replicas)
    caps = rng.integers(chunks // 2, chunks, replicas)

    def replica_run(i, x):
        t = x * base[i]
        if x > caps[i]:  # HBM spill: per-chunk cost grows past capacity
            t += (x - caps[i]) * base[i] * 4.0
        return t

    return replica_run


def dispatch_demo(replicas: int, chunks: int, device) -> None:
    """The reference's demo: ``demo_replica_run``'s heterogeneous replicas
    balanced by DFPA."""
    disp = ReplicaDispatcher(demo_replica_run(replicas, chunks), replicas, eps=0.1, device=device)
    res = disp.balance(chunks)  # Partition, via the Scheduler facade
    print(
        f"DFPA dispatch over {replicas} replicas: d={res.allocations} "
        f"iters={res.iterations} imb={res.imbalance:.3f} converged={res.converged}"
    )


def _kernel_table(prof, top: int = 25):
    """Device time by kernel name, in ms, most first; the total ms; and the
    number of kernels launched."""
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) is not None and str(evt.device_type).endswith("CUDA"):
            rows.append((evt.key, evt.self_device_time_total / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    return rows[:top], sum(r[1] for r in rows), sum(r[2] for r in rows)


PROFILE_DECODE_STEPS = 8


def profile_serving(eng: ServeEngine, tokens, steps: int = PROFILE_DECODE_STEPS) -> None:
    """One prefill, then ``steps`` decode steps, each traced by
    ``torch.profiler``: wall ms (the device's clock, CUDA events), device
    busy ms (the sum of kernel times; one stream, so no overlap), the idle
    share, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    if eng.device.type != "cuda":
        raise ValueError("--profile measures the card: run with --device cuda")
    cfg, params = eng.cfg, eng.params

    def traced(label, fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            result = fn()
            end.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        table, busy, launched = _kernel_table(prof)
        print(json.dumps({
            "profile": label, "wall_ms": wall, "device_busy_ms": busy, "kernels_launched": launched,
            "idle_share": (1.0 - busy / wall) if wall > 0 else None,
            "kernels": [{"name": n[:160], "ms": ms, "count": c} for n, ms, c in table],
        }), flush=True)
        return result

    with torch.inference_mode():
        logits, caches = traced("prefill", lambda: prefill(params, cfg, tokens, eng.new_cache()))
        tok = torch.argmax(logits, -1)[:, None]
        pos = tokens.shape[1]

        def decode_steps():
            nonlocal tok, caches
            for i in range(steps):
                step_logits, caches = decode_step(params, cfg, tok, pos + i, caches)
                tok = torch.argmax(step_logits, -1)[:, None]

        traced(f"decode x{steps}", decode_steps)


if __name__ == "__main__":
    main()
