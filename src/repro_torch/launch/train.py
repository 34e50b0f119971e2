"""Training CLI: real steps on one device, DFPA-balanced groups.

The port's copy of the reference's ``launch/train.py``.  Two modes:
  * ``--groups 1`` (default): plain single-group training of a config
    (``train_single``), with the in-place update (it never reuses an old
    state);
  * ``--groups N``: heterogeneous multi-group training (``train_hetero``);
    each group runs its own accumulation step over its DFPA-allocated
    units.  Groups share one device, so per-group heterogeneity is
    emulated by a slowdown factor applied to the *measured* step time
    (each group's step timed between two synchronisations of the device);
    the control plane — DFPA, straggler detection — runs for real through
    one ``Scheduler`` (its bank on ``--device``).  Every group steps from
    the same state and group 0's result is kept (single-device emulation;
    the groups' gradients are averaged in production).

Every architecture trains: the decoder LMs, xLSTM, pixtral-12b (its batches
carry the vision stub's ``prefix_embeds``) and the encoder-decoder
seamless-m4t-medium (its batches carry the audio stub's ``frames``, one per
token).  Weights are random, from a ``torch.Generator`` seeded with 0.
``--device`` defaults to ``cuda``; ``--device cpu`` runs on the host.

Usage:
    python -m repro_torch.launch.train --arch gemma2-2b --smoke --steps 20 --device cpu
    python -m repro_torch.launch.train --arch granite-moe-1b-a400m --smoke --groups 4 \\
        --hetero 1.0,1.4,2.0,3.1 --steps 12 --device cpu
    python -m repro_torch.launch.train --arch xlstm-350m --smoke --groups 4 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _build
from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.modelbank_torch import resolve_device
from ..core.scheduler import Scheduler
from ..data import SyntheticLMData, UnitBatcher
from ..optim.schedule import warmup_cosine
from ..runtime.straggler import StragglerAction, StragglerDetector
from ..runtime.train_loop import _device_batch, init_train_state, make_train_step
from .serve import kernels_for

__all__ = ["main", "train_hetero", "train_single"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_single(cfg, *, steps: int, batch: int, seq: int, lr: float, ckpt_dir=None, log_every=1,
                 device="cuda", history: Optional[List[Dict]] = None):
    """``steps`` steps of batch ``batch`` x ``seq`` from seed 0, the update
    in place; checkpoints every 50 steps and at the end when ``ckpt_dir``
    is given.  Returns (state, losses).  ``history``, when given, receives
    one dict a step: loss, grad norm and the step's ms (host clock between
    two synchronisations of the device)."""
    dev = resolve_device(device)
    state = init_train_state(cfg, 0, device=dev)
    step_fn = make_train_step(cfg, warmup_cosine(lr, max(steps // 10, 1), steps), inplace=True)
    data = SyntheticLMData(cfg, batch, seq)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    losses = []
    for i in range(steps):
        b = _device_batch(data.next(), dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        if history is not None:
            history.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]), "ms": dt * 1e3})
        if i % log_every == 0:
            print(f"step {i:4d} loss {loss:8.4f} gnorm {float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f}ms", flush=True)
        if mgr and (i + 1) % 50 == 0:
            mgr.save_async(i + 1, state, extra={"data": data.state_dict()})
    if mgr:
        mgr.save_async(steps, state)
        mgr.wait()
    return state, losses


def train_hetero(cfg, *, steps: int, groups: int, hetero: List[float], n_units: int,
                 micro_batch: int, seq: int, lr: float, eps: float = 0.15, device="cuda",
                 history: Optional[List[Dict]] = None):
    """Multi-group DFPA-balanced training (per-group grad-accum steps).
    Returns (state, the ``Scheduler``).  ``history``, when given, receives
    one dict a step: the distribution the step ran, each group's emulated
    time (s), the groups' mean loss and whether DFPA rebalanced after it."""
    dev = resolve_device(device)
    state = init_train_state(cfg, 0, device=dev)
    sched = warmup_cosine(lr, max(steps // 10, 1), steps)
    data = SyntheticLMData(cfg, micro_batch, seq)
    batcher = UnitBatcher(data, micro_batch)
    # One Scheduler session drives the whole control plane: online DFPA
    # observation, repartitioning, and straggler reprofiling.
    ctrl = Scheduler(
        n_units=n_units, num_groups=groups, eps=eps, min_units=1,
        detector=StragglerDetector(), device=dev,
    )
    # One step function per distinct accumulation length.
    step_fns: Dict[int, object] = {}

    def step_for(a: int):
        if a not in step_fns:
            step_fns[a] = make_train_step(cfg, sched, accum_steps=a)
        return step_fns[a]

    print(f"groups={groups} hetero={hetero} units/step={n_units}")
    for i in range(steps):
        units = batcher.global_step_units(n_units, i)
        d = list(ctrl.d)
        parts = batcher.split(units, d)
        times, losses = [], []
        new_state = None
        for g, part in enumerate(parts):
            if d[g] == 0:
                times.append(0.0)
                continue
            gb = _device_batch(part, dev)
            fn = step_for(d[g])
            _sync(dev)
            t0 = time.perf_counter()
            out_state, metrics = fn(state, gb)
            _sync(dev)
            dt = (time.perf_counter() - t0) * hetero[g]  # emulated heterogeneity
            times.append(dt)
            losses.append(float(metrics["loss"]))
            if new_state is None:
                new_state = out_state  # groups' grads averaged in production;
                # single-device emulation keeps one group's update
            del out_state, metrics
        state = new_state
        del new_state
        # straggler scan BEFORE folding times into the models (REPROFILE
        # actions are applied by the facade automatically)
        acts = ctrl.straggler_actions(times)
        for g, act in enumerate(acts):
            if act is not StragglerAction.NONE:
                print(f"    straggler[{g}]: {act.value}", flush=True)
        changed = ctrl.observe(times)
        if history is not None:
            history.append({"d": d, "times": times, "loss": float(np.mean(losses)), "rebalanced": bool(changed),
                            "actions": [a.value for a in acts]})
        print(
            f"step {i:3d} loss {np.mean(losses):7.4f} times "
            + "/".join(f"{t*1e3:6.1f}" for t in times)
            + f" d={ctrl.d}{' (rebalanced)' if changed else ''}",
            flush=True,
        )
    print(f"rebalances: {ctrl.rebalances}, final d={ctrl.d}")
    return state, ctrl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--hetero", default="", help="comma-separated slowdowns per group")
    ap.add_argument("--units", type=int, default=16, help="microbatches per global step")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if resolve_device(args.device).type == "cuda":
        _build.build(kernels_for(cfg))  # the kernels' build is set-up, not training
    if args.groups <= 1:
        train_single(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     lr=args.lr, ckpt_dir=args.ckpt, device=args.device)
    else:
        het = [float(x) for x in args.hetero.split(",")] if args.hetero else [
            1.0 + 0.7 * g for g in range(args.groups)
        ]
        assert len(het) == args.groups
        train_hetero(cfg, steps=args.steps, groups=args.groups, hetero=het,
                     n_units=args.units, micro_batch=args.batch, seq=args.seq, lr=args.lr,
                     device=args.device)


if __name__ == "__main__":
    main()
