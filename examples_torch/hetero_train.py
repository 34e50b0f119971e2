"""Heterogeneous LM training with ONLINE DFPA rebalancing + straggler
detection + an elastic group loss — the framework's production story in
miniature (real training steps; group heterogeneity emulated by
deterministic per-group slowdowns).

One ``Scheduler`` session is the whole control plane: ``observe`` folds
step times into the models and repartitions past ``eps``,
``straggler_actions`` flags and reprofiles unhealthy groups, and ``leave``
handles the elastic departure with a warm re-partition.

The PyTorch twin of ``examples/hetero_train.py``.  The training steps run
on the card: the smoke granite-20b in bf16, multi-query attention (one K/V
head) of head_dim 16, so each step's forward goes through the flash
kernel (the backward is plain torch).  One step function per accumulation
count is built and kept, as the reference keeps one jitted step per count,
and the batches are moved to the card.  The weights come from a
``torch.Generator`` seeded 0, so the losses are not the reference's; the
emulated group times, the distributions, the straggler actions and the
elastic leave are.

    PYTHONPATH=src python examples_torch/hetero_train.py [--device cpu]
"""

import argparse
import math

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import Scheduler
from repro_torch.core.modelbank_torch import resolve_device
from repro_torch.data import SyntheticLMData, UnitBatcher
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.straggler import StragglerAction, StragglerDetector
from repro_torch.runtime.train_loop import init_train_state, make_train_step

GROUPS, UNITS, STEPS = 4, 16, 14
HETERO = [1.0, 1.3, 2.0, 3.5]  # per-group slowdown factors (unknown to DFPA)


def main(device="cuda", *, dtype=None, params=None) -> dict:
    """``dtype`` overrides the smoke config's (bf16); ``params`` is a
    parameter tree in the reference's layout (for example
    ``nn.tree_from_reference`` of the reference's initial weights) in place
    of the seeded draw."""
    dev = resolve_device(device)
    cfg = get_smoke_config("granite-20b")
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    hetero = list(HETERO)

    state = init_train_state(cfg, 0, params=params, device=dev)
    sched = warmup_cosine(3e-3, 2, STEPS)
    data = SyntheticLMData(cfg, batch=2, seq=32)
    batcher = UnitBatcher(data, micro_batch=2)
    ctrl = Scheduler(
        n_units=UNITS, num_groups=GROUPS, eps=0.15, min_units=1, smooth=1.0,
        detector=StragglerDetector(factor=1.6, patience=2, patience_hard=5),
        device=dev,
    )
    step_fns = {}
    log = []

    print(f"groups={GROUPS} hetero={hetero} units/step={UNITS}")
    for step in range(STEPS):
        if step == 9:  # elastic event: group 3 (slowest) leaves the fleet
            ctrl.leave(3)
            hetero = hetero[:3]
            print(">>> elastic: group 3 left; warm-started DFPA re-partition")
        units = batcher.global_step_units(ctrl.n_units, step)
        parts = batcher.split(units, ctrl.d)
        times, loss = [], float("nan")
        for g, part in enumerate(parts):
            a = ctrl.d[g]
            if a == 0:
                times.append(0.0)
                continue
            if a not in step_fns:
                step_fns[a] = make_train_step(cfg, sched, accum_steps=a)
            gb = {k: torch.as_tensor(v, device=dev) for k, v in part.items()}
            new_state, metrics = step_fns[a](state, gb)
            times.append(a * 0.01 * hetero[g])  # emulated wall time
            if g == 0:
                state, loss = new_state, float(metrics["loss"])
        acts = ctrl.straggler_actions(times)  # REPROFILE applied automatically
        for g, act in enumerate(acts):
            if act is not StragglerAction.NONE:
                print(f"    straggler[{g}]: {act.value}")
        changed = ctrl.observe(times)
        print(
            f"step {step:2d} loss {loss:7.4f} d={ctrl.d}"
            + ("  <- rebalanced" if changed else "")
        )
        log.append({"loss": loss, "d": list(ctrl.d), "rebalanced": bool(changed),
                    "actions": [act.value for act in acts]})
    print(f"\nfinal distribution {ctrl.d}")
    print("slow groups ended with fewer microbatches — the paper's partitioning,")
    print("driven by training-step times instead of benchmark rounds.")
    claims = {"slowest_group_fewest_units": ctrl.d[hetero.index(max(hetero))] == min(ctrl.d),
              "losses_finite": all(math.isfinite(s["loss"]) for s in log)}
    return {"claims": claims, "steps": log, "final_d": list(ctrl.d), "hetero": hetero}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    main(ap.parse_args().device)
