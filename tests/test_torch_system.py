"""End-to-end behaviour of the port's training path: the paper's
self-adaptable application (``tests/test_system.py``'s first and fourth
tests, run through ``repro_torch``).

1. Heterogeneous multi-group training with online DFPA rebalancing
   (simulated group speeds, real steps): the distribution after every step
   equals the reference's controller's on the same times, and the model
   learns.
2. Checkpoint/restore of model + balance state, then an elastic group
   change (``BalanceController.from_state``, ``elastic_rebalance``).
"""

import tempfile
import warnings

import numpy as np
import torch

from repro.runtime.balance import BalanceController as RefBalanceController
from repro.runtime.elastic import elastic_rebalance as ref_elastic_rebalance

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import imbalance
from repro_torch.data import SyntheticLMData, UnitBatcher
from repro_torch.nn import tree_leaves
from repro_torch.optim import warmup_cosine
from repro_torch.runtime import BalanceController, elastic_rebalance, init_train_state, make_train_step


def test_hetero_training_rebalances_and_learns():
    """4 heterogeneous groups; DFPA shifts units toward fast groups while
    the model trains (loss decreases).  The times are the reference test's
    deterministic per-unit costs, so the reference's controller fed the
    same times gives the reference's distribution at every step."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    state = init_train_state(cfg, 0, device="cpu")
    sched = warmup_cosine(3e-3, 2, 40)
    n_units, groups = 16, 4
    hetero = [1.0, 1.0, 2.0, 4.0]  # last group 4x slower
    batcher = UnitBatcher(SyntheticLMData(cfg, batch=2, seq=16), micro_batch=2)
    ctrl = BalanceController(n_units=n_units, num_groups=groups, eps=0.2, smooth=1.0)
    ref_ctrl = RefBalanceController(n_units=n_units, num_groups=groups, eps=0.2, smooth=1.0)
    step_fns, losses, trajectory = {}, [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # the shims' notice
        for i in range(10):
            units = batcher.global_step_units(n_units, i)
            parts = batcher.split(units, ctrl.d)
            times = []
            for g, part in enumerate(parts):
                a = ctrl.d[g]
                if a == 0:
                    times.append(0.0)
                    continue
                if a not in step_fns:
                    step_fns[a] = make_train_step(cfg, sched, accum_steps=a)
                new_state, m = step_fns[a](state, part)
                times.append(a * 0.01 * hetero[g])  # emulated heterogeneity
                if g == 0:
                    keep_state, loss = new_state, float(m["loss"])
            state = keep_state
            losses.append(loss)
            ctrl.observe(times)
            ref_ctrl.observe(times)
            trajectory.append(list(ctrl.d))
            assert list(ctrl.d) == list(ref_ctrl.d), (i, trajectory)
    assert ctrl.d[3] < ctrl.d[0]
    assert imbalance([d * 0.01 * h for d, h in zip(ctrl.d, hetero)]) <= 0.6
    assert losses[-1] < losses[0] and np.isfinite(losses).all()


def test_full_state_checkpoint_with_balance_and_elastic_restart():
    cfg = get_smoke_config("gemma2-2b")
    state = init_train_state(cfg, 0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ctrl = BalanceController(n_units=12, num_groups=3, eps=0.1, smooth=1.0)
        ctrl.observe([1.0, 2.0, 3.0])
        ref_ctrl = RefBalanceController(n_units=12, num_groups=3, eps=0.1, smooth=1.0)
        ref_ctrl.observe([1.0, 2.0, 3.0])
    data = SyntheticLMData(cfg, batch=2, seq=16)
    data.next()

    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"train": state}, extra={"balance": ctrl.state_dict(), "data": data.state_dict()})
        like = {"train": init_train_state(cfg, 1, device="cpu")}  # other values, same structure
        restored, man = load_checkpoint(d, like)
        # model state identical
        for (pa, a), (pb, b) in zip(tree_leaves(restored["train"].params), tree_leaves(state.params)):
            assert pa == pb and torch.equal(a, b)
        # balance state: warm restart + elastic change (drop group 0)
        ctrl2 = BalanceController.from_state(man["extra"]["balance"], eps=0.1)
        assert ctrl2.d == ctrl.d == list(ref_ctrl.d)
        ctrl3 = elastic_rebalance(ctrl2, surviving=[1, 2])
        assert sum(ctrl3.d) == 12
        assert ctrl3.d == list(ref_elastic_rebalance(ref_ctrl, surviving=[1, 2]).d)
        # data pipeline resumes at the right index
        assert man["extra"]["data"]["next_index"] == 1
        resumed = SyntheticLMData(cfg, batch=2, seq=16)
        resumed.load_state_dict(man["extra"]["data"])
        assert np.array_equal(resumed.next()["tokens"], data.next()["tokens"])
