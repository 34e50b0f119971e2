"""The model examples' twins held against the reference's scripts.

``examples_torch/{elastic_serve, hetero_train}.py`` run with ``--device
cpu`` beside ``examples/`` under ``JAX_PLATFORMS=cpu``: their standard
outputs must be equal line by line but for the engine's sample tokens and
the training losses, which depend on the random init (the reference draws
its weights and prompt from ``jax.random``, the twins from a
``torch.Generator`` and numpy).  Those are held next, in float32, with the
reference's initial weights carried across by ``nn.convert``:

* ``elastic_serve``: given the reference script's weights and prompt, the
  twin's engine generates exactly the reference engine's 16 tokens per
  request;
* ``hetero_train``: over the 14 steps, the ``d`` trajectory, the rebalance
  flags, the straggler actions and the elastic leave at step 9 equal the
  reference's run of the same loop from its own modules, and each step's
  loss lies within ``LOSS_RTOL`` of the reference's, relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import Scheduler as RefScheduler
from repro.data import SyntheticLMData as RefData
from repro.data import UnitBatcher as RefBatcher
from repro.nn.params import init_tree as ref_init_tree
from repro.optim.schedule import warmup_cosine as ref_warmup_cosine
from repro.runtime.serve_loop import ServeEngine as RefServeEngine
from repro.runtime.straggler import StragglerDetector as RefDetector
from repro.runtime.train_loop import init_train_state as ref_init_train_state
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro.runtime.train_loop import model_spec_for as ref_model_spec_for

from repro_torch.configs import get_smoke_config
from repro_torch.nn import params_from_reference, tree_from_reference
from _example_parity import assert_same_lines, load_twin, run_pair

LOSS_RTOL = 1e-4  # each of the 14 steps' losses, float32, relative to the reference's
RANDOM_INIT = "depends on the random init"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_elastic_serve_twin_prints_the_reference_lines():
    ref, twin = run_pair("elastic_serve")
    assert_same_lines(ref, twin, [(r"; sample \[(.*)\]$", RANDOM_INIT)])
    assert twin[0].startswith("engine: generated 16 tokens/request; sample [")


def test_elastic_serve_twin_generates_the_reference_tokens():
    jcfg = ref_smoke_config("stablelm-12b").replace(dtype=jnp.float32)
    params = ref_init_tree(jax.random.PRNGKey(0), ref_model_spec_for(jcfg))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, jcfg.vocab_size)
    want = np.asarray(RefServeEngine(jcfg, params, batch=2, seq_budget=48).generate(prompt, max_new=16))
    cfg = get_smoke_config("stablelm-12b").replace(dtype=torch.float32)
    got = load_twin("elastic_serve").main(
        device="cpu", dtype=torch.float32, params=params_from_reference(_np(params), cfg),
        prompt=np.asarray(prompt),
    )
    assert want.shape == (2, 16) and all(got["claims"].values())
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["d"] == [12, 19, 31, 34] and got["after_join"] == [11, 17, 28, 31, 9]


def test_hetero_train_twin_prints_the_reference_lines():
    ref, twin = run_pair("hetero_train")
    assert_same_lines(ref, twin, [(r"^step +\d+ loss +(\S+) d=", RANDOM_INIT)])
    assert ">>> elastic: group 3 left; warm-started DFPA re-partition" in twin


def _reference_loop(cfg, state):
    """``examples/hetero_train.py``'s loop on the reference's modules."""
    groups, units, steps, hetero = 4, 16, 14, [1.0, 1.3, 2.0, 3.5]
    sched = ref_warmup_cosine(3e-3, 2, steps)
    batcher = RefBatcher(RefData(cfg, batch=2, seq=32), micro_batch=2)
    ctrl = RefScheduler(n_units=units, num_groups=groups, eps=0.15, min_units=1, smooth=1.0,
                        detector=RefDetector(factor=1.6, patience=2, patience_hard=5))
    step_fns, log = {}, []
    for step in range(steps):
        if step == 9:
            ctrl.leave(3)
            hetero = hetero[:3]
        parts = batcher.split(batcher.global_step_units(ctrl.n_units, step), ctrl.d)
        times, loss = [], float("nan")
        for g, part in enumerate(parts):
            a = ctrl.d[g]
            if a == 0:
                times.append(0.0)
                continue
            if a not in step_fns:
                step_fns[a] = jax.jit(ref_make_train_step(cfg, sched, accum_steps=a))
            new_state, metrics = step_fns[a](state, {k: jnp.asarray(v) for k, v in part.items()})
            times.append(a * 0.01 * hetero[g])
            if g == 0:
                state, loss = new_state, float(metrics["loss"])
        acts = ctrl.straggler_actions(times)
        changed = ctrl.observe(times)
        log.append({"loss": loss, "d": list(ctrl.d), "rebalanced": bool(changed),
                    "actions": [act.value for act in acts]})
    return log


def test_hetero_train_twin_follows_the_reference_loop():
    jcfg = ref_smoke_config("granite-20b").replace(dtype=jnp.float32)
    state = ref_init_train_state(jcfg, jax.random.PRNGKey(0))
    params = tree_from_reference(_np(state.params))
    want = _reference_loop(jcfg, state)
    out = load_twin("hetero_train").main(device="cpu", dtype=torch.float32, params=params)
    got = out["steps"]
    assert len(got) == len(want) == 14
    for step, (w, g) in enumerate(zip(want, got)):
        assert (g["d"], g["rebalanced"], g["actions"]) == (w["d"], w["rebalanced"], w["actions"]), step
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"]), (step, g["loss"], w["loss"])
    assert [len(s["d"]) for s in got] == [4] * 9 + [3] * 5  # the elastic leave at step 9
    assert got[-1]["d"][-1] == min(got[-1]["d"])  # the slowest group ends with the fewest units
    assert all(out["claims"].values())
