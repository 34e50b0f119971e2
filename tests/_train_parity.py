"""Helpers shared by the tests that hold the port's train step against
the reference's jitted step (``test_torch_train_step.py``,
``test_torch_xlstm.py``, ``test_torch_encdec.py``).

Tolerances, relative to the largest magnitude of the reference's value:
the loss 1e-5 (float32); each step taken by both packages from the
reference's state before it: the AdamW moments 1e-4 in each leaf, and
each leaf's update (new minus old parameters) 1e-4 in L2 relative to the
reference's update, over the elements whose gradient the two packages
resolve — whose first moment is more than 100 times the two packages'
difference in it.  Elements whose gradient is rounding noise (AdamW gives
them a step of about ``lr`` whose sign the last bits decide) may be at
most 1e-3 of those whose gradient is not zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.runtime import train_loop as jtrain

from repro_torch.nn import tree_from_reference, tree_leaves, tree_map
from repro_torch.optim import AdamWState, warmup_cosine
from repro_torch.runtime import TrainState, init_train_state, make_train_step

KEY = jax.random.PRNGKey(0)
LOSS_TOL = 1e-5
STEP_UPDATE_TOL = 1e-4
STEP_MOMENT_TOL = 1e-4
UNRESOLVED_SHARE = 1e-3
RESOLVED = 100.0


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.max(np.abs(want - got)) / (np.max(np.abs(want)) + 1e-30))


def leaf_rels(want_tree, got_tree) -> dict:
    """Per-leaf rel of a port tree (tensors) against a reference tree."""
    want = dict(tree_leaves(np_tree(want_tree)))
    got = dict(tree_leaves(got_tree))
    assert set(want) == set(got)
    return {path: rel(want[path], got[path]) for path in want}


def state_from_reference(ref_state) -> TrainState:
    """The reference's ``TrainState`` as the port's, on the host."""
    to = lambda tree: tree_from_reference(np_tree(tree))  # noqa: E731
    return TrainState(tree_map(lambda t: t.requires_grad_(True), to(ref_state.params)),
                      AdamWState(to(ref_state.opt.mu), to(ref_state.opt.nu),
                                 torch.tensor(int(ref_state.opt.count), dtype=torch.int32)),
                      torch.tensor(int(ref_state.step), dtype=torch.int32))


def step_rels(before, ref_state, state) -> tuple:
    """Per leaf: the moments' rel, and the update's L2 rel over the
    elements whose first moment is resolved; with the share of unresolved
    elements among those whose gradient is not zero."""
    old = dict(tree_leaves(np_tree(before.params)))
    want, got = dict(tree_leaves(np_tree(ref_state.params))), dict(tree_leaves(state.params))
    moments, updates, unresolved, moving = {}, {}, 0, 0
    for name in ("mu", "nu"):
        moments.update({(name, p): r for p, r in leaf_rels(getattr(ref_state.opt, name), getattr(state.opt, name)).items()})
    got_mu = dict(tree_leaves(state.opt.mu))
    for p, mu in tree_leaves(np_tree(ref_state.opt.mu)):
        keep = np.abs(mu) > RESOLVED * np.abs(mu - got_mu[p].detach().numpy())
        unresolved += int(((mu != 0) & ~keep).sum())
        moving += int((mu != 0).sum())
        du = (want[p] - old[p])[keep]
        updates[p] = float(np.linalg.norm(want[p][keep] - got[p].detach().numpy()[keep]) / (np.linalg.norm(du) + 1e-30))
    return moments, updates, unresolved / max(moving, 1)


def check_train_steps(jcfg, tcfg, batches, *, accum=1, loss_tol=LOSS_TOL) -> None:
    """``make_train_step`` against the reference's jitted step over
    ``batches`` (host batches, one a step; with ``accum > 1`` each stacks
    ``accum`` micro-batches), from the reference's initial state: the
    port's own run keeps the reference's loss and learning rate, and each
    step taken from the reference's state gives its moments, update, step
    and count."""
    ref_state = jtrain.init_train_state(jcfg, KEY)
    state = init_train_state(tcfg, params=tree_from_reference(np_tree(ref_state.params)), device="cpu")
    ref_step = jax.jit(jtrain.make_train_step(jcfg, ref_warmup_cosine(3e-3, 1, 3), accum_steps=accum))
    step = make_train_step(tcfg, warmup_cosine(3e-3, 1, 3), accum_steps=accum)
    for i, b in enumerate(batches):
        before = ref_state
        ref_state, jm = ref_step(ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        state, tm = step(state, b)
        assert rel(jm["loss"], tm["loss"]) <= loss_tol, i
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        synced, sm = step(state_from_reference(before), b)
        assert rel(jm["loss"], sm["loss"]) <= loss_tol, i
        assert int(synced.step) == int(ref_state.step) and int(synced.opt.count) == int(ref_state.opt.count)
        moments, updates, unresolved = step_rels(before, ref_state, synced)
        assert max(moments.values()) <= STEP_MOMENT_TOL, (i, max(moments.items(), key=lambda kv: kv[1]))
        assert max(updates.values()) <= STEP_UPDATE_TOL, (i, max(updates.items(), key=lambda kv: kv[1]))
        assert unresolved <= UNRESOLVED_SHARE, (i, unresolved)
    assert int(state.step) == int(ref_state.step) == len(batches)
    assert all(t.requires_grad for _, t in tree_leaves(state.params))
