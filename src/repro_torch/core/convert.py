"""Carry the reference's state into the port.

The port reads what the JAX package writes, without importing it:

  * :func:`bank_from_arrays` — a device bank from a reference bank's padded
    numpy arrays (``ModelBank.xs/ss/counts``, or ``np.asarray`` of a
    ``JaxModelBank``'s);
  * :func:`store_state_from_reference` / :func:`scheduler_state_from_reference`
    / :func:`fleet_state_from_reference` — a ``SpeedStore.state_dict()`` /
    ``Scheduler.state_dict()`` / ``FleetScheduler.state_dict()`` written by
    the reference, as it is, turned into the port's schema (the same keys;
    the reference's device backend ``"jax"`` becomes ``"torch"``).  The
    port's ``from_state`` constructors run them, so a checkpoint of either
    package continues in the port and both compute the same next rounds.

Energy models (``energy_points``) and the two-level assignment
(``groups``, ``max_group_knots``) carry over as they are.  The reference's
``sharding="shard_map"`` spreads the hierarchy's group blocks over several
devices; the port runs on one card and has no counterpart, so a state that
names it raises ``NotImplementedError`` rather than being dropped.  A
fleet checkpointed with ``pipeline=True`` resumes pipelined, at its
``pipeline_depth``: the reference drains its pipeline before it writes the
state, so nothing in flight is lost.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .modelbank import ModelBank
from .modelbank_torch import TorchModelBank

__all__ = [
    "bank_from_arrays",
    "fleet_state_from_reference",
    "scheduler_state_from_reference",
    "store_state_from_reference",
]


def bank_from_arrays(xs, ss, counts, *, device="cuda", dtype=None) -> TorchModelBank:
    """A :class:`TorchModelBank` from a reference bank's padded arrays
    (``xs``/``ss`` ``[p, k]``, ``counts`` ``[p]``); the monotone flag is
    resolved on the host as the reference does."""
    bank = ModelBank(
        xs=np.array(xs, dtype=np.float64),
        ss=np.array(ss, dtype=np.float64),
        counts=np.array(counts, dtype=np.int64),
    )
    return TorchModelBank.from_bank(bank, device=device, dtype=dtype)


def _backend(name):
    return "torch" if name == "jax" else name


def store_state_from_reference(state: Dict) -> Dict:
    """A ``SpeedStore.state_dict()`` of either package in the port's schema
    (``energy_points`` included)."""
    out = dict(state)
    out["backend"] = _backend(state.get("backend", "numpy"))
    return out


def _refuse_sharding(sharding) -> None:
    if sharding is not None:
        raise NotImplementedError(
            f"sharding={sharding!r} spreads the hierarchy's group blocks "
            "over several devices; the port runs on a single card, whose mesh "
            "(ROADMAP queue 1, item 10f: launch.mesh) has no second device to "
            "split them over"
        )


def scheduler_state_from_reference(state: Dict) -> Dict:
    """A ``Scheduler.state_dict()`` of either package in the port's schema."""
    if state.get("version", 1) != 1:
        raise ValueError(f"unknown scheduler state version {state.get('version')!r}")
    _refuse_sharding(state.get("sharding"))
    out = store_state_from_reference(state)
    out.pop("sharding", None)
    return out


def fleet_state_from_reference(state: Dict) -> Dict:
    """A ``FleetScheduler.state_dict()`` of either package in the port's
    schema: the same keys, ``"jax"`` read as ``"torch"``.  A state that
    names ``sharding`` raises ``NotImplementedError``."""
    if int(state.get("version", 0)) != 1:
        raise ValueError(f"unknown fleet state version {state.get('version')!r}")
    cfg = dict(state["config"])
    _refuse_sharding(cfg.get("sharding"))
    cfg["backend"] = _backend(cfg.get("backend", "numpy"))
    cfg.pop("sharding", None)
    return {**state, "config": cfg}
