"""Carry the reference's state into the port.

The port reads what the JAX package writes, without importing it:

  * :func:`bank_from_arrays` — a device bank from a reference bank's padded
    numpy arrays (``ModelBank.xs/ss/counts``, or ``np.asarray`` of a
    ``JaxModelBank``'s);
  * :func:`store_state_from_reference` / :func:`scheduler_state_from_reference`
    — a ``SpeedStore.state_dict()`` / ``Scheduler.state_dict()`` written by
    the reference, as it is, turned into the port's schema (the same keys;
    the reference's device backend ``"jax"`` becomes ``"torch"``).  The
    port's ``from_state`` constructors run them, so a checkpoint of either
    package continues in the port and both compute the same next rounds.

State of features the port does not have yet (groups of the two-level path,
energy models) raises ``NotImplementedError`` rather than being dropped.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .modelbank import ModelBank
from .modelbank_torch import TorchModelBank

__all__ = [
    "bank_from_arrays",
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
    """A ``SpeedStore.state_dict()`` of either package in the port's schema."""
    if state.get("energy_points"):
        raise NotImplementedError(
            "energy models come with the energy slice of the port (core/energy.py)"
        )
    out = dict(state)
    out["backend"] = _backend(state.get("backend", "numpy"))
    return out


def scheduler_state_from_reference(state: Dict) -> Dict:
    """A ``Scheduler.state_dict()`` of either package in the port's schema."""
    if state.get("version", 1) != 1:
        raise ValueError(f"unknown scheduler state version {state.get('version')!r}")
    if state.get("groups") is not None:
        raise NotImplementedError(
            "groups= comes with the hierarchy slice of the port (core/hierarchy.py)"
        )
    return store_state_from_reference(state)
