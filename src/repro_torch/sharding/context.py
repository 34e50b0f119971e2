"""Ambient activation-sharding context: the port's copy of the reference's
``sharding/context.py``.

The reference's launcher activates a mesh around tracing
(``with activation_sharding(mesh): jax.jit(step).lower(...)``) and its
model pins activations to it with ``maybe_constrain(x, axes)`` — notably
the sequence-sharded residual between scanned blocks (``seq_act ->
model``).  Without an active mesh it is the identity.

On the port every mesh it can build is the one-card mesh ``(1, 1)``
(``launch.mesh``), where a constraint places the whole tensor on the card,
where it already is: ``maybe_constrain`` computes the spec (so a rank
mismatch still raises, as in the reference) and returns the tensor
unchanged.  A mesh with an axis larger than 1 raises ``NotImplementedError``:
the port has no partitioner to honour it.  For the same reason the port's
model has none of the reference's call sites (``attention.py``,
``moe.py``, ``transformer.py``, ``encdec.py``): on every mesh it can build
they are identities.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional, Sequence

from .rules import LOGICAL_RULES, logical_to_pspec

__all__ = ["ACT_RULES", "activation_sharding", "maybe_constrain", "current_activation_mesh"]

_ACT_MESH: ContextVar = ContextVar("repro_torch_activation_mesh", default=None)

# Activation-specific logical axes.
ACT_RULES = dict(LOGICAL_RULES)
ACT_RULES.update({
    "seq_act": ("model",),  # sequence-sharded residual stream between blocks
    "embed_act": (),
})


@contextlib.contextmanager
def activation_sharding(mesh):
    tok = _ACT_MESH.set(mesh)
    try:
        yield
    finally:
        _ACT_MESH.reset(tok)


def current_activation_mesh():
    return _ACT_MESH.get()


def maybe_constrain(x, axes: Sequence[Optional[str]]):
    """``x`` itself: the identity without a mesh and on the one-card mesh
    (after checking ``axes`` against ``x``'s rank as the reference's
    constraint does); raises on a mesh with an axis larger than 1."""
    mesh = _ACT_MESH.get()
    if mesh is None:
        return x
    if any(int(n) > 1 for n in mesh.devices.shape):
        raise NotImplementedError(
            f"an activation constraint over a {'x'.join(str(n) for n in mesh.devices.shape)} mesh: the port "
            "runs on one card and has no partitioner to place activations across devices"
        )
    ps = logical_to_pspec(axes, mesh, tuple(x.shape), rules=ACT_RULES)
    if len(ps) > x.dim():
        raise ValueError(f"sharding spec {ps} has more entries than the rank-{x.dim()} tensor")
    return x
