"""Logical-axis sharding rules and the activation-sharding context: the
port's copy of the reference's ``sharding`` package, for the one-card
mesh of ``launch.mesh``."""

from .context import activation_sharding, current_activation_mesh, maybe_constrain
from .rules import (
    LOGICAL_RULES,
    NamedSharding,
    PartitionSpec,
    batch_pspec,
    logical_to_pspec,
    shardings_for_axes,
    shardings_for_spec,
)

__all__ = [
    "LOGICAL_RULES",
    "NamedSharding",
    "PartitionSpec",
    "activation_sharding",
    "batch_pspec",
    "current_activation_mesh",
    "logical_to_pspec",
    "maybe_constrain",
    "shardings_for_axes",
    "shardings_for_spec",
]
