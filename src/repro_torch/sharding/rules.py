"""Logical-axis -> mesh-axis sharding rules (MaxText-style) with
divisibility fallback: the port's copy of the reference's
``sharding/rules.py``.

Parameters and activations carry *logical* axis names
(``repro_torch.nn.ParamSpec``); this module maps them onto a mesh:

  * ``batch``  -> ("pod", "data")   — data parallelism across pods & slices;
  * ``embed``  -> ("data",)         — FSDP / ZeRO-3 parameter sharding;
  * ``heads/kv_heads/mlp/vocab/experts/rnn`` -> ("model",) — tensor/expert
    parallelism;
  * everything else replicated.

Fallbacks keep every (arch x mesh) cell placeable instead of failing:
  1. a mesh axis already used by an earlier dim of the same tensor is
     skipped (e.g. MoE ``wi: (experts, embed, mlp)`` — ``experts`` takes
     ``model``, so ``mlp`` replicates);
  2. a mesh axis whose size does not divide the dim is dropped (granite's
     kv=1 MQA replicates KV heads instead of failing on model=16).

The rules read only a mesh's ``axis_names`` and ``devices.shape`` (any
``launch.mesh.Mesh``, or a stand-in with those two fields), so for any
mesh they give what the reference's give.  ``PartitionSpec`` is a tuple
(one entry a dim: ``None``, a mesh axis, or a tuple of mesh axes; trailing
``None`` dropped) and ``NamedSharding`` pairs it with its mesh.  On the
port's one-card mesh (``launch.mesh.make_production_mesh``) every axis has
size 1, so every sharding places the whole tensor on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ..nn.params import ParamSpec, tree_map

__all__ = [
    "LOGICAL_RULES",
    "NamedSharding",
    "PartitionSpec",
    "batch_pspec",
    "logical_to_pspec",
    "shardings_for_axes",
    "shardings_for_spec",
]

LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "rnn": ("model",),
    "seq": (),  # sequence parallelism is opt-in via override rules
    "seq_kv": ("model",),  # KV-cache sequence sharding (MLA / MQA decode)
    "lora": (),
    "head_dim": (),
    "layers": (),
    "stack": (),
    "conv": (),
    "null": (),
}


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: a tuple of per-dim entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a mesh."""

    mesh: Any
    spec: PartitionSpec

    def split_axes(self) -> Dict[str, int]:
        """The mesh axes of size > 1 the spec splits a dim over, with
        their sizes."""
        sizes = _mesh_axis_sizes(self.mesh)
        out = {}
        for entry in self.spec:
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                if sizes[a] > 1:
                    out[a] = sizes[a]
        return out


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def logical_to_pspec(
    axes: Sequence[Optional[str]],
    mesh,
    shape: Optional[Sequence[int]] = None,
    rules: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> PartitionSpec:
    """Map logical axes -> PartitionSpec under ``mesh`` with fallbacks."""
    rules = rules or LOGICAL_RULES
    sizes = _mesh_axis_sizes(mesh)
    used: set = set()
    out = []
    for i, name in enumerate(axes):
        entry: Tuple[str, ...] = ()
        if name is not None and name != "null":
            entry = tuple(a for a in rules.get(name, ()) if a in sizes)
        # fallback 1: drop already-used mesh axes
        entry = tuple(a for a in entry if a not in used)
        # fallback 2: divisibility — drop trailing axes until they divide
        if shape is not None and entry:
            dim = shape[i]
            while entry:
                prod = 1
                for a in entry:
                    prod *= sizes[a]
                if dim % prod == 0:
                    break
                entry = entry[:-1]
        used.update(entry)
        if len(entry) == 0:
            out.append(None)
        elif len(entry) == 1:
            out.append(entry[0])
        else:
            out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def batch_pspec(mesh, batch: Optional[int] = None) -> PartitionSpec:
    """PartitionSpec for a leading-batch tensor under ``mesh``."""
    return logical_to_pspec(("batch",), mesh, (batch,) if batch else None)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(a is None or isinstance(a, str) for a in x)


def _map_axes(fn: Callable, tree, shapes=None):
    """``fn(axes, shape_leaf)`` at every axes tuple of ``tree`` (dicts,
    lists, tuples and NamedTuples of them), ``shapes`` walked alongside
    when given; the structure kept."""
    if _is_axes(tree):
        return fn(tree, shapes)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v, shapes[k] if shapes is not None else None) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        kids = [_map_axes(fn, v, shapes[i] if shapes is not None else None) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return type(tree)(kids)
    raise TypeError(f"not an axes tree node: {type(tree).__name__}")


def shardings_for_axes(axes_tree_, mesh, shapes_tree=None, rules=None):
    """Tree of logical-axes tuples -> tree of NamedShardings (with the
    divisibility fallback when ``shapes_tree``, a tree of tensors, specs or
    shape tuples of the same structure, is given)."""

    def one(axes, s):
        shape = None if s is None else (s.shape if hasattr(s, "shape") else s)
        return NamedSharding(mesh, logical_to_pspec(axes, mesh, shape, rules))

    return _map_axes(one, axes_tree_, shapes_tree)


def shardings_for_spec(spec_tree, mesh, rules=None):
    """ParamSpec tree -> NamedSharding tree (shape-aware fallback)."""

    def one(leaf: ParamSpec):
        return NamedSharding(mesh, logical_to_pspec(leaf.axes, mesh, leaf.shape, rules))

    return tree_map(one, spec_tree)
