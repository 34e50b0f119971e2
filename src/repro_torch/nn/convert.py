"""Carry a reference parameter tree into the port's module names.

The reference keeps the repeated layers stacked: ``tree["units"][s]`` holds
pattern slot ``s`` of every unit, each leaf with a leading ``num_units``
axis.  The port's ``LanguageModel`` keeps one module per layer, named by
the layer's depth: unit ``u``, slot ``s`` is ``layers.<len(prefix) +
u * len(pattern) + s>``.  ``prefix``, ``embed``, ``final_norm`` and
``head`` keep the reference's names.  The unstacked tensors are views of
the stacked ones (no copy).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict

import numpy as np
import torch

from .params import tree_leaves

if TYPE_CHECKING:  # models/ imports nn/; the config is only a type here
    from ..models.config import ModelConfig

__all__ = ["params_from_reference", "unstack_tree"]


def _flat(prefix: str, node, out: Dict[str, torch.Tensor]) -> None:
    for path, leaf in tree_leaves(node):
        out[".".join([prefix, *map(str, path)])] = leaf


def unstack_tree(tree: Dict, cfg: "ModelConfig") -> Dict[str, torch.Tensor]:
    """A parameter tree of the reference's structure (tensors) as the
    ``state_dict`` of the port's ``LanguageModel``."""
    out: Dict[str, torch.Tensor] = {}
    _flat("embed", tree["embed"], out)
    for i, block in enumerate(tree["prefix"]):
        _flat(f"prefix.{i}", block, out)
    n_pre, n_slots = len(cfg.prefix), len(cfg.pattern)
    for s, slot in enumerate(tree["units"]):
        for path, leaf in tree_leaves(slot):
            if leaf.shape[0] != cfg.num_units:
                raise ValueError(f"units[{s}]{list(path)}: leading axis {leaf.shape[0]} != {cfg.num_units} units")
            for u in range(cfg.num_units):
                name = ".".join(["layers", str(n_pre + u * n_slots + s), *map(str, path)])
                out[name] = leaf[u]
    _flat("final_norm", tree["final_norm"], out)
    if "head" in tree:
        out["head"] = tree["head"]
    return out


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: through float32, exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_reference(np_tree: Dict, cfg: "ModelConfig") -> Dict[str, torch.Tensor]:
    """The reference's parameter tree, its leaves as numpy arrays (for
    example ``jax.tree_util.tree_map(np.asarray, params)``), as the port
    model's ``state_dict`` on the CPU, dtypes kept."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return _to_tensor(node)

    return unstack_tree(conv(np_tree), cfg)
