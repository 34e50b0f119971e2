"""Minimal parameter-spec system, the port's copy of the reference's
``nn/params.py``.

A model is described by a *spec tree*: nested dicts and tuples whose leaves
are ``ParamSpec`` (shape, logical axes, dtype, initialiser).  The shapes,
initialisers and the fan-in rule for stacked layers are the reference's;
the random numbers come from a ``torch.Generator`` and are not the
reference's (a test that needs equal weights carries them over with
``nn.convert.params_from_reference``).

``axes_tree`` and ``spec_tree_shapes`` (sharding, the dry run) come later
(ROADMAP queue 1, item 10: what remains of the LLM stack).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["ParamSpec", "ParamTree", "init_tree", "param_count", "tree_leaves", "tree_map"]

_STACK_AXES = ("layers", "stack", "experts")


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim ('null'/None = replicated)
    dtype: Any = torch.float32
    init: str = "fan_in"  # fan_in | normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank mismatch")

    def stddev(self) -> Optional[float]:
        """The normal initialiser's standard deviation, or None for the
        constant initialisers.  ``fan_in``: leading stacked axes
        (``layers``/``stack``/``experts``, keeping at least two dims) are not
        fan-in; the fan-in is the product of the remaining dims but the
        last (the reference's rule, ``nn/params.py:71-77``)."""
        if self.init in ("zeros", "ones"):
            return None
        if self.init in ("normal", "scaled"):
            return self.scale
        if self.init == "fan_in":
            fan_in = self.shape[0] if len(self.shape) >= 2 else max(self.shape[0], 1)
            skip = 0
            for ax in self.axes:
                if ax in _STACK_AXES and skip < len(self.shape) - 2:
                    skip += 1
                else:
                    break
            if len(self.shape) - skip >= 2:
                fan_in = int(np.prod(self.shape[skip:-1]))
            return self.scale / math.sqrt(max(fan_in, 1))
        raise ValueError(f"unknown init {self.init}")

    def materialize(self, generator: torch.Generator, device) -> torch.Tensor:
        std = self.stddev()
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(std).to(self.dtype)


def tree_leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` over a tree of dicts and tuples/lists, dict keys
    sorted (the reference's flatten order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_tree(spec: Dict, generator: torch.Generator, device="cuda") -> Dict:
    """Materialise a spec tree into a tree of tensors on ``device``, one
    draw from ``generator`` per random leaf in flatten order (the generator
    must live on ``device``)."""
    from ..core.modelbank_torch import resolve_device

    dev = resolve_device(device)
    values = {path: leaf.materialize(generator, dev) for path, leaf in tree_leaves(spec)}

    def build(node, path=()):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(build(v, path + (i,)) for i, v in enumerate(node))
        return values[path]

    return build(spec)


def param_count(spec: Dict) -> int:
    return sum(int(np.prod(leaf.shape)) for _, leaf in tree_leaves(spec))


class ParamTree(torch.nn.Module):
    """A spec dict as an ``nn.Module``: each key becomes a parameter (a
    ``ParamSpec``) or a submodule (a nested dict), under the reference's
    tree key, so that ``state_dict`` names mirror the reference's paths.
    Parameters start on the ``meta`` device, without storage, and take
    real tensors through ``load_state_dict(..., assign=True)``.  Indexing
    (``tree["wq"]``, ``"bias" in tree``) reads like the reference's dicts,
    so the functional ``apply_*`` code takes either."""

    def __init__(self, spec: Dict):
        super().__init__()
        for key, val in spec.items():
            if isinstance(val, ParamSpec):
                empty = torch.empty(val.shape, dtype=val.dtype, device="meta")
                self.register_parameter(key, torch.nn.Parameter(empty, requires_grad=False))
            elif isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                raise TypeError(f"spec key {key!r}: expected a ParamSpec or a dict, got {type(val)}")

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules
