"""Carry a reference parameter tree into the port's module names, and back.

The reference keeps the repeated layers stacked: ``tree["units"][s]`` holds
pattern slot ``s`` of every unit, each leaf with a leading ``num_units``
axis.  The port's ``LanguageModel`` keeps one module per layer, named by
the layer's depth: unit ``u``, slot ``s`` is ``layers.<len(prefix) +
u * len(pattern) + s>``.  ``prefix``, ``embed``, ``final_norm`` and
``head`` keep the reference's names.  The encoder-decoder's tree stacks
each half's units (``encoder.units``, ``decoder.units``): they become
``encoder.layers.<u * len(encoder_pattern) + s>`` and
``decoder.layers.<u * len(pattern) + s>`` (``models.encdec``), and its
other leaves keep their names.  The unstacked tensors are views of
the stacked ones (no copy).  :func:`stack_tree` is the inverse: the port's
``state_dict`` (or any dict shaped like it: gradients, AdamW moments) back
in the reference's stacked layout, as numpy arrays.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch

from .params import tree_leaves

if TYPE_CHECKING:  # models/ imports nn/; the config is only a type here
    from ..models.config import ModelConfig

__all__ = ["params_from_reference", "stack_tree", "to_numpy", "tree_from_reference", "unstack_tree"]


def _stack_of(path) -> Optional[Tuple[str, ...]]:
    """Where the stacked ``units`` holding a leaf lie: ``()`` for a decoder
    LM's, ``("encoder",)`` or ``("decoder",)`` for an encoder-decoder's;
    None for a leaf outside them."""
    if path[0] == "units":
        return ()
    if len(path) > 1 and path[0] in ("encoder", "decoder") and path[1] == "units":
        return (path[0],)
    return None


def _layout(cfg: "ModelConfig", head: Tuple[str, ...]) -> Tuple[int, int, int]:
    """(index of the first stacked layer, slots, units) of ``head``'s units."""
    if head == ("encoder",):
        return 0, len(cfg.encoder_pattern), cfg.encoder_layers // len(cfg.encoder_pattern)
    if head == ("decoder",):
        return 0, len(cfg.pattern), cfg.num_units
    return len(cfg.prefix), len(cfg.pattern), cfg.num_units


def _layer_name(cfg: "ModelConfig", path) -> list:
    """The port's names of one leaf of the reference's tree: one name, or
    one a unit for a leaf under stacked ``units``."""
    head = _stack_of(path)
    if head is None:
        return [".".join(map(str, path))]
    first, n_slots, n_units = _layout(cfg, head)
    s, rest = path[len(head) + 1], path[len(head) + 2:]
    return [".".join([*head, "layers", str(first + u * n_slots + s), *map(str, rest)]) for u in range(n_units)]


def unstack_tree(tree: Dict, cfg: "ModelConfig") -> Dict[str, torch.Tensor]:
    """A parameter tree of the reference's structure (tensors) as the
    ``state_dict`` of the port's ``LanguageModel`` (or ``EncoderDecoder``)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in tree_leaves(tree):
        names = _layer_name(cfg, path)
        if _stack_of(path) is None:
            out[names[0]] = leaf
            continue
        if leaf.shape[0] != len(names):
            raise ValueError(f"{list(path)}: leading axis {leaf.shape[0]} != {len(names)} units")
        out.update({name: leaf[u] for u, name in enumerate(names)})
    return out


def to_numpy(t) -> np.ndarray:
    """A tensor as a numpy array on the host, bit for bit; bfloat16 as
    ``ml_dtypes.bfloat16`` where that package is installed, else float32
    (exact)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.to(torch.float32).numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def stack_tree(flat: Dict[str, torch.Tensor], cfg: "ModelConfig", *, numpy: bool = True) -> Dict:
    """The inverse of :func:`unstack_tree`: a dict under the port's
    ``state_dict`` names (parameters, gradients, AdamW moments) as the
    reference's tree, ``units`` stacked along a leading ``num_units`` axis,
    every leaf a numpy array (:func:`to_numpy`), or, with ``numpy=False``,
    a tensor on the leaves' device (a copy)."""
    from ..models.encdec import encdec_spec  # models/ imports nn/
    from ..models.transformer import lm_spec

    spec = encdec_spec(cfg) if cfg.is_encdec else lm_spec(cfg)
    names = {path: _layer_name(cfg, path) for path, _ in tree_leaves(spec)}
    want = {n for ns in names.values() for n in ns}
    if set(flat) != want:
        raise KeyError(f"names differ from {cfg.name}'s: missing {sorted(want - set(flat))[:5]}, "
                       f"unexpected {sorted(set(flat) - want)[:5]}")

    def build(node, path=()):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(build(v, path + (i,)) for i, v in enumerate(node))
        if not numpy:
            ts = [flat[n].detach() for n in names[path]]
            return torch.stack(ts) if _stack_of(path) is not None else ts[0].clone()
        arrays = [to_numpy(flat[n]) for n in names[path]]
        return np.stack(arrays) if _stack_of(path) is not None else arrays[0]

    return build(spec)


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: through float32, exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tree_from_reference(np_tree):
    """A tree of numpy arrays (dicts and tuples, the reference's layout
    kept) as the same tree of CPU tensors, dtypes kept."""
    if isinstance(np_tree, dict):
        return {k: tree_from_reference(v) for k, v in np_tree.items()}
    if isinstance(np_tree, (tuple, list)):
        return tuple(tree_from_reference(v) for v in np_tree)
    return _to_tensor(np_tree)


def params_from_reference(np_tree: Dict, cfg: "ModelConfig") -> Dict[str, torch.Tensor]:
    """The reference's parameter tree, its leaves as numpy arrays (for
    example ``jax.tree_util.tree_map(np.asarray, params)``), as the port
    model's ``state_dict`` on the CPU, dtypes kept."""
    return unstack_tree(tree_from_reference(np_tree), cfg)
