"""Parameter specs, their initialisation and their modules (``params.py``),
and the carry of parameter trees between the reference's stacked layout and
the port's modules (``convert.py``)."""

from .convert import params_from_reference, stack_tree, to_numpy, tree_from_reference, unstack_tree
from .params import ParamSpec, ParamTree, axes_tree, init_tree, param_count, spec_tree_shapes, tree_leaves, tree_map

__all__ = [
    "ParamSpec",
    "ParamTree",
    "axes_tree",
    "init_tree",
    "param_count",
    "params_from_reference",
    "spec_tree_shapes",
    "stack_tree",
    "to_numpy",
    "tree_from_reference",
    "tree_leaves",
    "tree_map",
    "unstack_tree",
]
