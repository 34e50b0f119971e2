"""Parameter specs, their initialisation and their modules (``params.py``),
and the carry of the reference's parameter trees into the port's modules
(``convert.py``)."""

from .convert import params_from_reference, unstack_tree
from .params import ParamSpec, ParamTree, init_tree, param_count, tree_leaves

__all__ = [
    "ParamSpec",
    "ParamTree",
    "init_tree",
    "param_count",
    "params_from_reference",
    "tree_leaves",
    "unstack_tree",
]
