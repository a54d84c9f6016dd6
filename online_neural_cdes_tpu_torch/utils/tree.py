"""Tensor leaves of nested containers.

The port's counterpart of the JAX pytree flattening that its solvers rely
on: dicts (keys in their order), lists and tuples recurse; an object whose
class names ``tree_fields`` (the splines: the JAX dataclass's pytree
fields, in their order) recurses into those attributes; a tensor is a
leaf; anything else (None, a number) is kept as it is.
"""

from __future__ import annotations

import copy

import torch

__all__ = ["flatten"]


def flatten(tree):
    """``(leaves, rebuild)``: the tensor leaves of ``tree`` and a function
    that rebuilds the tree from a list of new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    fields = getattr(type(tree), "tree_fields", None)
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        parts = [flatten(v) for v in tree]
    elif fields is not None:
        parts = [flatten(getattr(tree, f)) for f in fields]
    else:
        return [], lambda leaves: tree
    sizes = [len(p[0]) for p in parts]
    leaves = [t for p in parts for t in p[0]]

    def rebuild(new):
        out, pos = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(new[pos:pos + n]))
            pos += n
        if isinstance(tree, dict):
            return dict(zip(keys, out))
        if isinstance(tree, (list, tuple)):
            return type(tree)(out)
        obj = copy.copy(tree)
        for f, v in zip(fields, out):
            setattr(obj, f, v)
        return obj

    return leaves, rebuild
