"""Tensor leaves of nested containers.

The port's counterpart of the JAX pytree flattening that its solvers rely
on: dicts (keys in their order), lists and tuples recurse; an object whose
class names ``tree_fields`` (the splines: the JAX dataclass's pytree
fields, in their order) recurses into those attributes; a tensor is a
leaf; anything else (None, a number) is kept as it is.  ``map_arrays``
maps the numpy arrays and tensors of nested dicts, lists and tuples.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

__all__ = ["flatten", "map_arrays"]


def map_arrays(tree, fn):
    """``tree`` with ``fn`` applied to each numpy array and tensor of its
    nested dicts, lists and tuples; other leaves are kept as they are."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_arrays(v, fn) for v in tree)
    return tree


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
