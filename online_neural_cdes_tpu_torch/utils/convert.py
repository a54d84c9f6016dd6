"""Carry a JAX parameter pytree across to the port.

The JAX ``NeuralCDE.init`` returns ``{"field": {"trunk": [{"w", "b"}, ...],
"out": {"w", "b"}}, "initial": {"w", "b"}, "final": {"w", "b"}}``.  The
port's ``NeuralCDE`` holds the same tensors under the same names, so its
``state_dict`` keys are the pytree's paths joined with dots
(``field.trunk.0.w``, ``initial.b``, ...).  Both sides use the (in, out)
weight layout: values copy as they are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "flatten_tree"]


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists of arrays -> {dotted path: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def params_from_jax(np_tree, model: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX parameter pytree (leaves as numpy arrays, or anything
    ``np.asarray`` takes) into ``model`` in place and return it.  Every
    parameter of the model must be present with its exact shape; values are
    cast to the model's dtype and device."""
    flat = flatten_tree(np_tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(
            f"parameter trees differ: missing {missing}, unexpected {extra}"
        )
    state = {}
    for key, ref in own.items():
        value = np.asarray(flat[key])
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(
                f"{key}: JAX shape {value.shape} != port shape {tuple(ref.shape)}"
            )
        state[key] = torch.tensor(value, dtype=ref.dtype, device=ref.device)
    model.load_state_dict(state)
    return model
