"""Dense-layer parameters as plain dictionaries of tensors.

PyTorch counterpart of the JAX package's ``utils/params.py``.  A layer is
``{"w": (in, out), "b": (out,)}`` and computes ``y = x @ w + b`` -- the same
(in, out) weight layout as the JAX pytree, so weights copy across one to
one (``utils.convert.params_from_jax``).  Initialisation is
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases, the
``torch.nn.Linear`` default the JAX package reproduces.

Random numbers are drawn on the CPU from the caller's ``torch.Generator``
and then moved to ``device``, so one seed gives the same weights on every
device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["linear_init", "linear_apply", "mlp_init", "mlp_apply", "param_tree"]


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32, device=None) -> dict:
    """Parameters for a dense layer y = x @ W + b with torch-style init."""
    bound = 1.0 / math.sqrt(in_dim) if in_dim > 0 else 0.0

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return (u * (2.0 * bound) - bound).to(dtype=dtype, device=device)

    return {"w": uniform((in_dim, out_dim)), "b": uniform((out_dim,))}


def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype=torch.float32, device=None) -> list:
    """A stack of dense layers; activations are the caller's business."""
    return [
        linear_init(generator, d_in, d_out, dtype, device)
        for d_in, d_out in zip(dims[:-1], dims[1:])
    ]


def mlp_apply(layers, x: torch.Tensor, activation=torch.relu,
              final_activation: Optional[callable] = None) -> torch.Tensor:
    n = len(layers)
    for i, p in enumerate(layers):
        x = linear_apply(p, x)
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def param_tree(tree):
    """A JAX-layout parameter tree as modules under the same names, so a
    module's ``state_dict`` keys are the tree's paths: a dict of tensors
    becomes an ``nn.ParameterDict``, any other dict an ``nn.ModuleDict``, a
    list an ``nn.ModuleList``."""
    if isinstance(tree, list):
        return nn.ModuleList(param_tree(v) for v in tree)
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(tree)
    return nn.ModuleDict({k: param_tree(v) for k, v in tree.items()})
