"""Neural CDE vector fields.

PyTorch counterpart of the JAX package's ``models/vector_fields.py`` for
``kind="original"`` with ``vector_field_type="matmul"``: an H -> HH MLP
trunk with a ReLU after every layer, then a tanh head reshaped to
(..., H, I).  The module holds ``trunk`` (a list of ``{"w", "b"}`` layers)
and ``out`` under the JAX pytree's names.  The gated, sparse and low-rank
kinds and the ``evaluate``/``derivative`` field types come with a later
slice (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from online_neural_cdes_tpu_torch.utils.params import (
    linear_apply,
    linear_init,
    mlp_apply,
    mlp_init,
)

__all__ = ["VectorField", "VECTOR_FIELDS"]

VECTOR_FIELDS = ("original", "gru", "minimal", "sparse", "low-rank")


class VectorField(nn.Module):
    """f_theta: hidden state (..., H) -> field matrix (..., H, I)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 hidden_hidden_dim: int = 15, num_layers: int = 1,
                 sparsity: Optional[float] = None,
                 vector_field_type: str = "matmul", kind: str = "original",
                 *, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        super().__init__()
        if kind not in VECTOR_FIELDS:
            raise ValueError(
                f"unknown vector field {kind!r}; one of {sorted(VECTOR_FIELDS)}"
            )
        if vector_field_type not in ("matmul", "evaluate", "derivative"):
            raise ValueError(
                f"unknown vector_field_type {vector_field_type!r}; one of "
                "(matmul, evaluate, derivative)"
            )
        if kind != "original" or vector_field_type != "matmul" or sparsity is not None:
            raise NotImplementedError(
                f"vector field kind={kind!r}, vector_field_type="
                f"{vector_field_type!r}, sparsity={sparsity!r} is not ported "
                "yet (ROADMAP item 14: the rest of the model zoo)"
            )
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.hidden_hidden_dim = hidden_hidden_dim
        self.num_layers = num_layers
        self.sparsity = sparsity
        self.vector_field_type = vector_field_type
        self.kind = kind
        self.trunk = nn.ModuleList(
            nn.ParameterDict(layer)
            for layer in mlp_init(generator, self.trunk_dims(), dtype, device)
        )
        self.out = nn.ParameterDict(
            linear_init(generator, hidden_hidden_dim, self.output_dim, dtype, device)
        )

    @property
    def initial_dim(self) -> int:
        return self.hidden_dim

    @property
    def output_dim(self) -> int:
        return self.hidden_dim * self.input_dim

    def trunk_dims(self):
        return [self.initial_dim] + [self.hidden_hidden_dim] * max(self.num_layers, 1)

    @property
    def params(self) -> dict:
        """The parameters as the JAX pytree lays them out:
        ``{"trunk": [{"w", "b"}, ...], "out": {"w", "b"}}``."""
        return {"trunk": list(self.trunk), "out": self.out}

    def forward(self, t, h: torch.Tensor) -> torch.Tensor:
        # ReLU after every trunk layer, including the last.
        u = mlp_apply(self.trunk, h, final_activation=torch.relu)
        out = torch.tanh(linear_apply(self.out, u))
        return out.reshape(h.shape[:-1] + (self.hidden_dim, self.input_dim))
