"""Neural CDE vector fields.

PyTorch counterpart of the JAX package's ``models/vector_fields.py``: the
shared H -> HH MLP trunk (a ReLU after every layer) with one output head
per kind -- ``original`` (tanh), ``minimal`` and ``gru`` (sigmoid-gated
tanh), ``sparse`` (a masked dense head) and ``low-rank`` (a product of two
thin heads).  ``apply`` returns the (..., H, I) field matrix for
``vector_field_type="matmul"`` and (..., H) for ``"evaluate"`` and
``"derivative"``, whose trunk reads the state concatenated with the
control's value or derivative (H + I inputs).

The module holds its tensors under the JAX pytree's names (``trunk``,
``out``, ``sig``, ``tanh``, ``reset``, ``m_h``, ``m_o``), so its
``state_dict`` keys are the pytree's paths.  The sparse kind's 0/1
connectivity ``mask`` is a persistent buffer: it is in the ``state_dict``
(``params_from_jax`` loads it) and the optimizer never sees it, as JAX's
Adam sees a zero gradient behind its ``stop_gradient``.
"""

from __future__ import annotations

import math
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
    """f_theta: hidden state (..., H) -> field matrix (..., H, I), or
    (..., H + I) -> (..., H) for the ``evaluate``/``derivative`` types."""

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
        if kind in ("sparse", "low-rank"):
            if sparsity is None:
                raise ValueError(
                    f"vector field {kind!r} requires sparsity= "
                    "(reference: 'sparse methods must have a sparsity!')"
                )
            if vector_field_type != "matmul":
                raise ValueError(f"vector field {kind!r} takes vector_field_type='matmul' only")
        if kind in ("gru", "minimal") and sparsity is not None:
            raise ValueError("sparsity not implemented for gated methods")
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.hidden_hidden_dim = hidden_hidden_dim
        self.num_layers = num_layers
        self.sparsity = sparsity
        self.vector_field_type = vector_field_type
        self.kind = kind

        def linear(d_in, d_out):
            return nn.ParameterDict(linear_init(generator, d_in, d_out, dtype, device))

        self.trunk = nn.ModuleList(
            nn.ParameterDict(layer)
            for layer in mlp_init(generator, self.trunk_dims(), dtype, device)
        )
        hh, out = hidden_hidden_dim, self.output_dim
        if kind in ("original", "sparse"):
            self.out = linear(hh, out)
        elif kind == "minimal":
            self.sig, self.tanh = linear(hh, out), linear(hh, out)
        elif kind == "gru":
            self.reset = linear(self.initial_dim, self.initial_dim)
            self.sig, self.tanh = linear(hh, out), linear(hh, out)
        else:  # low-rank
            self.m_h = linear(hh, hidden_dim * self.rank)
            self.m_o = linear(hh, self.rank * input_dim)
        if kind == "sparse":
            # Static connectivity with the requested density (the masked
            # dense analogue of the reference's sparse layers).
            keep = torch.rand((hh, out), generator=generator, dtype=torch.float64) >= sparsity
            self.register_buffer("mask", keep.to(dtype=dtype, device=device))

    @property
    def matmul(self) -> bool:
        return self.vector_field_type == "matmul"

    @property
    def initial_dim(self) -> int:
        return self.hidden_dim if self.matmul else self.hidden_dim + self.input_dim

    @property
    def output_dim(self) -> int:
        return self.hidden_dim * self.input_dim if self.matmul else self.hidden_dim

    @property
    def rank(self) -> int:
        return int(math.ceil(self.input_dim * (1.0 - self.sparsity)))

    def trunk_dims(self):
        return [self.initial_dim] + [self.hidden_hidden_dim] * max(self.num_layers, 1)

    @property
    def params(self) -> dict:
        """The tensors as the JAX pytree lays them out, in plain dicts and
        lists (``{"trunk": [{"w", "b"}, ...], "out": {"w", "b"}, ...}``):
        the ``args`` a solver carries to :meth:`apply`."""
        tree = {"trunk": [{"w": layer["w"], "b": layer["b"]} for layer in self.trunk]}
        for name in ("out", "sig", "tanh", "reset", "m_h", "m_o"):
            if hasattr(self, name):
                p = getattr(self, name)
                tree[name] = {"w": p["w"], "b": p["b"]}
        if self.kind == "sparse":
            tree["mask"] = self.mask
        return tree

    def _head(self, params, h):
        def trunk(x):
            return mlp_apply(params["trunk"], x, final_activation=torch.relu)

        if self.kind == "original":
            return torch.tanh(linear_apply(params["out"], trunk(h)))
        if self.kind == "minimal":
            u = trunk(h)
            return (torch.sigmoid(linear_apply(params["sig"], u))
                    * torch.tanh(linear_apply(params["tanh"], u)))
        if self.kind == "gru":
            inner = trunk(h)
            reset = trunk(torch.sigmoid(linear_apply(params["reset"], h)) * h)
            return (torch.sigmoid(linear_apply(params["sig"], inner))
                    * torch.tanh(linear_apply(params["tanh"], reset)))
        u = trunk(h)
        if self.kind == "sparse":
            p = params["out"]
            # The mask takes no gradient (JAX's stop_gradient).
            return torch.tanh(u @ (p["w"] * params["mask"].detach().to(p["w"].dtype))
                              + p["b"])
        m_h = linear_apply(params["m_h"], u).reshape(u.shape[:-1] + (self.hidden_dim,
                                                                    self.rank))
        m_o = linear_apply(params["m_o"], u).reshape(u.shape[:-1] + (self.rank,
                                                                    self.input_dim))
        return torch.tanh(m_h @ m_o)

    def apply(self, params: dict, t, h: torch.Tensor) -> torch.Tensor:
        """The field at ``h`` with the tensors ``params`` (laid out as
        :attr:`params`), so a solver can differentiate through them."""
        del t
        out = self._head(params, h)
        if self.matmul and self.kind != "low-rank":
            out = out.reshape(h.shape[:-1] + (self.hidden_dim, self.input_dim))
        return out

    def forward(self, t, h: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, t, h)
