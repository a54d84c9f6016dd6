"""ODE-RNN baseline (Latent-ODE style).

PyTorch counterpart of the JAX package's ``models/odernn.py``: per
observation, evolve the hidden state with an ODE over the preceding gap
(``ops.solvers.odeint`` over [0, dt]), then update it with a GRU/RNN cell.

The gaps are host floats: ``times`` is a host array (numpy or a CPU
tensor, default 0..L-1) and each step's span is built on the host, so a
forward on the card reads nothing back per observation.

The reference's indexing quirk is kept for numeric parity: its loop uses
``dts[i-1]`` at i=0, i.e. the *last* gap is applied before the first
observation.  With uniform times this is invisible; set
``replicate_dt_quirk=False`` for the intended zero-width first gap.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from online_neural_cdes_tpu_torch.models.rnn import (
    _gru_update,
    _rnn_update,
    gru_cell_init,
    rnn_cell_init,
)
from online_neural_cdes_tpu_torch.ops.solvers import _NUMPY, odeint
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.params import (
    linear_apply,
    linear_init,
    mlp_apply,
    mlp_init,
    param_tree,
)

__all__ = ["ODERNN"]


class ODERNN(nn.Module):
    """Parameters ``ode_net`` (H -> HH [-> HH ...], ReLU between layers,
    tanh after the last), ``ode_out`` (HH -> H), ``cell`` and ``final``
    under the JAX pytree's names, made from ``generator`` on ``device`` (the
    CUDA card unless ``device="cpu"``).  ``adjoint`` is kept as a field of
    the JAX model, which does not use it either: gradients run through the
    solver's steps."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 hidden_hidden_dim: int = 30, num_layers: int = 1, solver: str = "rk4",
                 adjoint: bool = False, gru: bool = True, return_sequences: bool = False,
                 apply_final_linear: bool = True, replicate_dt_quirk: bool = True, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim, self.hidden_dim, self.output_dim = input_dim, hidden_dim, output_dim
        self.hidden_hidden_dim = hidden_hidden_dim
        self.num_layers = num_layers
        self.solver = solver
        self.adjoint = adjoint
        self.gru = gru
        self.return_sequences = return_sequences
        self.apply_final_linear = apply_final_linear
        self.replicate_dt_quirk = replicate_dt_quirk
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [hidden_dim] + [hidden_hidden_dim] * max(num_layers, 1)
        self.ode_net = param_tree(mlp_init(generator, dims, dtype, device))
        self.ode_out = nn.ParameterDict(
            linear_init(generator, hidden_hidden_dim, hidden_dim, dtype, device))
        cell_init = gru_cell_init if gru else rnn_cell_init
        self.cell = param_tree(cell_init(generator, input_dim, hidden_dim, dtype, device))
        if apply_final_linear:
            self.final = nn.ParameterDict(
                linear_init(generator, hidden_dim, output_dim, dtype, device))

    @property
    def device(self) -> torch.device:
        return self.ode_out["w"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.ode_out["w"].dtype

    def _ode_weights(self) -> dict:
        """The ODE's weights as plain nested dicts and lists, handed to the
        solve as its ``args`` (a wave's solve batches them over its lanes)."""
        return {"net": [{"w": layer["w"], "b": layer["b"]} for layer in self.ode_net],
                "out": {"w": self.ode_out["w"], "b": self.ode_out["b"]}}

    @staticmethod
    def _ode_func(t, h, weights):
        return linear_apply(weights["out"], mlp_apply(weights["net"], h,
                                                      final_activation=torch.tanh))

    def step_gaps(self, length: int, times=None, dtype=np.float32) -> np.ndarray:
        """The ODE's span before each of the ``length`` observations, on the
        host: the quirk's [dts[-1], dts[0], ..., dts[L-2]], or [0, dts...]."""
        if times is None:
            times = np.arange(length, dtype=dtype)
        elif isinstance(times, torch.Tensor):
            times = times.detach().cpu().numpy()
        times = np.asarray(times, dtype=dtype)
        dts = times[1:] - times[:-1]
        first = dts[-1:] if self.replicate_dt_quirk else np.zeros(1, dtype)
        return np.concatenate([first, dts])

    def forward(self, x: torch.Tensor, times=None) -> torch.Tensor:
        """x: (..., L, C); times: (L,) host times, defaulting to 0..L-1."""
        np_dtype = _NUMPY.get(x.dtype, np.float32)
        gaps = self.step_gaps(x.shape[-2], times, np_dtype)
        update = _gru_update if self.gru else _rnn_update
        gi = linear_apply(self.cell["ih"], x)            # every step's input projection
        h = torch.zeros(x.shape[:-2] + (self.hidden_dim,), dtype=x.dtype, device=x.device)
        hs = []
        weights = self._ode_weights()
        for i, dt in enumerate(gaps):
            span = np.array([0.0, dt], dtype=np_dtype)
            h = odeint(self._ode_func, h, span, weights, method=self.solver)[-1]
            h = update(gi[..., i, :], self.cell, h)
            hs.append(h)
        out = torch.stack(hs, dim=-2) if self.return_sequences else h
        return linear_apply(self.final, out) if self.apply_final_linear else out
