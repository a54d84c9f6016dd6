"""Recurrent cells and the plain GRU baseline.

PyTorch counterpart of the JAX package's ``models/rnn.py``: the GRU cell in
``torch.nn.GRUCell``'s arithmetic (gates r, z, n, separate input and
hidden biases, the reset applied to the hidden projection) and the tanh
RNN cell as functions of a parameter tree (``{"ih", "hh"}``, each
``{"w": (in, out), "b"}``), and ``RNN``, the cell run over a (B, L, C)
series.  The JAX package has no kernel here: the port is plain PyTorch.
The series' input projection is one product over all L steps; the
recurrence is a loop of L device steps that reads nothing back.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.params import linear_apply, linear_init, param_tree

__all__ = ["gru_cell_init", "gru_cell_apply", "rnn_cell_init", "rnn_cell_apply", "RNN"]


def gru_cell_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
                  dtype=torch.float32, device=None) -> dict:
    return {"ih": linear_init(generator, input_dim, 3 * hidden_dim, dtype, device),
            "hh": linear_init(generator, hidden_dim, 3 * hidden_dim, dtype, device)}


def _gru_update(gi, p, h):
    """The GRU update from the input projection ``gi`` = x W_ih + b_ih."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = linear_apply(p["hh"], h).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_cell_apply(p, x, h):
    """``torch.nn.GRUCell`` semantics: r, z gates then candidate n with the
    reset applied to the *hidden* projection."""
    return _gru_update(linear_apply(p["ih"], x), p, h)


def rnn_cell_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
                  dtype=torch.float32, device=None) -> dict:
    return {"ih": linear_init(generator, input_dim, hidden_dim, dtype, device),
            "hh": linear_init(generator, hidden_dim, hidden_dim, dtype, device)}


def _rnn_update(gi, p, h):
    return torch.tanh(gi + linear_apply(p["hh"], h))


def rnn_cell_apply(p, x, h):
    return _rnn_update(linear_apply(p["ih"], x), p, h)


class RNN(nn.Module):
    """Plain GRU/RNN sequence baseline: the cell over (..., L, C) from a
    zero state, an optional final linear, the last state or every state
    (``return_sequences``).  Parameters ``cell`` and ``final`` under the
    JAX pytree's names, made from ``generator`` on ``device`` (the CUDA
    card unless ``device="cpu"``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 gru: bool = True, return_sequences: bool = False,
                 apply_final_linear: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim, self.hidden_dim, self.output_dim = input_dim, hidden_dim, output_dim
        self.gru = gru
        self.return_sequences = return_sequences
        self.apply_final_linear = apply_final_linear
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cell_init = gru_cell_init if gru else rnn_cell_init
        self.cell = param_tree(cell_init(generator, input_dim, hidden_dim, dtype, device))
        if apply_final_linear:
            self.final = nn.ParameterDict(
                linear_init(generator, hidden_dim, output_dim, dtype, device))

    @property
    def device(self) -> torch.device:
        return self.cell["ih"]["w"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.cell["ih"]["w"].dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        update = _gru_update if self.gru else _rnn_update
        gi = linear_apply(self.cell["ih"], x)            # every step's input projection
        h = torch.zeros(x.shape[:-2] + (self.hidden_dim,), dtype=x.dtype, device=x.device)
        hs = []
        for i in range(x.shape[-2]):
            h = update(gi[..., i, :], self.cell, h)
            hs.append(h)
        out = torch.stack(hs, dim=-2) if self.return_sequences else h
        return linear_apply(self.final, out) if self.apply_final_linear else out
