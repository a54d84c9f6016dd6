"""Stacked Neural CDEs: dZ_1 = f_1(Z_1) dX, dZ_k = f_k(Z_k) dZ_{k-1}.

PyTorch counterpart of the JAX package's ``models/stacked.py``: a chain of
NCDEs in which each later layer takes the previous layer's (B, L, H)
hidden path as its linear-interpolation coefficients (a dense path is its
own linear coefficients), statics fed to layer 0 or, with
``static_in_all_layers``, to every layer, and a final linear only on the
last.  Each layer is a ``NeuralCDE`` with the original/matmul field, so on
the card every layer's solve runs the fused field's kernels; a later
layer's control is the earlier layer's output, and the interval adjoint's
coefficient cotangent carries the gradient back into it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from online_neural_cdes_tpu_torch.models.ncde import NeuralCDE
from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = ["StackedNeuralCDE"]


class StackedNeuralCDE(nn.Module):
    """Layers ``ncde_0``, ``ncde_1``, ... under the JAX pytree's names,
    made from ``generator`` in order on ``device`` (the CUDA card unless
    ``device="cpu"``)."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int], output_dim: int,
                 hidden_hidden_dim: int = 15, static_dim: Optional[int] = None,
                 adjoint: bool = True, return_sequences: bool = False,
                 static_in_all_layers: bool = False, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not (isinstance(hidden_dims, (tuple, list)) and len(hidden_dims) > 0):
            raise ValueError("hidden_dims must be a non-empty tuple, one entry per layer")
        self.input_dim, self.output_dim = input_dim, output_dim
        self.hidden_dims = tuple(hidden_dims)
        self.hidden_hidden_dim = hidden_hidden_dim
        self.static_dim = static_dim
        self.adjoint = adjoint
        self.return_sequences = return_sequences
        self.static_in_all_layers = static_in_all_layers
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        n = len(self.hidden_dims)
        for i, hidden in enumerate(self.hidden_dims):
            last = i == n - 1
            setattr(self, f"ncde_{i}", NeuralCDE(
                input_dim=input_dim if i == 0 else self.hidden_dims[i - 1],
                hidden_dim=hidden,
                output_dim=output_dim if last else hidden,
                static_dim=static_dim if (i == 0 or static_in_all_layers) else None,
                hidden_hidden_dim=hidden_hidden_dim, num_layers=3, use_initial=True,
                interpolation="linear", adjoint=adjoint, apply_final_linear=last,
                return_sequences=True if not last else return_sequences,
                device=device, dtype=dtype, generator=generator))

    @property
    def layers(self) -> list:
        return [getattr(self, f"ncde_{i}") for i in range(len(self.hidden_dims))]

    @property
    def device(self) -> torch.device:
        return self.ncde_0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.ncde_0.dtype

    def forward(self, inputs):
        layers = self.layers
        static = inputs[0] if self.static_dim is not None else None
        hidden = layers[0](inputs)
        for layer in layers[1:]:
            hidden = layer((static, hidden) if layer.static_dim is not None else hidden)
        return hidden
