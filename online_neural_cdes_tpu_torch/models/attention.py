"""Attention Neural CDE and the sparsemax activation.

PyTorch counterpart of the JAX package's ``models/attention.py``:

1. an encoder NCDE, dZ = f(Z) dX, returns the path of hidden states;
2. an attention NCDE run over that path (backwards in time by default)
   returns one score per time step;
3. softmax or sparsemax over time; the states whose weight exceeds
   1/length are kept;
4. a final NCDE over the kept states, then a linear output map.

The kept states are compacted to the front of the fixed-length time axis
by a stable sort and the tail repeats the last kept state: a constant tail
has dX = 0, so the final NCDE's terminal state is that of the kept states
alone, with static shapes and no read back to the host.  The keep mask is
a comparison, so no gradient reaches the attention NCDE (nor in JAX: its
gradient is zero there).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from online_neural_cdes_tpu_torch.models.ncde import NeuralCDE
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.params import linear_apply, linear_init

__all__ = ["AttentionNeuralCDE", "sparsemax"]


def sparsemax(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Euclidean projection of z onto the probability simplex along ``dim``
    (Martins & Astudillo): a sparse alternative to softmax.  Autograd
    through the closed form gives the paper's Jacobian."""
    z = torch.movedim(z, dim, -1)
    n = z.shape[-1]
    z = z - torch.amax(z, dim=-1, keepdim=True).detach()
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k_range = torch.arange(1, n + 1, dtype=z.dtype, device=z.device)
    cumsum = torch.cumsum(z_sorted, dim=-1)
    support = 1.0 + k_range * z_sorted > cumsum
    k = torch.sum(support, dim=-1, keepdim=True).to(z.dtype)
    tau_sum = torch.sum(torch.where(support, z_sorted, torch.zeros_like(z_sorted)),
                        dim=-1, keepdim=True)
    tau = (tau_sum - 1.0) / k
    # torch.maximum, as jnp.maximum, splits the gradient at a tie.
    out = torch.maximum(z - tau, torch.zeros_like(z))
    return torch.movedim(out, -1, dim)


def _compact_kept_states(hidden: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Move the kept time steps to the front (stable, order-preserving)
    and fill the tail with the last kept state; a row that keeps nothing
    keeps position 0.  hidden: (B, L, H); keep: (B, L) bool."""
    length = hidden.shape[-2]
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)   # kept first
    compacted = torch.gather(hidden, -2, order[..., None].expand(hidden.shape))
    counts = torch.clamp_min(keep.sum(dim=-1), 1)
    idx = torch.arange(length, device=hidden.device)
    pos = torch.minimum(idx[None, :], counts[:, None] - 1)
    return torch.gather(compacted, -2, pos[..., None].expand(hidden.shape))


class AttentionNeuralCDE(nn.Module):
    """Submodules ``encoder``, ``attention``, ``final`` (NCDEs with the
    original/matmul field, linear interpolation, three trunk layers,
    statics in each when ``static_dim`` is set) and ``fc_output`` under the
    JAX pytree's names, made from ``generator`` in that order on ``device``
    (the CUDA card unless ``device="cpu"``).  The NCDEs' trunk width is
    ``NeuralCDE``'s default, 15, as in the JAX model.

    The optimizer's 10x learning rate goes to the top-level name ``final``,
    which here is the final NCDE (as in JAX's optimizer labels)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 static_dim: Optional[int] = None, adjoint: bool = True,
                 run_backwards: bool = True, sparsemax: bool = False,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim, self.hidden_dim, self.output_dim = input_dim, hidden_dim, output_dim
        self.static_dim = static_dim
        self.adjoint = adjoint
        self.run_backwards = run_backwards
        self.sparsemax = sparsemax
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def ncde(in_dim, out_dim, return_sequences=True):
            return NeuralCDE(
                input_dim=in_dim, hidden_dim=hidden_dim, output_dim=out_dim,
                static_dim=static_dim, use_initial=True, interpolation="linear", adjoint=adjoint, num_layers=3,
                apply_final_linear=True, return_sequences=return_sequences,
                return_filtered_rectilinear=False, device=device, dtype=dtype,
                generator=generator)

        self.encoder = ncde(input_dim, hidden_dim)
        self.attention = ncde(hidden_dim, 1)
        self.final = ncde(hidden_dim, hidden_dim, return_sequences=False)
        self.fc_output = nn.ParameterDict(
            linear_init(generator, hidden_dim, output_dim, dtype, device))

    @property
    def device(self) -> torch.device:
        return self.encoder.device

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder.dtype

    def _with_static(self, inputs, hidden):
        return hidden if self.static_dim is None else (inputs[0], hidden)

    def attention_weights(self, inputs):
        """``(hidden, weights)``: the encoder's (B, L, H) path and the (B, L)
        attention weights over time (softmax or sparsemax)."""
        hidden = self.encoder(inputs)
        att_in = torch.flip(hidden, dims=(-2,)) if self.run_backwards else hidden
        scores = self.attention(self._with_static(inputs, att_in))      # (B, L, 1)
        if self.run_backwards:
            scores = torch.flip(scores, dims=(-2,))
        act = sparsemax if self.sparsemax else torch.softmax
        return hidden, act(scores[..., 0], dim=-1)

    def forward(self, inputs):
        hidden, weights = self.attention_weights(inputs)
        keep = weights > 1.0 / hidden.shape[-2]
        reduced = _compact_kept_states(hidden, keep)
        out = self.final(self._with_static(inputs, reduced))
        return linear_apply(self.fc_output, out)
