"""GRU-D and the gru-variant data preparation.

PyTorch counterpart of the JAX package's ``models/grud.py`` ("Recurrent
Neural Networks for Multivariate Time Series with Missing Values"):
exponential input and hidden decays (gamma_x diagonal), decay-based
imputation toward the training set's feature means, and a GRU update whose
gates also see the observation mask.

``prepare_gru_variant_data`` builds the (N, 4, L, C) tensor (data, last
observation, mask, delta) and slices the gru / gru-dt / gru-intensity /
gru-dt-intensity channel subsets.  The delta recursion and the GRU-D
recurrence are loops of L device steps that read nothing back.  The JAX
package has no kernel here: the port is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from online_neural_cdes_tpu_torch.ops.fill import forward_fill
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.params import linear_apply, linear_init, param_tree

__all__ = ["GRUD", "prepare_gru_variant_data", "time_since_last_observation",
           "GRU_VARIANTS"]

GRU_VARIANTS = ("gru", "gru-intensity", "gru-dt", "gru-dt-intensity", "gru-d")


def time_since_last_observation(controls: torch.Tensor):
    """``(delta, mask)``: delta[:, i, c] is the time since channel c was last
    observed, mask the observation mask (1 where not NaN).  Channel 0 is
    time."""
    mask = (~torch.isnan(controls)).to(controls.dtype)
    times = controls[..., :1].expand(controls.shape)
    dts = times[:, 1:] - times[:, :-1]
    delta = torch.zeros_like(mask[:, 0])
    deltas = [delta]
    for i in range(controls.shape[1] - 1):
        delta = dts[:, i] + delta * (1.0 - mask[:, i])
        deltas.append(delta)
    return torch.stack(deltas, dim=1), mask


def prepare_gru_variant_data(controls: torch.Tensor, variant: str,
                             feature_means: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 4, L, C) for ``"gru-d"``, else the variant's channels
    concatenated, (N, L, C * k) with NaN -> 0.  With ``feature_means``
    (C,), what filling leaves NaN takes the channel's mean, and steps past
    the series' end (a NaN time channel) are zeroed."""
    if variant not in GRU_VARIANTS:
        raise ValueError(f"variant={variant!r} not implemented; one of {GRU_VARIANTS}")
    end_mask = torch.isnan(controls[..., :1]).expand(controls.shape)
    delta, mask = time_since_last_observation(controls)
    filled = forward_fill(controls, axis=-2)
    prev_value = filled
    if feature_means is not None:
        fm = feature_means.to(controls).reshape(1, 1, -1).expand(controls.shape)
        zero = torch.zeros((), dtype=controls.dtype, device=controls.device)

        def fix(a):
            return torch.where(end_mask, zero, torch.where(torch.isnan(a), fm, a))

        filled, prev_value, delta = fix(filled), fix(prev_value), fix(delta)
    stacked = torch.stack([filled, prev_value, mask, delta], dim=1)   # (N, 4, L, C)
    if variant == "gru-d":
        return stacked
    pick = {"gru": [0], "gru-intensity": [0, 2], "gru-dt": [0, 3],
            "gru-dt-intensity": [0, 2, 3]}[variant]
    out = torch.cat([stacked[:, i] for i in pick], dim=-1)
    return torch.where(torch.isnan(out), torch.zeros_like(out), out)


def grud_cell_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
                   dtype=torch.float32, device=None) -> dict:
    gate_in = 2 * input_dim + hidden_dim  # (x, h, mask)
    u = torch.rand((input_dim,), generator=generator, dtype=torch.float64)
    return {
        "z": linear_init(generator, gate_in, hidden_dim, dtype, device),
        "r": linear_init(generator, gate_in, hidden_dim, dtype, device),
        "h": linear_init(generator, gate_in, hidden_dim, dtype, device),
        # gamma_x is diagonal (the reference's FilterLinear with an identity
        # mask): U(-1, 1) / sqrt(C), zero bias.
        "gamma_x": {"w": ((u * 2 - 1) / math.sqrt(input_dim)).to(dtype=dtype, device=device),
                    "b": torch.zeros((input_dim,), dtype=dtype, device=device)},
        "gamma_h": linear_init(generator, input_dim, hidden_dim, dtype, device),
    }


def grud_cell_apply(p, x, x_last, x_mean, h, mask, delta):
    """One GRU-D update."""
    # torch.maximum, not clamp: at a tie (delta = 0 at the first step) its
    # gradient splits in half, as jnp.maximum's does.
    zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
    decay_x = torch.exp(-torch.maximum(delta * p["gamma_x"]["w"] + p["gamma_x"]["b"], zero))
    decay_h = torch.exp(-torch.maximum(linear_apply(p["gamma_h"], delta), zero))
    x = mask * x + (1.0 - mask) * (decay_x * x_last + (1.0 - decay_x) * x_mean)
    h = decay_h * h
    combined = torch.cat([x, h, mask], dim=-1)
    z = torch.sigmoid(linear_apply(p["z"], combined))
    r = torch.sigmoid(linear_apply(p["r"], combined))
    h_tilde = torch.tanh(linear_apply(p["h"], torch.cat([x, r * h, mask], dim=-1)))
    return (1.0 - z) * h + z * h_tilde


class GRUD(nn.Module):
    """GRU-D over ``prepare_gru_variant_data(x, "gru-d", means)``'s (N, 4, L,
    C) tensor.  The JAX ``apply`` takes the training set's feature means as
    an argument; here the model holds them (``feature_means``, NaN -> 0, a
    non-persistent buffer, so the ``state_dict`` is the JAX tree) and
    ``forward(inputs, feature_means=None)`` overrides them per call, so
    ``make_train_step`` and ``Predictor`` call it as ``model(inputs)``.
    Parameters ``cell`` and ``final`` under the JAX pytree's names."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 return_sequences: bool = False,
                 feature_means: Optional[torch.Tensor] = None, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim, self.hidden_dim, self.output_dim = input_dim, hidden_dim, output_dim
        self.return_sequences = return_sequences
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cell = param_tree(grud_cell_init(generator, input_dim, hidden_dim, dtype, device))
        self.final = nn.ParameterDict(linear_init(generator, hidden_dim, output_dim, dtype,
                                                  device))
        means = (torch.zeros(input_dim) if feature_means is None
                 else torch.as_tensor(feature_means))
        self.register_buffer("feature_means", means.to(dtype=dtype, device=device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.final["w"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.final["w"].dtype

    def forward(self, inputs: torch.Tensor,
                feature_means: Optional[torch.Tensor] = None) -> torch.Tensor:
        means = self.feature_means if feature_means is None else feature_means
        means = means.to(inputs)
        means = torch.where(torch.isnan(means), torch.zeros_like(means), means)
        data, last_obs, mask, delta = inputs.unbind(1)
        h = torch.zeros(data.shape[:1] + (self.hidden_dim,), dtype=data.dtype,
                        device=data.device)
        hs = []
        for i in range(data.shape[1]):
            h = grud_cell_apply(self.cell, data[:, i], last_obs[:, i], means, h,
                                mask[:, i], delta[:, i])
            hs.append(h)
        out = torch.stack(hs, dim=1) if self.return_sequences else h
        return linear_apply(self.final, out)
