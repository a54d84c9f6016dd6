"""Linear and rectilinear interpolation of controls.

PyTorch counterpart of the linear part of the JAX package's
``ops/interpolation.py``: ``prepare_rectilinear_interpolation``,
``linear_interpolation_coeffs`` and ``LinearInterpolation``, with the same
semantics.  Series are ``(..., length, channels)`` with NaN for a missing
value.  The cubic, Hermite and smoothed schemes come with a later slice of
the port (ROADMAP item 11).

``LinearInterpolation`` keeps its knot times on the coefficients' device
and, when they are known on the host without a device read (the default
unit grid, or times given as numpy/list/CPU tensor), a host copy as well:
the fixed-grid solver steps with host floats, so a solve on the card needs
no device-to-host sync for its step sizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from online_neural_cdes_tpu_torch.ops.fill import (
    forward_fill as _forward_fill,
    linear_fill,
)

__all__ = [
    "linear_interpolation_coeffs",
    "prepare_rectilinear_interpolation",
    "LinearInterpolation",
]


def prepare_rectilinear_interpolation(x: torch.Tensor, time_index: int) -> torch.Tensor:
    """Forward-fill + interleave-lag so that *linear* interpolation of the
    result equals *rectilinear* (time-then-value) interpolation of the
    input; output length 2L-1.  Example: [(t1,x1),(t2,NaN),(t3,x3)] ->
    [(t1,x1),(t2,x1),(t2,x1),(t3,x1),(t3,x3)]."""
    n_channels = x.shape[-1]
    if not (isinstance(time_index, int) and 0 <= time_index < n_channels):
        raise ValueError(f"time_index {time_index!r} not in [0, {n_channels})")
    filled = _forward_fill(x, axis=-2)
    rep = torch.repeat_interleave(filled, 2, dim=-2)
    # Lag the time channel by one interleaved slot.
    rep[..., :-1, time_index] = rep[..., 1:, time_index].clone()
    return rep[..., :-1, :]


def linear_interpolation_coeffs(
    x: torch.Tensor,
    t: Optional[torch.Tensor] = None,
    rectilinear: Optional[int] = None,
    initial_value_if_nan: Optional[float] = None,
    forward_fill: bool = False,
) -> torch.Tensor:
    """Knots of the linear interpolation of a batch of controls, with the
    ``rectilinear=`` time-channel index and the causality options
    ``initial_value_if_nan`` / ``forward_fill``."""
    x = torch.as_tensor(x)
    if initial_value_if_nan is not None:
        x = x.clone()
        first = x[..., 0, :]
        x[..., 0, :] = torch.where(
            torch.isnan(first), torch.full_like(first, initial_value_if_nan), first
        )
    if rectilinear is not None:
        x = prepare_rectilinear_interpolation(x, rectilinear)
    if forward_fill:
        x = _forward_fill(x, axis=-2)
    if t is None:
        t = torch.arange(x.shape[-2], dtype=x.dtype, device=x.device)
    return linear_fill(x, t=torch.as_tensor(t, device=x.device), axis=-2)


def _interp_index(knots: torch.Tensor, t: torch.Tensor, max_index: int):
    """Piece lookup: index i with knots[i] <= t < knots[i+1], clamped to
    [0, max_index] (out-of-range t extrapolates the end pieces)."""
    index = torch.searchsorted(knots, t.reshape(-1), right=True) - 1
    index = index.clamp(0, max_index)
    frac = t.reshape(-1) - knots[index]
    return frac, index


class LinearInterpolation:
    """Piecewise-linear control path.

    ``coeffs``: (..., L, C) knot values from
    :func:`linear_interpolation_coeffs`; ``t``: (L,) knot times.  ``t`` may
    be a scalar or a 1-D array in :meth:`evaluate` / :meth:`derivative`
    (returning (..., C) or (..., T, C)).  The piece-wise API
    (:meth:`piece_data`, :meth:`piece_derivative`) feeds the fixed-grid
    solver one interval at a time.
    """

    def __init__(self, coeffs: torch.Tensor, t: torch.Tensor,
                 t_host: Optional[tuple] = None):
        self.coeffs = coeffs
        self.t = t
        self.t_host = t_host

    @classmethod
    def create(cls, coeffs, t=None):
        coeffs = torch.as_tensor(coeffs)
        if t is None:
            # Unit grid: integers are exact in every float dtype.
            length = coeffs.shape[-2]
            t_dev = torch.arange(length, dtype=coeffs.dtype, device=coeffs.device)
            return cls(coeffs, t_dev, tuple(float(i) for i in range(length)))
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            return cls(coeffs, t.to(coeffs.dtype), None)
        t_cpu = torch.as_tensor(np.asarray(t)).to(coeffs.dtype)
        return cls(coeffs, t_cpu.to(coeffs.device), tuple(t_cpu.tolist()))

    @property
    def grid_points(self) -> torch.Tensor:
        return self.t

    @property
    def interval(self) -> torch.Tensor:
        return torch.stack([self.t[0], self.t[-1]])

    def host_grid(self) -> tuple:
        """Knot times as Python floats (one device read if they were only
        given on the device)."""
        if self.t_host is None:
            self.t_host = tuple(self.t.tolist())
        return self.t_host

    def _take(self, index):
        return self.coeffs.index_select(-2, index)

    def _shape_out(self, v, t):
        # (..., T, C) -> (..., C) for a scalar t.
        return v.squeeze(-2) if t.dim() == 0 else v

    def evaluate(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=self.coeffs.dtype, device=self.coeffs.device)
        frac, index = _interp_index(self.t, t, self.coeffs.shape[-2] - 2)
        prev = self._take(index)
        nxt = self._take(index + 1)
        dt = self.t[index + 1] - self.t[index]
        out = prev + frac[:, None] * (nxt - prev) / dt[:, None]
        return self._shape_out(out, t)

    def derivative(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=self.coeffs.dtype, device=self.coeffs.device)
        _, index = _interp_index(self.t, t, self.coeffs.shape[-2] - 2)
        prev = self._take(index)
        nxt = self._take(index + 1)
        dt = self.t[index + 1] - self.t[index]
        return self._shape_out((nxt - prev) / dt[:, None], t)

    def piece_data(self):
        """Time-major pieces: {"x0", "dxdt"}, each (L-1, ..., C).  ``dxdt``
        is made contiguous, so each piece's (..., C) slice is too (the
        fused field's kernel takes contiguous tensors only)."""
        x = torch.movedim(self.coeffs, -2, 0)          # (L, ..., C)
        dt = self.t[1:] - self.t[:-1]
        dt = dt.reshape((-1,) + (1,) * (x.dim() - 1))
        return {"x0": x[:-1], "dxdt": ((x[1:] - x[:-1]) / dt).contiguous()}

    @staticmethod
    def piece_derivative(piece, frac):
        return piece["dxdt"]

    @staticmethod
    def piece_evaluate(piece, frac):
        return piece["x0"] + frac * piece["dxdt"]

