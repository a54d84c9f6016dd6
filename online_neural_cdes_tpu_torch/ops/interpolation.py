"""Interpolation schemes for controlled paths.

PyTorch counterpart of the JAX package's ``ops/interpolation.py``, with the
same semantics: linear and rectilinear coefficients and
``LinearInterpolation``; natural cubic coefficients (both versions, with
per-path NaN compression: observed knots moved to the front by a stable
argsort, one batched Thomas solve, and the pieces re-expressed on the
original grid); Hermite cubic with backward differences; ``CubicSpline``
(alias ``NaturalCubicSpline``); ``TupleControl``; the smoothed linear
interpolation ``SmoothLinearInterpolation`` with its cubic and quintic
matching polynomials; and the host-side ``linear_rectilinear_hybrid``.
Series are ``(..., length, channels)`` with NaN for a missing value.

Every spline keeps its knot times on the coefficients' device and, when
they are known on the host without a device read (the default unit grid,
or times given as numpy/list/CPU tensor), a host copy as well
(``host_grid``): the fixed-grid solver steps with host floats, so a solve
on the card needs no device-to-host sync for its step sizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from online_neural_cdes_tpu_torch.ops.fill import (
    forward_fill as _forward_fill,
    linear_fill,
    tridiagonal_solve,
)

__all__ = [
    "linear_interpolation_coeffs",
    "prepare_rectilinear_interpolation",
    "natural_cubic_coeffs",
    "natural_cubic_spline_coeffs",
    "hermite_cubic_coefficients_with_backward_differences",
    "linear_rectilinear_hybrid",
    "LinearInterpolation",
    "CubicSpline",
    "NaturalCubicSpline",
    "SmoothLinearInterpolation",
    "TupleControl",
]


def _knot_times(t, length: int, like: torch.Tensor):
    """(times on ``like``'s device and dtype, host times or None) for
    ``length`` knots: the unit grid by default (integers are exact in every
    float dtype); times given on the host keep a host copy; times given on
    the card are read only if a spline's ``host_grid`` is asked for."""
    if t is None:
        return (torch.arange(length, dtype=like.dtype, device=like.device),
                tuple(float(i) for i in range(length)))
    if isinstance(t, torch.Tensor) and t.device.type != "cpu":
        return t.to(like.dtype), None
    t_cpu = torch.as_tensor(np.asarray(t)).to(like.dtype)
    return t_cpu.to(like.device), tuple(t_cpu.tolist())


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
    return linear_fill(x, t=_knot_times(t, x.shape[-2], x)[0], axis=-2)


def _natural_cubic_paths(t: torch.Tensor, x: torch.Tensor, version: int):
    """Natural cubic splines through the *observed* knots of P scalar paths
    ``x`` (P, L) on the knot times ``t`` (L,).  Returns per-interval
    derivative-form coefficients (a, b, two_c, three_d), each (P, L-1),
    re-expressed on every interval of the original grid (the JAX
    ``_natural_cubic_1d``, batched over the paths).

    ``version`` 0 imputes only the first/last points from the nearest
    observation; 1 forward/backward-fills the ends so the spline stabilises
    to a constant.  An all-NaN path is the constant zero path."""
    length = x.shape[-1]
    dtype = x.dtype
    idx = torch.arange(length, device=x.device)
    mask = ~torch.isnan(x)
    any_obs = mask.any(dim=-1, keepdim=True)
    first = torch.argmax(mask.to(torch.uint8), dim=-1, keepdim=True)
    last = (length - 1) - torch.argmax(torch.flip(mask, dims=(-1,)).to(torch.uint8),
                                       dim=-1, keepdim=True)
    x_first = torch.gather(x, -1, first)
    x_last = torch.gather(x, -1, last)

    if version == 0:
        x = x.clone()
        x[:, 0] = torch.where(mask[:, 0], x[:, 0], x_first[:, 0])
        x[:, -1] = torch.where(mask[:, -1], x[:, -1], x_last[:, 0])
        mask = mask.clone()
        mask[:, 0] = True
        mask[:, -1] = True
    else:
        x = torch.where(idx < first, x_first, x)
        x = torch.where(idx > last, x_last, x)
        mask = mask | (idx < first) | (idx > last)

    # All-NaN path: constant zero path with zero coefficients.
    x = torch.where(any_obs, x, torch.zeros_like(x))
    mask = mask | ~any_obs

    # Compress observed knots to the front (stable: keeps time order).
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    ts = t[order]
    xs = torch.gather(x, -1, order)
    m = mask.sum(dim=-1, keepdim=True)  # observed knots, >= 2 after imputation
    t_tail = torch.gather(ts, -1, m - 1)
    x_tail = torch.gather(xs, -1, m - 1)
    # Pad the tail so times stay strictly increasing and values constant.
    ts = torch.where(idx < m, ts, t_tail + (idx - m + 1).to(dtype))
    xs = torch.where(idx < m, xs, x_tail)

    # Natural-spline tridiagonal system for the knot derivatives k:
    #   (1/h_{i-1}) k_{i-1} + 2(1/h_{i-1}+1/h_i) k_i + (1/h_i) k_{i+1}
    #     = 3 dx_{i-1}/h_{i-1}^2 + 3 dx_i/h_i^2
    # with 1/h := 0 outside the observed range, which encodes the natural
    # boundary condition at the last observed knot and decouples the
    # padded rows.
    h = ts[:, 1:] - ts[:, :-1]
    inv_h = torch.where(idx[:-1] < m - 1, 1.0 / h, torch.zeros_like(h))
    inv_h2 = inv_h * inv_h
    dx = xs[:, 1:] - xs[:, :-1]
    rhs_piece = 3.0 * dx * inv_h2
    zeros = torch.zeros_like(x)
    diag = torch.cat([inv_h, zeros[:, :1]], -1) + torch.cat([zeros[:, :1], inv_h], -1)
    diag = diag * 2.0
    diag = torch.where(diag == 0, torch.ones_like(diag), diag)
    rhs = (torch.cat([rhs_piece, zeros[:, :1]], -1)
           + torch.cat([zeros[:, :1], rhs_piece], -1))
    k = tridiagonal_solve(rhs, inv_h, diag, inv_h)

    # Per-piece coefficients on the compressed pieces.
    a_c = xs[:, :-1]
    b_c = k[:, :-1]
    two_c_c = (6.0 * dx * inv_h - 4.0 * k[:, :-1] - 2.0 * k[:, 1:]) * inv_h
    three_d_c = (-6.0 * dx * inv_h + 3.0 * (k[:, :-1] + k[:, 1:])) * inv_h2

    # Re-express on the original grid: each original interval's left end
    # tau lies inside observed piece j; shift the polynomial's origin to tau.
    tau = t[:-1].expand(x.shape[0], length - 1).contiguous()
    j = torch.searchsorted(ts.contiguous(), tau, right=True) - 1
    j = torch.minimum(j.clamp(min=0), (m - 2).clamp(min=0))
    offset = torch.gather(ts, -1, j) - tau
    A = torch.gather(a_c, -1, j)
    B = torch.gather(b_c, -1, j)
    C2 = torch.gather(two_c_c, -1, j)
    D3 = torch.gather(three_d_c, -1, j)
    a = A + ((0.5 * C2 - D3 * offset / 3.0) * offset - B) * offset
    b = B + (D3 * offset - C2) * offset
    two_c = C2 - 2.0 * D3 * offset
    return a, b, two_c, D3


def _natural_cubic(x, t, version: int) -> torch.Tensor:
    x = torch.as_tensor(x)
    length = x.shape[-2]
    if length < 2:
        raise ValueError("Must have a time dimension of size at least 2.")
    t = _knot_times(t, length, x)[0]
    # Channels are independent scalar paths: flatten (batch..., channels).
    batch_shape, channels = x.shape[:-2], x.shape[-1]
    flat = torch.movedim(x, -2, -1).reshape(-1, length)  # (B*C, L)

    def unflat(arr):
        return torch.movedim(arr.reshape(*batch_shape, channels, length - 1), -1, -2)

    # Packed [a | b | two_c | three_d] on the channel axis (the layout of
    # the JAX package and the reference).
    return torch.cat([unflat(c) for c in _natural_cubic_paths(t, flat, version)],
                     dim=-1)


def natural_cubic_coeffs(x, t=None) -> torch.Tensor:
    """Natural cubic spline coefficients; ends stabilised by
    forward/backward fill (``_version=1`` of the reference)."""
    return _natural_cubic(x, t, version=1)


def natural_cubic_spline_coeffs(x, t=None) -> torch.Tensor:
    """Deprecated variant imputing only the very first/last observation
    (``_version=0`` of the reference)."""
    return _natural_cubic(x, t, version=0)


def hermite_cubic_coefficients_with_backward_differences(x, t=None) -> torch.Tensor:
    """Hermite cubic with backward differences -- the *causal* cubic scheme.

    On each interval [t_i, t_{i+1}] a cubic matches the values x_i, x_{i+1}
    and the backward-difference derivatives d_i = (x_i - x_{i-1})/h_{i-1}
    (d_0 uses the forward difference).  Closed form, no global solve.
    Missing values are infilled linearly first.  Output layout matches
    :func:`natural_cubic_coeffs`, so :class:`CubicSpline` takes both."""
    x = torch.as_tensor(x)
    length = x.shape[-2]
    if length < 2:
        raise ValueError("Must have a time dimension of size at least 2.")
    t = _knot_times(t, length, x)[0]
    x = linear_fill(x, t=t, axis=-2)
    h = (t[1:] - t[:-1])[:, None]                        # (L-1, 1)
    slopes = (x[..., 1:, :] - x[..., :-1, :]) / h        # m_i on piece i
    # Knot derivatives: d_0 = m_0; d_i = m_{i-1} for i >= 1.
    d = torch.cat([slopes[..., :1, :], slopes], dim=-2)  # (L, C)
    d0 = d[..., :-1, :]  # left derivative on piece i = m_{i-1}
    d1 = d[..., 1:, :]   # right derivative on piece i = m_i
    a = x[..., :-1, :]
    two_c = 2.0 * (3.0 * slopes - 2.0 * d0 - d1) / h
    three_d = 3.0 * (d0 + d1 - 2.0 * slopes) / (h * h)
    return torch.cat([a, d0, two_c, three_d], dim=-1)


def _interp_index(knots: torch.Tensor, t: torch.Tensor, max_index: int):
    """Piece lookup: index i with knots[i] <= t < knots[i+1], clamped to
    [0, max_index] (out-of-range t extrapolates the end pieces)."""
    index = torch.searchsorted(knots, t.reshape(-1), right=True) - 1
    index = index.clamp(0, max_index)
    frac = t.reshape(-1) - knots[index]
    return frac, index


class _InterpolationBase:
    """Shared API: ``grid_points``, ``interval`` and ``host_grid``.  ``t``
    may be a scalar (returns (..., C)) or a 1-D array of times (returns
    (..., T, C)) in ``evaluate`` / ``derivative``.  Splines with a
    piece-wise API (``piece_data``, ``piece_derivative``,
    ``piece_evaluate``) feed the fixed-grid solver one interval at a
    time.  ``tree_fields`` names a spline's tensors in the JAX dataclass's
    pytree order (``utils.tree.flatten``): the generic solver's adjoint
    integrates a cotangent for each."""

    t: torch.Tensor
    t_host: Optional[tuple]

    @property
    def grid_points(self) -> torch.Tensor:
        return self.t

    @property
    def interval(self) -> torch.Tensor:
        # One tensor per spline (unless its times take gradients), so
        # ``cdeint`` can tell it apart and take its end points from the host.
        if self.t.requires_grad:
            return torch.stack([self.t[0], self.t[-1]])
        if getattr(self, "_interval", None) is None:
            self._interval = torch.stack([self.t[0], self.t[-1]])
        return self._interval

    def host_grid(self) -> tuple:
        """Knot times as Python floats (one device read if they were only
        given on the device)."""
        if self.t_host is None:
            self.t_host = tuple(self.t.tolist())
        return self.t_host

    @staticmethod
    def _shape_out(v, t):
        # (..., T, C) -> (..., C) for a scalar t.
        return v.squeeze(-2) if t.dim() == 0 else v


def _time_major(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """``axis`` moved to the front, contiguous, so each piece's slice is
    contiguous too (the fused field's kernel takes contiguous tensors
    only)."""
    return torch.movedim(x, axis, 0).contiguous()


class LinearInterpolation(_InterpolationBase):
    """Piecewise-linear control path.

    ``coeffs``: (..., L, C) knot values from
    :func:`linear_interpolation_coeffs`; ``t``: (L,) knot times.  ``t`` may
    be a scalar or a 1-D array in :meth:`evaluate` / :meth:`derivative`
    (returning (..., C) or (..., T, C)).  The piece-wise API
    (:meth:`piece_data`, :meth:`piece_derivative`) feeds the fixed-grid
    solver one interval at a time.
    """

    tree_fields = ("coeffs", "t")

    def __init__(self, coeffs: torch.Tensor, t: torch.Tensor,
                 t_host: Optional[tuple] = None):
        self.coeffs = coeffs
        self.t = t
        self.t_host = t_host

    @classmethod
    def create(cls, coeffs, t=None):
        coeffs = torch.as_tensor(coeffs)
        return cls(coeffs, *_knot_times(t, coeffs.shape[-2], coeffs))

    def _take(self, index):
        return self.coeffs.index_select(-2, index)

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

    def piece_data(self, lo: int = 0, hi: Optional[int] = None):
        """Time-major pieces: {"x0", "dxdt"}, each (L-1, ..., C), or only
        pieces ``lo`` to ``hi`` (exclusive), built from those knots alone.
        ``dxdt`` is made contiguous, so each piece's (..., C) slice is too
        (the fused field's kernel takes contiguous tensors only)."""
        hi = self.coeffs.shape[-2] - 1 if hi is None else hi
        x = torch.movedim(self.coeffs[..., lo:hi + 1, :], -2, 0)   # (hi-lo+1, ..., C)
        dt = self.t[lo + 1:hi + 1] - self.t[lo:hi]
        dt = dt.reshape((-1,) + (1,) * (x.dim() - 1))
        return {"x0": x[:-1], "dxdt": ((x[1:] - x[:-1]) / dt).contiguous()}

    @staticmethod
    def piece_derivative(piece, frac):
        return piece["dxdt"]

    @staticmethod
    def piece_evaluate(piece, frac):
        return piece["x0"] + frac * piece["dxdt"]


class CubicSpline(_InterpolationBase):
    """Cubic spline in derivative form.  Takes packed coefficients from
    :func:`natural_cubic_coeffs` or
    :func:`hermite_cubic_coefficients_with_backward_differences`: per
    piece, x(t0+s) = a + b s + (two_c/2) s^2 + (three_d/3) s^3."""

    tree_fields = ("a", "b", "two_c", "three_d", "t")

    def __init__(self, a, b, two_c, three_d, t, t_host=None):
        self.a, self.b, self.two_c, self.three_d = a, b, two_c, three_d  # (..., L-1, C)
        self.t = t                                                       # (L,)
        self.t_host = t_host

    @classmethod
    def create(cls, coeffs, t=None):
        coeffs = torch.as_tensor(coeffs)
        channels = coeffs.shape[-1] // 4
        if channels * 4 != coeffs.shape[-1]:
            raise ValueError("Passed invalid coeffs.")
        parts = [coeffs[..., i * channels:(i + 1) * channels] for i in range(4)]
        return cls(*parts, *_knot_times(t, coeffs.shape[-2] + 1, coeffs))

    def _interpret_t(self, t):
        t = torch.as_tensor(t, dtype=self.b.dtype, device=self.b.device)
        frac, index = _interp_index(self.t, t, self.b.shape[-2] - 1)
        return t, frac[:, None], index

    def evaluate(self, t) -> torch.Tensor:
        t, frac, index = self._interpret_t(t)
        a, b, two_c, three_d = (c.index_select(-2, index)
                                for c in (self.a, self.b, self.two_c, self.three_d))
        inner = 0.5 * two_c + three_d * frac / 3.0
        inner = b + inner * frac
        return self._shape_out(a + inner * frac, t)

    def derivative(self, t) -> torch.Tensor:
        t, frac, index = self._interpret_t(t)
        b, two_c, three_d = (c.index_select(-2, index)
                             for c in (self.b, self.two_c, self.three_d))
        return self._shape_out(b + (two_c + three_d * frac) * frac, t)

    def piece_data(self, lo: int = 0, hi: Optional[int] = None):
        """Time-major pieces {"a", "b", "two_c", "three_d"}, each (L-1, ...,
        C) and contiguous, or only pieces ``lo`` to ``hi`` (exclusive)."""
        hi = self.b.shape[-2] if hi is None else hi
        return {key: _time_major(getattr(self, key)[..., lo:hi, :])
                for key in ("a", "b", "two_c", "three_d")}

    @staticmethod
    def piece_derivative(piece, frac):
        return piece["b"] + (piece["two_c"] + piece["three_d"] * frac) * frac

    @staticmethod
    def piece_evaluate(piece, frac):
        inner = 0.5 * piece["two_c"] + piece["three_d"] * frac / 3.0
        return piece["a"] + (piece["b"] + inner * frac) * frac


# The reference exposes both names (torchcde.NaturalCubicSpline / CubicSpline).
NaturalCubicSpline = CubicSpline


class TupleControl(_InterpolationBase):
    """Several controls batched into one: ``evaluate``/``derivative``
    return tuples, one entry per control.  All controls must share the same
    interval; ``grid_points`` requires them to share knots."""

    tree_fields = ("controls",)

    def __init__(self, controls: tuple):
        self.controls = controls

    @classmethod
    def create(cls, *controls):
        if len(controls) == 0:
            raise ValueError("Expected one or more controls to batch together.")
        grid0 = controls[0].host_grid()
        for c in controls[1:]:
            grid = c.host_grid()
            if not np.allclose([grid[0], grid[-1]], [grid0[0], grid0[-1]]):
                raise ValueError("Can only batch together controls over the same interval.")
        return cls(tuple(controls))

    @property
    def t(self):
        return self.controls[0].t

    def host_grid(self) -> tuple:
        return self.controls[0].host_grid()

    @property
    def grid_points(self):
        g0 = self.controls[0].grid_points
        for c in self.controls[1:]:
            if c.grid_points.shape != g0.shape:
                raise RuntimeError("Batch of controls have different grid points.")
        return g0

    @property
    def interval(self):
        return self.controls[0].interval

    def evaluate(self, t):
        return tuple(c.evaluate(t) for c in self.controls)

    def derivative(self, t):
        return tuple(c.derivative(t) for c in self.controls)


def _check_eps(eps):
    if not 0 < eps <= 1:
        raise ValueError(f"gradient_matching_eps must lie in (0, 1], got {eps}")


def _cubic_matching_coefficients(coeffs: torch.Tensor, eps: float) -> torch.Tensor:
    """Cubic polynomials smoothing each interior kink on (knot, knot+eps),
    matching value and first derivative.  Returns (..., L-2, C, 4) with
    powers descending [A, B, C, D]."""
    _check_eps(eps)
    x = coeffs[..., 1:-1, :]
    x_eps = x + eps * (coeffs[..., 2:, :] - x)
    delta_prev = coeffs[..., 1:-1, :] - coeffs[..., :-2, :]
    delta_next = coeffs[..., 2:, :] - coeffs[..., 1:-1, :]
    C = delta_prev
    D = x
    B = (1.0 / eps**2) * (3.0 * (x_eps - C * eps - D) - eps * (delta_next - C))
    A = (1.0 / (3.0 * eps**2)) * (delta_next - C - 2.0 * B * eps)
    return torch.stack([A, B, C, D], dim=-1)


def _quintic_matching_coefficients(coeffs: torch.Tensor, eps: float) -> torch.Tensor:
    """Quintic variant also matching second derivatives: (..., L-2, C, 6)."""
    _check_eps(eps)
    x = coeffs[..., 1:-1, :]
    x_eps = x + eps * (coeffs[..., 2:, :] - x)
    delta_prev = coeffs[..., 1:-1, :] - coeffs[..., :-2, :]
    delta_next = coeffs[..., 2:, :] - coeffs[..., 1:-1, :]
    D = torch.zeros_like(x)
    E = delta_prev
    F = x
    C = (1.0 / eps**3) * (10.0 * (x_eps - E * eps - F) - 4.0 * eps * (delta_next - E))
    B = (1.0 / (2.0 * eps**3)) * (2.0 * (delta_next - E) - 3.0 * C * eps**2)
    A = -(1.0 / (10.0 * eps**2)) * (6.0 * B * eps + 3.0 * C)
    return torch.stack([A, B, C, D, E, F], dim=-1)


def _polyval_descending(c: torch.Tensor, s) -> torch.Tensor:
    """Horner evaluation of polynomials with descending-power coefficient
    vectors on the last axis.  c: (..., C, P); s broadcastable to (..., C)."""
    out = c[..., 0]
    for p in range(1, c.shape[-1]):
        out = out * s + c[..., p]
    return out


def _derivative_coefficients(mc: torch.Tensor) -> torch.Tensor:
    """Descending-power coefficients of the derivative polynomials."""
    n = mc.shape[-1]
    powers = torch.arange(n - 1, 0, -1, dtype=mc.dtype, device=mc.device)
    return mc[..., :-1] * powers


class SmoothLinearInterpolation(_InterpolationBase):
    """Linear interpolation with its kinks smoothed by cubic/quintic
    matching polynomials in an eps-region after each interior knot.  Knot
    spacing must be the default unit grid, as in the reference."""

    tree_fields = ("coeffs", "matching_coeffs", "t")

    def __init__(self, coeffs, matching_coeffs, t, eps: float, t_host=None):
        self.coeffs = coeffs                    # (..., L, C)
        self.matching_coeffs = matching_coeffs  # (..., L-2, C, P)
        self.t = t                              # (L,)
        self.eps = eps
        self.t_host = t_host

    @classmethod
    def create(cls, coeffs, gradient_matching_eps: float,
               match_second_derivatives: bool = False, t=None):
        coeffs = torch.as_tensor(coeffs)
        if t is not None:
            raise NotImplementedError("times not implemented for gradient matching")
        matching = (_quintic_matching_coefficients if match_second_derivatives
                    else _cubic_matching_coefficients)
        t_dev, t_host = _knot_times(None, coeffs.shape[-2], coeffs)
        return cls(coeffs, matching(coeffs, gradient_matching_eps), t_dev,
                   float(gradient_matching_eps), t_host)

    def _interpret_t(self, t):
        t = torch.as_tensor(t, dtype=self.coeffs.dtype, device=self.coeffs.device)
        frac, index = _interp_index(self.t, t, self.coeffs.shape[-2] - 2)
        in_match = (index > 0) & (frac < self.eps)
        match_idx = (index - 1).clamp(0, self.matching_coeffs.shape[-3] - 1)
        mc = self.matching_coeffs.index_select(-3, match_idx)  # (..., T, C, P)
        prev = self.coeffs.index_select(-2, index)
        nxt = self.coeffs.index_select(-2, index + 1)
        return t, frac[:, None], in_match[:, None], mc, prev, nxt

    def evaluate(self, t) -> torch.Tensor:
        t, frac, in_match, mc, prev, nxt = self._interpret_t(t)
        out = torch.where(in_match, _polyval_descending(mc, frac),
                          prev + frac * (nxt - prev))
        return self._shape_out(out, t)

    def derivative(self, t) -> torch.Tensor:
        t, frac, in_match, mc, prev, nxt = self._interpret_t(t)
        out = torch.where(in_match,
                          _polyval_descending(_derivative_coefficients(mc), frac),
                          nxt - prev)
        return self._shape_out(out, t)

    def piece_data(self, lo: int = 0, hi: Optional[int] = None):
        """Time-major pieces: {"x0", "dxdt"} (L-1, ..., C), the matching
        polynomials "mc" (L-1, ..., C, P) (piece 0 has none: zeros),
        "has_match" and "eps" (L-1,); or only pieces ``lo`` to ``hi``
        (exclusive), built from those knots alone."""
        hi = self.coeffs.shape[-2] - 1 if hi is None else hi
        x = torch.movedim(self.coeffs[..., lo:hi + 1, :], -2, 0)   # (hi-lo+1, ..., C)
        # Piece i's matching polynomial is the (i-1)-th: (hi-lo, ..., C, P).
        mc = torch.movedim(self.matching_coeffs[..., max(lo - 1, 0):hi - 1, :, :], -3, 0)
        if lo == 0:
            mc = torch.cat([mc.new_zeros((1,) + mc.shape[1:]), mc], dim=0)
        return {
            "x0": x[:-1].contiguous(),
            "dxdt": (x[1:] - x[:-1]).contiguous(),  # unit knot spacing
            "mc": mc.contiguous(),
            "has_match": torch.arange(lo, hi, device=x.device) > 0,
            "eps": torch.full((hi - lo,), self.eps, dtype=x.dtype, device=x.device),
        }

    @staticmethod
    def piece_derivative(piece, frac):
        match_d = _polyval_descending(_derivative_coefficients(piece["mc"]), frac)
        in_match = piece["has_match"] & (frac < piece["eps"])
        return torch.where(in_match, match_d, piece["dxdt"])

    @staticmethod
    def piece_evaluate(piece, frac):
        match_v = _polyval_descending(piece["mc"], frac)
        in_match = piece["has_match"] & (frac < piece["eps"])
        return torch.where(in_match, match_v, piece["x0"] + frac * piece["dxdt"])


def linear_rectilinear_hybrid(data: np.ndarray, rectilinear_indices: list,
                              time_index: int = 0) -> np.ndarray:
    """Linear interpolation on densely-sampled channels and change-point-
    compressed rectilinear interpolation on sparse channels.  Runs on the
    host (numpy): the change-point compression gives ragged lengths, which
    are padded with the final value (NaN pad, then forward fill)."""
    if not isinstance(rectilinear_indices, list):
        raise TypeError("rectilinear_indices must be a list")
    data = np.array(data, copy=True)
    n_channels = data.shape[-1]
    time_and_rect = [time_index] + rectilinear_indices
    non_rect = [i for i in range(n_channels) if i not in time_and_rect]

    if non_rect:
        filled = linear_interpolation_coeffs(torch.from_numpy(data[..., non_rect]),
                                             initial_value_if_nan=0.0)
        data[..., non_rect] = filled.numpy()

    full_rect = linear_interpolation_coeffs(torch.from_numpy(data), rectilinear=0,
                                            initial_value_if_nan=0.0).numpy()

    # Shift slowly-varying channels so their change spans the inter-knot
    # interval instead of the instantaneous (t, t+eps) jump.
    if non_rect:
        shifted = np.concatenate(
            [full_rect[..., 1:, :][..., non_rect], full_rect[..., -1:, :][..., non_rect]],
            axis=-2)
        full_rect[..., non_rect] = shifted

    # Drop rows where neither time nor any rectilinear channel changed.
    deltas = full_rect[..., :-1, time_and_rect] - full_rect[..., 1:, time_and_rect]
    change = (deltas != 0).sum(axis=-1) > 0
    change = np.concatenate([np.ones_like(change[..., :1], dtype=bool), change], axis=-1)

    rows = [fr[c] for fr, c in zip(full_rect, change)]
    max_len = max(r.shape[0] for r in rows)
    out = np.full((len(rows), max_len, n_channels), np.nan, dtype=full_rect.dtype)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return _forward_fill(torch.from_numpy(out), axis=-2).numpy()
