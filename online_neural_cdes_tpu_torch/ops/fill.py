"""NaN-aware fills along one axis.

PyTorch counterpart of the JAX package's ``ops/fill.py``: the same
vectorised ``cummax``/gather formulation (``torch.cummax`` for
``lax.cummax``), the same semantics.  Series are ``(..., length,
channels)`` blocks with NaN for a missing value.  ``tridiagonal_solve`` is
the Thomas algorithm batched over leading dims, with Python loops over the
system's length in place of ``lax.scan``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["forward_fill", "backward_fill", "linear_fill", "tridiagonal_solve"]


def _last_observed_index(mask: torch.Tensor) -> torch.Tensor:
    """For each position i, the largest j <= i with mask[..., j] True, else
    -1.  mask: (..., L) boolean, time on the last axis."""
    length = mask.shape[-1]
    idx = torch.arange(length, dtype=torch.int64, device=mask.device)
    observed_idx = torch.where(mask, idx, torch.full_like(idx, -1))
    return torch.cummax(observed_idx, dim=-1).values


def _next_observed_index(mask: torch.Tensor) -> torch.Tensor:
    """For each position i, the smallest j >= i with mask True, else L."""
    length = mask.shape[-1]
    rev_last = _last_observed_index(torch.flip(mask, dims=(-1,)))
    return (length - 1) - torch.flip(rev_last, dims=(-1,))


def forward_fill(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Carry the last observed (non-NaN) value forward along ``axis``.
    Positions before the first observation stay NaN."""
    x = torch.movedim(x, axis, -1)
    last = _last_observed_index(~torch.isnan(x))
    gathered = torch.gather(x, -1, last.clamp(min=0))
    out = torch.where(last >= 0, gathered, x)
    return torch.movedim(out, -1, axis)


def backward_fill(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Mirror of :func:`forward_fill`: carry the next observation backward."""
    x = torch.movedim(x, axis, -1)
    out = torch.flip(forward_fill(torch.flip(x, dims=(-1,)), axis=-1),
                     dims=(-1,))
    return torch.movedim(out, -1, axis)


def linear_fill(x: torch.Tensor, t: Optional[torch.Tensor] = None,
                axis: int = -2) -> torch.Tensor:
    """NaN infill used by linear interpolation coefficients: interior NaNs
    are linearly interpolated between the neighbouring observations, NaNs
    before the first / after the last observation copy the nearest one, and
    an all-NaN series becomes zeros."""
    x = torch.movedim(x, axis, -1)
    length = x.shape[-1]
    if t is None:
        t = torch.arange(length, dtype=x.dtype, device=x.device)
    t = torch.broadcast_to(t.to(x.dtype), x.shape)

    mask = ~torch.isnan(x)
    prev_i = _last_observed_index(mask)
    next_i = _next_observed_index(mask)

    prev_ic = prev_i.clamp(0, length - 1)
    next_ic = next_i.clamp(0, length - 1)
    x_prev = torch.gather(x, -1, prev_ic)
    x_next = torch.gather(x, -1, next_ic)
    t_prev = torch.gather(t, -1, prev_ic)
    t_next = torch.gather(t, -1, next_ic)

    denom = t_next - t_prev
    ratio = (t - t_prev) / torch.where(denom == 0, torch.ones_like(denom), denom)
    interp = x_prev + ratio * (x_next - x_prev)

    has_prev = prev_i >= 0
    has_next = next_i < length
    filled = torch.where(
        mask,
        x,
        torch.where(has_prev & has_next, interp,
                    torch.where(has_prev, x_prev, x_next)),
    )
    all_nan = ~torch.any(mask, dim=-1, keepdim=True)
    filled = torch.where(all_nan, torch.zeros_like(filled), filled)
    return torch.movedim(filled, -1, axis)


def tridiagonal_solve(b: torch.Tensor, a_upper: torch.Tensor, a_diagonal: torch.Tensor,
                      a_lower: torch.Tensor) -> torch.Tensor:
    """Thomas-algorithm solve of a tridiagonal system, batched over leading
    dims: every batch element sweeps its band in lockstep.  Shapes: ``b``,
    ``a_diagonal``: (..., N); ``a_upper``, ``a_lower``: (..., N-1)."""
    n = b.shape[-1]
    if n == 1:
        return b / a_diagonal
    cs = [a_upper[..., 0] / a_diagonal[..., 0]]
    ds = [b[..., 0] / a_diagonal[..., 0]]
    for i in range(1, n):
        lower = a_lower[..., i - 1]
        denom = a_diagonal[..., i] - lower * cs[-1]
        upper = a_upper[..., i] if i < n - 1 else torch.zeros_like(denom)
        cs.append(upper / denom)
        ds.append((b[..., i] - lower * ds[-1]) / denom)
    xs = [ds[-1]]
    for i in range(n - 2, -1, -1):
        xs.append(ds[i] - cs[i] * xs[-1])
    return torch.stack(xs[::-1], dim=-1)
