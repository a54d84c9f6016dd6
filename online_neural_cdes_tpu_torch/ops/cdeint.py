"""``cdeint``: the fixed-grid piece-scan solve of dz = f(z) dX.

PyTorch counterpart of the fixed-grid branch of the JAX package's
``ops/cdeint.py``: ``_piece_field``, ``_fixed_scan_forward``, the paired
rectilinear scan ``_fixed_scan_forward_paired`` and the fixed-method branch
of ``cdeint`` with ``return_stats``.  The scans are Python loops over the
knot intervals; inside interval i the field is pinned to piece i of the
control.  Step sizes are host floats taken from the spline's knot times
(``LinearInterpolation.host_grid``), so a solve on the card enqueues its
kernels without reading anything back.

``adjoint=`` is accepted: the adjoint's forward is this same scan.  Its
backward, and the adaptive solvers behind the generic branch, come with
later slices (ROADMAP items 6 and 12).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from online_neural_cdes_tpu_torch.ops import solvers

__all__ = ["cdeint"]


def _piece_field(spline_cls, func, vector_field_type: str):
    """Piece-pinned field: pf(piece, t, frac, z, args) with frac = t - t0.
    The port's fields are fused: ``func(t, z, dx, args)`` returns the
    contracted (..., H) derivative."""

    if vector_field_type == "matmul_fused":

        def pf(piece, t, frac, z, args):
            return func(t, z, spline_cls.piece_derivative(piece, frac), args)

    elif vector_field_type in ("matmul", "evaluate", "derivative"):
        raise NotImplementedError(
            f"vector_field_type={vector_field_type!r} is not ported yet "
            "(ROADMAP item 14: the rest of the model zoo)"
        )
    else:
        raise ValueError(f"Unknown vector_field_type {vector_field_type!r}")

    def pf_state_dtype(piece, t, frac, z, args):
        # dz/dt carries the state's storage dtype (no-op for f32 states).
        return pf(piece, t, frac, z, args).to(z.dtype)

    return pf_state_dtype


def _piece(pieces: dict, i: int) -> dict:
    return {k: v[i] for k, v in pieces.items()}


def _one_interval(step, pf, piece, t0, t1, z, args, substeps):
    dt = (t1 - t0) / substeps

    def f(tt, zz):
        return pf(piece, tt, tt - t0, zz, args)

    for k in range(substeps):
        z = step(f, t0 + k * dt, dt, z).to(z.dtype)
    return z


def _fixed_scan_forward(pf, z0, grid_t, pieces, args, method, substeps):
    """States at every knot, (L, ..., H)."""
    step = solvers.tree_fixed_step(method)
    zs = [z0]
    for i in range(len(grid_t) - 1):
        zs.append(_one_interval(step, pf, _piece(pieces, i), grid_t[i],
                                grid_t[i + 1], zs[-1], args, substeps))
    return torch.stack(zs, dim=0)


def _fixed_scan_forward_paired(pf_even, pf_odd, z0, grid_t, pieces, args,
                               method, substeps):
    """The rectilinear paired scan: even intervals (time advance, only the
    time channel of dX is nonzero) run the cheap ``pf_even``, odd intervals
    (value update) the full field.  States at every knot, (L, ..., H)."""
    step = solvers.tree_fixed_step(method)
    zs = [z0]
    for i in range(0, len(grid_t) - 2, 2):
        z_mid = _one_interval(step, pf_even, _piece(pieces, i), grid_t[i],
                              grid_t[i + 1], zs[-1], args, substeps)
        z_end = _one_interval(step, pf_odd, _piece(pieces, i + 1),
                              grid_t[i + 1], grid_t[i + 2], z_mid, args,
                              substeps)
        zs += [z_mid, z_end]
    return torch.stack(zs, dim=0)


def _t_matches_grid(t, grid_t, spline) -> bool:
    """True iff the requested times are the spline's full knot grid or its
    2-point interval -- the piece scan's contract.  A device tensor's
    values are not read (that would sync the card): as the JAX package
    does for traced arrays, the shapes having matched, the documented
    contract (the model passes ``grid_points`` / ``interval``) is
    trusted."""
    if t is grid_t or t.device.type != "cpu":
        return True
    grid = spline.host_grid()
    values = t.tolist()
    if len(values) == len(grid) and values == list(grid):
        return True
    return len(values) == 2 and values[0] == grid[0] and values[1] == grid[-1]


def _resolve_substeps(options: dict, grid) -> int:
    """Substeps per knot interval: an explicit ``substeps`` wins, else
    ``ceil(widest interval / step_size)``, else 1 (the JAX package's
    ``_substeps_from_options``)."""
    substeps = int(options.get("substeps", 0))
    if substeps:
        return substeps
    if options.get("step_size") is not None:
        spacing = max(b - a for a, b in zip(grid[:-1], grid[1:]))
        return max(1, math.ceil(spacing / float(options["step_size"]) - 1e-9))
    return 1


def cdeint(
    X,
    func: Callable[..., torch.Tensor],
    z0: torch.Tensor,
    t: torch.Tensor,
    args: Any = None,
    *,
    adjoint: bool = True,
    vector_field_type: str = "matmul_fused",
    method: str = "rk4",
    atol: float = 1e-6,
    rtol: float = 1e-4,
    options: Optional[dict] = None,
    adjoint_options: Optional[dict] = None,
    return_stats: bool = False,
    even_func: Optional[Callable] = None,
):
    """Solve dz = f(t, z) dX(t), returning z at the requested times with
    the time axis at position -2: ``(..., len(t), hidden)``.

    ``func(t, z, dx, args)`` is a fused field (``vector_field_type=
    "matmul_fused"``): it returns f(z) contracted with dX/dt, (..., H).
    The unfused ``"matmul"`` field, which returns the (..., H, I) matrix,
    comes back with the model zoo (ROADMAP item 14).

    ``t`` is the spline's full knot grid (return sequences) or its 2-point
    interval (final state only).  ``even_func``: an optional cheap field
    for the EVEN knot intervals (the rectilinear time-advance intervals,
    whose control derivative is nonzero only in the time channel), same
    signature as ``func``; it needs an even number of intervals.
    ``atol``/``rtol``/``adjoint_options`` belong to the adaptive solvers
    and the adjoint's backward, which later slices port.
    """
    del atol, rtol
    options = dict(options or {})
    t = torch.as_tensor(t)
    grid_t = X.grid_points
    n_knots = grid_t.shape[0]

    use_piece_scan = (
        method in solvers.FIXED_METHODS
        and hasattr(X, "piece_data")
        and t.shape[0] in (2, n_knots)
        and _t_matches_grid(t, grid_t, X)
    )
    if not use_piece_scan:
        raise NotImplementedError(
            f"cdeint with method={method!r} or output times other than the "
            "knot grid / its interval is not ported yet (ROADMAP item 12: "
            "the generic cdeint path and the adaptive solvers)"
        )
    if adjoint_options and adjoint_options.get("method", method) not in solvers.FIXED_METHODS:
        raise ValueError(
            f"fixed-grid adjoint_options method {adjoint_options['method']!r} "
            f"must be one of {solvers.FIXED_METHODS}"
        )

    grid = X.host_grid()
    substeps = _resolve_substeps(options, grid)
    pieces = X.piece_data()
    paired = even_func is not None and (n_knots - 1) % 2 == 0 and n_knots > 2
    spline_cls = type(X)
    if paired:
        zs = _fixed_scan_forward_paired(
            _piece_field(spline_cls, even_func, vector_field_type),
            _piece_field(spline_cls, func, vector_field_type),
            z0, grid, pieces, args, method, substeps,
        )
    else:
        zs = _fixed_scan_forward(
            _piece_field(spline_cls, func, vector_field_type),
            z0, grid, pieces, args, method, substeps,
        )
    if t.shape[0] == 2 and n_knots != 2:
        zs = torch.stack([zs[0], zs[-1]])
    # Solver output is time-major (T, ..., H); models want (..., T, H).
    zs = torch.movedim(zs, 0, -2)
    if return_stats:
        n_steps = (n_knots - 1) * substeps
        stats = {
            "nfe": torch.tensor(n_steps * solvers.FIXED_NFE_PER_STEP[method],
                                dtype=torch.int32),
            "accepted": torch.tensor(n_steps, dtype=torch.int32),
            "rejected": torch.tensor(0, dtype=torch.int32),
        }
        return zs, stats
    return zs
