"""``cdeint``: the fixed-grid piece-scan solve of dz = f(z) dX, and its
interval adjoint.

PyTorch counterpart of the fixed-grid branch of the JAX package's
``ops/cdeint.py``: ``_piece_field``, ``_fixed_scan_forward``, the paired
rectilinear scan ``_fixed_scan_forward_paired``, the interval adjoints
``_fixed_cde_adjoint`` / ``_fixed_cde_adjoint_paired`` with their shared
``_interval_adjoint_bwd``, and the fixed-method branch of ``cdeint`` with
``return_stats``.  The scans are Python loops over the knot intervals;
inside interval i the field is pinned to piece i of the control.  Step
sizes are host floats from the spline's knot times (``host_grid``), so a
solve on the card enqueues its kernels without reading anything back.

Gradients:

- ``adjoint=True``: a ``torch.autograd.Function`` whose forward is the scan
  under no grad, keeping the knot states, and whose backward re-integrates
  the augmented state (z, a_z, a_piece, a_args) interval by interval in
  reverse with the same steppers.  Each reverse stage evaluates the field
  on detached inputs under ``torch.enable_grad()`` and takes
  ``torch.autograd.grad`` with the adjoint as the cotangent, so on the card
  it is one forward and one backward launch of the fused field's kernels.
  Used only when some input requires grad and grad mode is on; a serving
  forward never builds it.
- ``adjoint=False``: autograd straight through the scan, with
  ``options={"remat": True}`` as ``torch.utils.checkpoint`` per interval
  (per interval pair on the paired scan).

The adaptive solvers behind the generic branch come with a later slice
(ROADMAP item 12).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

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


def _remat(fn, remat: bool):
    """``fn`` recomputed in the backward instead of keeping its
    activations (JAX ``jax.checkpoint``), when asked and grad is on."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _fixed_scan_forward(pf, z0, grid_t, pieces, args, method, substeps,
                        remat=False):
    """States at every knot, (L, ..., H)."""
    step = solvers.tree_fixed_step(method)
    interval = _remat(partial(_one_interval, step, pf), remat)
    zs = [z0]
    for i in range(len(grid_t) - 1):
        zs.append(interval(_piece(pieces, i), grid_t[i], grid_t[i + 1], zs[-1],
                           args, substeps))
    return torch.stack(zs, dim=0)


def _fixed_scan_forward_paired(pf_even, pf_odd, z0, grid_t, pieces, args,
                               method, substeps, remat=False):
    """The rectilinear paired scan: even intervals (time advance, only the
    time channel of dX is nonzero) run the cheap ``pf_even``, odd intervals
    (value update) the full field.  States at every knot, (L, ..., H)."""
    step = solvers.tree_fixed_step(method)

    def pair(pe, po, ta, tb, tc, z, args):
        z_mid = _one_interval(step, pf_even, pe, ta, tb, z, args, substeps)
        return z_mid, _one_interval(step, pf_odd, po, tb, tc, z_mid, args, substeps)

    pair = _remat(pair, remat)
    zs = [z0]
    for i in range(0, len(grid_t) - 2, 2):
        zs += pair(_piece(pieces, i), _piece(pieces, i + 1), grid_t[i],
                   grid_t[i + 1], grid_t[i + 2], zs[-1], args)
    return torch.stack(zs, dim=0)


# ---------------------------------------------------------------------------
# Interval adjoint
# ---------------------------------------------------------------------------


def _flatten(tree):
    """Tensor leaves of nested dicts/lists/tuples, and a function that
    rebuilds the tree from a list of new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [], lambda leaves: tree
    sizes = [len(p[0]) for p in parts]
    leaves = [t for p in parts for t in p[0]]

    def rebuild(new):
        out, pos = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(new[pos:pos + n]))
            pos += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def _interval_adjoint_bwd(step, pf, piece, piece_wrt, t0, t1, z_end, a, args,
                          args_wrt, args_bar, substeps):
    """Reverse one knot interval of the augmented adjoint state ``(z, a_z,
    a_piece, a_args)`` with the tuple stepper (JAX
    ``_interval_adjoint_bwd``): in the substituted time s = -tau the field
    is ``(-f, vjp_z, vjp_piece, vjp_args)``.  ``piece`` is this interval's
    piece with detached leaves, ``piece_wrt`` those of its leaves whose
    cotangent is integrated; ``args_wrt`` the detached leaves of ``args``
    whose cotangents ``args_bar`` carries.  Shared by the plain and the
    paired adjoints.  Returns ``(a at t0, args_bar', piece_bar)``."""
    dt = (t1 - t0) / substeps
    wrt = list(piece_wrt) + list(args_wrt)

    def aug_f(s, live):
        z, a_ = live
        tau = -s
        with torch.enable_grad():
            z_ = z.detach().requires_grad_()
            f = pf(piece, tau, tau - t0, z_, args)
            vjps = torch.autograd.grad(f, [z_, *wrt], a_, allow_unused=True)
        return (-f.detach(), *vjps)

    aug = (z_end, a, *[torch.zeros_like(p) for p in piece_wrt], *args_bar)
    for k in range(substeps):
        out = step(aug_f, -t1 + k * dt, dt, aug)
        aug = tuple(o.to(r.dtype) for o, r in zip(out, aug))
    n_p = len(piece_wrt)
    return aug[1], list(aug[2 + n_p:]), list(aug[2:2 + n_p])


class _Setup:
    """What the adjoint Functions need besides tensors: the piece fields,
    the knot times (host floats), the steppers' settings and how to
    rebuild the pieces and the field arguments from flat leaves."""

    def __init__(self, pfs, grid, piece_keys, rebuild_args, method, substeps,
                 adj_method, adj_substeps):
        self.pfs = pfs
        self.grid = grid
        self.piece_keys = piece_keys
        self.rebuild_args = rebuild_args
        self.method = method
        self.substeps = substeps
        self.adj_method = adj_method
        self.adj_substeps = adj_substeps

    def split(self, leaves):
        n = len(self.piece_keys)
        return dict(zip(self.piece_keys, leaves[:n])), list(leaves[n:])

    def scan(self, z0, leaves):
        """The forward scan (paired when ``pfs`` has an even field): states
        at every knot."""
        pieces, arg_leaves = self.split(leaves)
        args = self.rebuild_args(arg_leaves)
        if len(self.pfs) == 2:
            return _fixed_scan_forward_paired(*self.pfs, z0, self.grid, pieces, args,
                                              self.method, self.substeps)
        return _fixed_scan_forward(self.pfs[0], z0, self.grid, pieces, args,
                                   self.method, self.substeps)


class _ReverseSolve:
    """The backward's shared state: the knot states, detached pieces and
    field arguments, which of them need cotangents, and the running
    ``args_bar``."""

    def __init__(self, ctx, setup: _Setup):
        zs, *leaves = ctx.saved_tensors
        pieces, arg_leaves = setup.split(leaves)
        need = ctx.needs_input_grad[2:]
        n_p = len(setup.piece_keys)
        self.zs = zs
        self.setup = setup
        self.pieces = pieces
        self.piece_need = [k for k, n in zip(setup.piece_keys, need[:n_p]) if n]
        self.arg_need = list(need[n_p:])
        self.arg_leaves = [t.detach().requires_grad_(n)
                           for t, n in zip(arg_leaves, self.arg_need)]
        self.args = setup.rebuild_args(self.arg_leaves)
        self.args_wrt = [t for t, n in zip(self.arg_leaves, self.arg_need) if n]
        self.args_bar = [torch.zeros_like(t) for t in self.args_wrt]
        self.step = solvers.tree_fixed_step(setup.adj_method, live=2)
        self.piece_bars = {k: [None] * (len(setup.grid) - 1) for k in self.piece_need}

    def interval(self, pf, i, a):
        """Reverse interval i (knots i -> i+1) from the adjoint ``a`` at
        knot i+1; returns ``a`` at knot i."""
        piece = {k: v[i].detach().requires_grad_(k in self.piece_need)
                 for k, v in self.pieces.items()}
        a, self.args_bar, piece_bar = _interval_adjoint_bwd(
            self.step, pf, piece, [piece[k] for k in self.piece_need],
            self.setup.grid[i], self.setup.grid[i + 1], self.zs[i + 1], a,
            self.args, self.args_wrt, self.args_bar, self.setup.adj_substeps)
        for k, bar in zip(self.piece_need, piece_bar):
            self.piece_bars[k][i] = bar
        return a

    def grads(self, a0):
        """The Function's input cotangents: (None, z0, *pieces, *args)."""
        piece_grads = [torch.stack(self.piece_bars[k]) if k in self.piece_bars
                       else None for k in self.setup.piece_keys]
        bars = iter(self.args_bar)
        arg_grads = [next(bars) if n else None for n in self.arg_need]
        return (None, a0, *piece_grads, *arg_grads)


class _FixedCDEAdjoint(torch.autograd.Function):
    """JAX ``_fixed_cde_adjoint``: the piece scan forward (run with no
    autograd graph, keeping the knot states), the interval adjoint
    backward.  Inputs ``(setup, z0, *piece leaves, *arg leaves)``; output
    the knot states (L, ..., H)."""

    @staticmethod
    def forward(ctx, setup, z0, *leaves):
        zs = setup.scan(z0, leaves)
        ctx.setup = setup
        ctx.save_for_backward(zs, *leaves)
        return zs

    @staticmethod
    def backward(ctx, grad_zs):
        rev = _ReverseSolve(ctx, ctx.setup)
        a = torch.zeros_like(grad_zs[0])
        for i in range(len(ctx.setup.grid) - 2, -1, -1):
            a = rev.interval(ctx.setup.pfs[0], i, a + grad_zs[i + 1])
        return rev.grads(a + grad_zs[0])


class _FixedCDEAdjointPaired(_FixedCDEAdjoint):
    """JAX ``_fixed_cde_adjoint_paired``: the paired rectilinear scan
    forward (``setup.pfs = (pf_even, pf_odd)``); the backward reverses
    each pair, odd interval first."""

    @staticmethod
    def backward(ctx, grad_zs):
        pf_even, pf_odd = ctx.setup.pfs
        rev = _ReverseSolve(ctx, ctx.setup)
        a = torch.zeros_like(grad_zs[0])
        for i in range(len(ctx.setup.grid) - 3, -1, -2):
            a = rev.interval(pf_odd, i + 1, a + grad_zs[i + 2])
            a = rev.interval(pf_even, i, a + grad_zs[i + 1])
        return rev.grads(a + grad_zs[0])


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

    ``adjoint=True`` differentiates by the interval adjoint, whose reverse
    solve may use its own fixed method and substeps
    (``adjoint_options={"method", "substeps" or "step_size"}``);
    ``adjoint=False`` by autograd through the scan, with
    ``options={"remat": True}`` recomputing each interval in the backward.
    Gradients reach ``z0``, the tensors of ``args`` (any nesting of dicts,
    lists and tuples) and the spline's coefficients.  ``atol``/``rtol``
    belong to the adaptive solvers, which a later slice ports.
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
    adj = dict(adjoint_options or {})
    adj_method = str(adj.get("method", method))
    if adj_method not in solvers.FIXED_METHODS:
        raise ValueError(
            f"fixed-grid adjoint_options method {adj_method!r} "
            f"must be one of {solvers.FIXED_METHODS}"
        )

    grid = X.host_grid()
    substeps = _resolve_substeps(options, grid)
    if "substeps" in adj or "step_size" in adj:
        adj_substeps = _resolve_substeps(
            {k: v for k, v in adj.items() if k in ("substeps", "step_size")}, grid)
    else:
        adj_substeps = substeps
    remat = bool(options.get("remat", False))
    pieces = X.piece_data()
    paired = even_func is not None and (n_knots - 1) % 2 == 0 and n_knots > 2
    spline_cls = type(X)
    pf = _piece_field(spline_cls, func, vector_field_type)
    pfs = ((_piece_field(spline_cls, even_func, vector_field_type), pf)
           if paired else (pf,))

    piece_keys = sorted(pieces)
    arg_leaves, rebuild_args = _flatten(args)
    leaves = [pieces[k] for k in piece_keys] + arg_leaves
    if adjoint and torch.is_grad_enabled() and any(
            t_.requires_grad for t_ in (z0, *leaves)):
        setup = _Setup(pfs, grid, piece_keys, rebuild_args, method, substeps,
                       adj_method, adj_substeps)
        function = _FixedCDEAdjointPaired if paired else _FixedCDEAdjoint
        zs = function.apply(setup, z0, *leaves)
    elif paired:
        zs = _fixed_scan_forward_paired(pfs[0], pf, z0, grid, pieces, args,
                                        method, substeps, remat and not adjoint)
    else:
        zs = _fixed_scan_forward(pf, z0, grid, pieces, args, method, substeps,
                                 remat and not adjoint)
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
