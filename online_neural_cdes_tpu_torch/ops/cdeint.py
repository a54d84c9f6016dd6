"""``cdeint``: the fixed-grid piece-scan solve of dz = f(z) dX with its
interval adjoint, the generic path over ``odeint``, and ``odeint_adjoint``.

PyTorch counterpart of the JAX package's ``ops/cdeint.py``: ``_piece_field``,
``_fixed_scan_forward``, the paired rectilinear scan
``_fixed_scan_forward_paired``, the interval adjoints ``_fixed_cde_adjoint``
/ ``_fixed_cde_adjoint_paired`` with their shared ``_interval_adjoint_bwd``,
``_make_cde_field``, ``odeint_adjoint``, and ``cdeint`` with
``return_stats``, for the fused field (``"matmul_fused"``) and the plain
``"matmul"``, ``"evaluate"`` and ``"derivative"`` fields.  The scans are
Python loops over the knot intervals; inside interval i the field is
pinned to piece i of the control.  Step
sizes are host floats from the spline's knot times (``host_grid``), so a
solve on the card enqueues its kernels without reading anything back.

Gradients of the piece scan:

- ``adjoint=True``: a ``torch.autograd.Function`` whose forward is the scan
  under no grad, keeping the knot states, and whose backward re-integrates
  the augmented state (z, a_z, a_piece, a_args) interval by interval in
  reverse with the same steppers.  Each reverse stage evaluates the field
  on detached inputs under ``torch.enable_grad()`` and takes
  ``torch.autograd.grad`` with the adjoint as the cotangent, so on the card
  the fused field makes one forward and one backward launch of its
  kernels.
  Used only when some input requires grad and grad mode is on; a serving
  forward never builds it.
- ``adjoint=False``: autograd straight through the scan, with
  ``options={"remat": True}`` as ``torch.utils.checkpoint`` per interval
  (per interval pair on the paired scan).

The generic path (adaptive methods, other output times) solves with
``solvers.odeint`` over the field at ``X.derivative(t)`` (or ``X(t)``);
``adjoint=True`` differentiates by ``odeint_adjoint`` (the augmented state
integrated in reverse, each reverse stage one field evaluation and its
VJP), ``adjoint=False`` by the differentiable solve's replay.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from online_neural_cdes_tpu_torch.ops import reduce as _reduce
from online_neural_cdes_tpu_torch.ops import solvers
from online_neural_cdes_tpu_torch.utils.profiling import span
from online_neural_cdes_tpu_torch.utils.tree import flatten, map_arrays

__all__ = ["cdeint", "odeint_adjoint"]


def _contract(mat, dx):
    """The field matrix against the control's derivative, (..., H, I) x
    (..., I) -> (..., H)."""
    return torch.einsum("...hi,...i->...h", mat, dx)


def _make_cde_field(func, vector_field_type: str):
    """The generic path's field dz/dt with ``theta = (X, args)`` (JAX
    ``_make_cde_field``), so the adjoint's cotangents reach the spline's
    tensors: ``"matmul"``, ``func(t, z, args)`` (..., H, I) contracted with
    X'(t) (a ``TupleControl``: one matrix per control, summed);
    ``"evaluate"`` / ``"derivative"``, ``func(t, [z, X(t)] or [z, X'(t)],
    args)``; ``"matmul_fused"``, ``func(t, z, X'(t), args)``.
    ``X.derivative`` / ``X.evaluate`` look the piece up on the device (the
    right-hand piece at a knot)."""

    if vector_field_type == "matmul":

        def vf(t, z, theta):
            X_, args = theta
            mat, dx = func(t, z, args), X_.derivative(t)
            if isinstance(dx, tuple):
                if not (isinstance(mat, tuple) and len(mat) == len(dx)):
                    raise ValueError("a TupleControl needs one field matrix per control")
                return sum(_contract(m, d) for m, d in zip(mat, dx))
            return _contract(mat, dx)

    elif vector_field_type in ("evaluate", "derivative"):

        def vf(t, z, theta):
            X_, args = theta
            vals = X_.evaluate(t) if vector_field_type == "evaluate" else X_.derivative(t)
            vals = vals if isinstance(vals, tuple) else (vals,)
            return func(t, torch.cat([z, *vals], dim=-1), args)

    elif vector_field_type == "matmul_fused":

        def vf(t, z, theta):
            X_, args = theta
            return func(t, z, X_.derivative(t), args)

    else:
        raise ValueError(f"Unknown vector_field_type {vector_field_type!r}")
    return vf


def _piece_field(spline_cls, func, vector_field_type: str):
    """Piece-pinned field: pf(piece, t, frac, z, args) with frac = t - t0,
    for the field types of :func:`_make_cde_field`."""

    if vector_field_type == "matmul":

        def pf(piece, t, frac, z, args):
            return _contract(func(t, z, args), spline_cls.piece_derivative(piece, frac))

    elif vector_field_type == "evaluate":

        def pf(piece, t, frac, z, args):
            return func(t, torch.cat([z, spline_cls.piece_evaluate(piece, frac)], dim=-1),
                        args)

    elif vector_field_type == "derivative":

        def pf(piece, t, frac, z, args):
            return func(t, torch.cat([z, spline_cls.piece_derivative(piece, frac)], dim=-1),
                        args)

    elif vector_field_type == "matmul_fused":

        def pf(piece, t, frac, z, args):
            return func(t, z, spline_cls.piece_derivative(piece, frac), args)

    else:
        raise ValueError(f"Unknown vector_field_type {vector_field_type!r}")

    def pf_state_dtype(piece, t, frac, z, args):
        # dz/dt carries the state's storage dtype (no-op for f32 states).
        return pf(piece, t, frac, z, args).to(z.dtype)

    return pf_state_dtype


def _piece(pieces: dict, i: int) -> dict:
    return {k: v[i] for k, v in pieces.items()}


def _split_pairs(pieces: dict):
    """The even and the odd pieces of a paired scan (JAX ``_split_pairs``):
    ``({k: v[0::2]}, {k: v[1::2]})``."""
    return ({k: v[0::2] for k, v in pieces.items()},
            {k: v[1::2] for k, v in pieces.items()})


def _one_interval(step, pf, piece, t0, dt, z, args, substeps):
    """One knot interval from ``t0`` in ``substeps`` steps of the host
    float ``dt``."""

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


def _export_scan(body, z0, pieces, grid_t, stride, args):
    """The knot loop as ``torch.export`` records it: one
    ``torch._higher_order_ops.scan.scan`` over groups of ``stride``
    intervals (JAX ``lax.scan``), with the pieces and the intervals' start
    times (float64, the host values) as the scanned inputs and the substep
    a host float, so an exported program does the loop's own arithmetic.
    ``body(pieces, t0s, dt, z, args)`` returns the group's ``stride``
    states; ``args`` reach it as copies (a scan's inputs may not alias one
    another, and packed weights are views of one another).  Needs knot
    intervals of one width (a grid built from a shape is the unit grid).
    States at every knot, (L, ..., H)."""
    from torch._higher_order_ops.scan import scan

    widths = {b - a for a, b in zip(grid_t[:-1], grid_t[1:])}
    if len(widths) != 1:
        raise ValueError("an exported solve needs knot intervals of one width; the "
                         f"grid has widths {sorted(widths)}")
    dt = widths.pop()
    xs = ({k: v.unflatten(0, (-1, stride)) for k, v in pieces.items()},
          torch.tensor(grid_t[:-1], dtype=torch.float64, device=z0.device)
          .unflatten(0, (-1, stride)))

    args = map_arrays(args, torch.clone)

    def combine(z, x):
        group, t0s = x
        states = body([{k: v[j] for k, v in group.items()} for j in range(stride)],
                      [t0s[j] for j in range(stride)], dt, z, args)
        return states[-1].clone(), torch.stack(states)

    _, states = scan(combine, z0, xs)               # (groups, stride, ..., H)
    return torch.cat([z0[None], states.flatten(0, 1)], dim=0)


def _fixed_scan_forward(pf, z0, grid_t, pieces, args, method, substeps,
                        remat=False):
    """States at every knot, (L, ..., H).  A Python loop over the
    intervals; while ``torch.export`` traces, the same interval function
    under :func:`_export_scan`."""
    step = solvers.tree_fixed_step(method)
    interval = _remat(partial(_one_interval, step, pf), remat)
    if torch.compiler.is_exporting():
        return _export_scan(
            lambda ps, ts, dt, z, a: [interval(ps[0], ts[0], dt / substeps, z, a, substeps)],
            z0, pieces, grid_t, 1, args)
    zs = [z0]
    for i in range(len(grid_t) - 1):
        zs.append(interval(_piece(pieces, i), grid_t[i],
                           (grid_t[i + 1] - grid_t[i]) / substeps, zs[-1], args, substeps))
    return torch.stack(zs, dim=0)


def _fixed_scan_forward_paired(pf_even, pf_odd, z0, grid_t, pieces, args,
                               method, substeps, remat=False):
    """The rectilinear paired scan: even intervals (time advance, only the
    time channel of dX is nonzero) run the cheap ``pf_even``, odd intervals
    (value update) the full field.  States at every knot, (L, ..., H); a
    Python loop over the pairs, or :func:`_export_scan` while exporting."""
    step = solvers.tree_fixed_step(method)

    def pair(pe, po, ta, dta, tb, dtb, z, args):
        z_mid = _one_interval(step, pf_even, pe, ta, dta, z, args, substeps)
        return z_mid, _one_interval(step, pf_odd, po, tb, dtb, z_mid, args, substeps)

    pair = _remat(pair, remat)
    if torch.compiler.is_exporting():
        return _export_scan(
            lambda ps, ts, dt, z, a: pair(ps[0], ps[1], ts[0], dt / substeps, ts[1],
                                          dt / substeps, z, a),
            z0, pieces, grid_t, 2, args)
    zs = [z0]
    for i in range(0, len(grid_t) - 2, 2):
        ta, tb, tc = grid_t[i], grid_t[i + 1], grid_t[i + 2]
        zs += pair(_piece(pieces, i), _piece(pieces, i + 1), ta, (tb - ta) / substeps,
                   tb, (tc - tb) / substeps, zs[-1], args)
    return torch.stack(zs, dim=0)


# ---------------------------------------------------------------------------
# Interval adjoint
# ---------------------------------------------------------------------------


def _interval_adjoint_bwd(step, pf, piece, piece_wrt, t0, t1, z_end, a, args,
                          args_wrt, args_bar, substeps, return_state=False):
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
    out = aug[1], list(aug[2 + n_p:]), list(aug[2:2 + n_p])
    return (aug[0], *out) if return_state else out


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
        with span("oncde.cdeint.scan"):
            if len(self.pfs) == 2:
                return _fixed_scan_forward_paired(*self.pfs, z0, self.grid, pieces, args,
                                                  self.method, self.substeps)
            return _fixed_scan_forward(self.pfs[0], z0, self.grid, pieces, args,
                                       self.method, self.substeps)


class _ReverseSolve:
    """The backward's shared state: the knot states, detached pieces and
    field arguments, which of them need cotangents, and the running
    ``args_bar``."""

    def __init__(self, ctx, setup: _Setup, lanes=None):
        zs, *leaves = ctx.saved_tensors
        pieces, arg_leaves = setup.split(leaves)
        # K lanes (``lanes``: each leaf's lane dim, 0 or None): the states
        # are (K, L, ..., H) and the pieces and args as they came.
        need = ctx.needs_input_grad[2 if lanes is None else 3:]
        n_p = len(setup.piece_keys)
        self.lanes = lanes
        if lanes is not None:
            self.piece_dims, arg_dims = setup.split(lanes)
            self.arg_dims = list(arg_dims)
            zs = zs.movedim(1, 0)                     # knot-major: zs[i] is (K, ..., H)
        self.zs = zs
        self.setup = setup
        self.pieces = pieces
        self.piece_need = [k for k, n in zip(setup.piece_keys, need[:n_p]) if n]
        self.arg_need = list(need[n_p:])
        self.arg_leaves = [t.detach().requires_grad_(n)
                           for t, n in zip(arg_leaves, self.arg_need)]
        # The K-lane field rebuilds the args from their leaves inside its vmap.
        self.args = (setup.rebuild_args(self.arg_leaves) if lanes is None
                     else self.arg_leaves)
        self.args_wrt = [t for t, n in zip(self.arg_leaves, self.arg_need) if n]
        self.args_bar = [torch.zeros_like(t) for t in self.args_wrt]
        self.step = solvers.tree_fixed_step(setup.adj_method, live=2)
        self.piece_bars = {k: [None] * (len(setup.grid) - 1) for k in self.piece_need}

    def lane_field(self, pf):
        """``pf`` for K lanes (:func:`_lane_field`)."""
        return _lane_field(pf, self.piece_dims, self.arg_dims, self.setup.rebuild_args)

    def interval(self, pf, i, a):
        """Reverse interval i (knots i -> i+1) from the adjoint ``a`` at
        knot i+1; returns ``a`` at knot i."""
        lane_piece = self.lanes is not None
        piece = {k: (v[:, i] if lane_piece and self.piece_dims[k] == 0 else v[i])
                 .detach().requires_grad_(k in self.piece_need)
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
        piece_grads = [torch.stack(self.piece_bars[k], dim=1 if self.lanes is not None
                                   and self.piece_dims[k] == 0 else 0)
                       if k in self.piece_bars else None for k in self.setup.piece_keys]
        bars = iter(self.args_bar)
        arg_grads = [next(bars) if n else None for n in self.arg_need]
        return (None, a0, *piece_grads, *arg_grads)


def _lane_major(k, tensor, dim):
    """A vmap rule's operand with its lane dim first: moved (a view), or an
    unbatched one expanded over the lanes (its gradient sums over them)."""
    if dim is None:
        return tensor.expand((k,) + tuple(tensor.shape))
    return tensor.movedim(dim, 0)


def _needs_adjoint(tensors) -> bool:
    """Whether a solve is differentiated: grad mode on and an input that
    requires grad, or a ``torch.func.vmap`` lane tensor (the wave's step,
    whose lanes report no ``requires_grad``; its vmap rule decides)."""
    return torch.is_grad_enabled() and any(
        x.requires_grad or torch._C._functorch.is_batchedtensor(x) for x in tensors)


class _FixedCDEAdjoint(torch.autograd.Function):
    """JAX ``_fixed_cde_adjoint``: the piece scan forward (run with no
    autograd graph, keeping the knot states), the interval adjoint
    backward.  Inputs ``(setup, z0, *piece leaves, *arg leaves)``; output
    the knot states (L, ..., H).  Under ``torch.func.vmap`` (a wave's K
    models sharing the grid and the pieces, their weights batched) its
    ``vmap`` rule records :class:`_FixedCDEAdjointLanes`, as
    ``jax.vmap`` batches the JAX ``custom_vjp``."""

    @staticmethod
    def forward(setup, z0, *leaves):
        return setup.scan(z0, leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        setup, _, *leaves = inputs
        ctx.setup = setup
        ctx.save_for_backward(output, *leaves)

    @staticmethod
    def backward(ctx, grad_zs):
        with span("oncde.cdeint.adjoint"):
            rev = _ReverseSolve(ctx, ctx.setup)
            a = torch.zeros_like(grad_zs[0])
            for i in range(len(ctx.setup.grid) - 2, -1, -1):
                a = rev.interval(ctx.setup.pfs[0], i, a + grad_zs[i + 1])
            return rev.grads(a + grad_zs[0])

    @staticmethod
    def vmap(info, in_dims, setup, z0, *leaves):
        k = info.batch_size
        dims = [None if d is None else 0 for d in in_dims[2:]]
        leaves = [t if d is None else t.movedim(d, 0) for t, d in zip(leaves, in_dims[2:])]
        zs = _FixedCDEAdjointLanes.apply(setup, dims, _lane_major(k, z0, in_dims[1]), *leaves)
        return zs, 0


class _FixedCDEAdjointPaired(_FixedCDEAdjoint):
    """JAX ``_fixed_cde_adjoint_paired``: the paired rectilinear scan
    forward (``setup.pfs = (pf_even, pf_odd)``); the backward reverses
    each pair, odd interval first."""

    @staticmethod
    def backward(ctx, grad_zs):
        with span("oncde.cdeint.adjoint"):
            pf_even, pf_odd = ctx.setup.pfs
            rev = _ReverseSolve(ctx, ctx.setup)
            a = torch.zeros_like(grad_zs[0])
            for i in range(len(ctx.setup.grid) - 3, -1, -2):
                a = rev.interval(pf_odd, i + 1, a + grad_zs[i + 2])
                a = rev.interval(pf_even, i, a + grad_zs[i + 1])
            return rev.grads(a + grad_zs[0])


def _lane_field(pf, piece_dims, arg_dims, rebuild_args):
    """The K-lane piece field: ``pf`` under ``torch.func.vmap`` over the
    lanes' states and weights (the pieces shared unless batched), so the
    fused field takes its kernels' multi entries.  ``args`` is the list of
    arg leaves."""

    def lanes(piece, t, frac, z, arg_leaves):
        def one(piece, z, arg_leaves):
            return pf(piece, t, frac, z, rebuild_args(list(arg_leaves)))

        mapped = torch.func.vmap(one, in_dims=({k: piece_dims[k] for k in piece}, 0,
                                                list(arg_dims)))
        return mapped(piece, z, list(arg_leaves))

    return lanes


class _FixedCDEAdjointLanes(torch.autograd.Function):
    """The interval adjoint of K lanes (what :class:`_FixedCDEAdjoint`'s
    vmap rule records): inputs ``(setup, dims, z0 (K, ..., H), *piece
    leaves, *arg leaves)``, a leaf batched along dim 0 where ``dims`` says
    0 and shared where it says None.  The forward is the piece scan under
    ``torch.func.vmap`` (4 forward-multi launches an RK4 interval on the
    card); the backward reverses each interval for every lane at once with
    plain autograd over the vmapped field (per RK4 interval 4 forward-multi
    and 4 backward-multi launches, the serial adjoint's 8 / 4 single
    ones).  Output the lanes' knot states (K, L, ..., H)."""

    @staticmethod
    def forward(setup, dims, z0, *leaves):
        return torch.func.vmap(setup.scan, in_dims=(0, list(dims)))(z0, list(leaves))

    @staticmethod
    def setup_context(ctx, inputs, output):
        setup, dims, _, *leaves = inputs
        ctx.setup, ctx.dims = setup, dims
        ctx.save_for_backward(output, *leaves)

    @staticmethod
    def backward(ctx, grad_zs):
        with span("oncde.cdeint.adjoint"):
            setup = ctx.setup
            rev = _ReverseSolve(ctx, setup, lanes=ctx.dims)
            a = torch.zeros_like(grad_zs[:, 0])
            n = len(setup.grid) - 1
            if len(setup.pfs) == 2:
                pf_even, pf_odd = (rev.lane_field(pf) for pf in setup.pfs)
                for i in range(n - 2, -1, -2):
                    a = rev.interval(pf_odd, i + 1, a + grad_zs[:, i + 2])
                    a = rev.interval(pf_even, i, a + grad_zs[:, i + 1])
            else:
                pf = rev.lane_field(setup.pfs[0])
                for i in range(n - 1, -1, -1):
                    a = rev.interval(pf, i, a + grad_zs[:, i + 1])
            return (None, *rev.grads(a + grad_zs[:, 0]))


# ---------------------------------------------------------------------------
# Adjoint odeint (generic; the adaptive path, and public)
# ---------------------------------------------------------------------------


class _AdjointSetup:
    """What ``_OdeintAdjoint`` needs besides tensors: the field, the
    forward and reverse solves' settings, and how to rebuild the state and
    ``args`` from flat leaves."""

    def __init__(self, func, rebuild_y, n_y, rebuild_args, rtol, atol, method,
                 options, adjoint_options, row_args=None):
        self.func = func
        self.row_args = row_args
        self.rebuild_y, self.n_y, self.rebuild_args = rebuild_y, n_y, rebuild_args
        self.rtol, self.atol, self.method = rtol, atol, method
        self.options = options
        adj = dict(adjoint_options or {})
        self.adj_method = adj.pop("method", method)
        self.adj_rtol = adj.pop("rtol", rtol)
        self.adj_atol = adj.pop("atol", atol)
        # 'seminorm': adapt steps on the (y, a) blocks only, ignoring the
        # parameter-gradient block (reference adjoint.py:235-281).  Other
        # norm values pass through to the reverse solver.
        norm = adj.pop("norm", None)
        self.seminorm = norm == "seminorm"
        adj_options = adj or dict(options)
        if norm is not None and not self.seminorm:
            adj_options = {**adj_options, "norm": norm}
        # The reverse pass integrates in s = -tau, so declared
        # discontinuities at tau0 sit at s = -tau0.
        for key in ("step_t", "jump_t"):
            if adj_options.get(key) is not None:
                grid = adj_options[key]
                adj_options = {**adj_options, key: -(grid if isinstance(grid, torch.Tensor)
                                                      else np.asarray(grid))}
        self.adj_options = adj_options

    def solve(self, y_leaves, t, arg_leaves):
        return solvers.odeint(self.func, self.rebuild_y(list(y_leaves)), t,
                              self.rebuild_args(list(arg_leaves)), rtol=self.rtol,
                              atol=self.atol, method=self.method,
                              options=dict(self.options))

    def reverse_options(self, n_args: int) -> dict:
        """The reverse solves' options (``seminorm``: the parameter-gradient
        blocks weigh 0 in the step control).  Over a data axis
        (``ops/reduce.py``) they mark the augmented state's leaves that hold
        this rank's part of a sum over the rows -- ``vt`` and the cotangent
        of every argument that is not itself split by rows (the weights,
        the knot times) -- so the step decisions take their totals, as one
        process over the whole batch does (ROADMAP item 18c)."""
        opts = dict(self.adj_options)
        if self.seminorm:
            opts["error_weights"] = [1.0] * (2 * self.n_y + 1) + [0.0] * n_args
        if _reduce.group() is not None:
            rows = self.row_args or [False] * n_args
            opts["summed_leaves"] = [False] * (2 * self.n_y) + [True] + [not r for r in rows]
        return opts

    # K lanes (``_OdeintAdjointLanes``)

    def flat(self, tt, y_leaves, arg_leaves):
        """The field of one lane on flat leaves."""
        return flatten(self.func(tt, self.rebuild_y(list(y_leaves)),
                                 self.rebuild_args(list(arg_leaves))))[0]

    def lane_func(self, k, arg_leaves):
        """The K-lane field over (K, ...) arg leaves: ``func_k(t, y)``."""
        mapped = torch.func.vmap(self.flat, in_dims=(0, 0, 0))
        return lambda t, y: mapped(t, list(y), list(arg_leaves))

    @staticmethod
    def lane_solve(options, rtol, atol, method, t_host, y_leaves, tuple_state) -> dict:
        """``solvers.odeint_lanes``' settings as ``solvers.odeint`` would
        take them for these leaves (a tuple state's error per leaf unless
        ``norm="rms"``)."""
        options = dict(options)
        per_leaf = tuple_state and options.pop("norm", None) != "rms"
        options.pop("norm", None)
        time_dtype = (y_leaves[0].dtype if method in solvers.ADAPTIVE_METHODS
                      else solvers._time_dtype(np.asarray(t_host)))
        return dict(rtol=rtol, atol=atol, method=method, options=options,
                    per_leaf=per_leaf, time_dtype=time_dtype)


class _OdeintAdjoint(torch.autograd.Function):
    """JAX ``_odeint_adjoint``: the forward solve with no autograd graph;
    the backward integrates the augmented state ``(y, a, vt, args_bar)``
    in reverse over each output interval, in the substituted time s = -tau
    (so it runs forward in s), with the forward's solver or
    ``adjoint_options``'.  Every leaf of ``args`` gets its cotangent
    integrated (its block is part of the error norm) whether or not it
    requires grad, and ``vt``, the output times' gradient, is integrated
    always.  Inputs ``(setup, t, *y0 leaves, *arg leaves)``; outputs the
    state's leaves at every output time.  Under ``torch.func.vmap`` its
    ``vmap`` rule records :class:`_OdeintAdjointLanes`."""

    @staticmethod
    def forward(setup, t, *leaves):
        ys = setup.solve(leaves[:setup.n_y], t, leaves[setup.n_y:])
        return tuple(flatten(ys)[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        setup, t, *leaves = inputs
        ctx.setup = setup
        ctx.save_for_backward(t, *leaves[setup.n_y:], *output)

    @staticmethod
    def backward(ctx, *grad_ys):
        setup = ctx.setup
        t, *rest = ctx.saved_tensors
        n_y = setup.n_y
        arg_leaves, ys = rest[:len(rest) - n_y], rest[len(rest) - n_y:]
        grad_ys = [torch.zeros_like(y) if g is None else g for g, y in zip(grad_ys, ys)]
        args_d = [leaf.detach() for leaf in arg_leaves]
        args_tree = setup.rebuild_args(args_d)
        func = setup.func
        dtype = ys[0].dtype
        device = ys[0].device

        def aug_dynamics(s, aug, _):
            """(-f, a df/dy, a df/dtau, a df/dargs) at tau = -s: the
            reference's augmented dynamics (adjoint.py:73-106) under the
            s-substitution.  An input f does not use gets a zero
            cotangent, as ``jax.vjp`` gives."""
            y, a = aug[:n_y], aug[n_y:2 * n_y]
            with torch.enable_grad():
                tau = (-s).detach().requires_grad_()
                y_ = [leaf.detach().requires_grad_() for leaf in y]
                th = [leaf.detach().requires_grad_() for leaf in args_d]
                f = flatten(func(tau, setup.rebuild_y(y_), setup.rebuild_args(th)))[0]
                inputs = [tau, *y_, *th]
                vjps = torch.autograd.grad(f, inputs, list(a), allow_unused=True)
            vjps = [torch.zeros_like(x) if v is None else v for v, x in zip(vjps, inputs)]
            return (*[-fl.detach() for fl in f], *vjps[1:1 + n_y], vjps[0],
                    *vjps[1 + n_y:])

        t_host = solvers._host(t)
        a = [torch.zeros_like(y[0]) for y in ys]
        vt = torch.zeros((), dtype=dtype, device=device)
        args_bar = [torch.zeros_like(leaf) for leaf in args_d]
        t_bar = [None] * len(t_host)
        opts = setup.reverse_options(len(args_d))
        with solvers.counting_as("reverse"):
            for i in range(len(t_host) - 1, 0, -1):
                y_i = [y[i] for y in ys]
                g_i = [g[i] for g in grad_ys]
                # Moving output time t_i shifts where the loss samples the
                # trajectory: dL/dt_i = g_i . f(t_i, y_i), and the integrated
                # vjp_t drops by the same (reference adjoint.py:116-124).
                t_i = torch.full((), float(t_host[i]), dtype=t.dtype, device=device)
                f_i = flatten(func(t_i, setup.rebuild_y(y_i), args_tree))[0]
                solvers._count(evals=1)
                dl_dt = sum((g * f).sum() for g, f in zip(g_i, f_i)).to(dtype)
                vt = vt - dl_dt
                a = [al + gl for al, gl in zip(a, g_i)]
                s_span = np.array([-t_host[i], -t_host[i - 1]], dtype=t_host.dtype)
                path = solvers.odeint(aug_dynamics, (*y_i, *a, vt, *args_bar), s_span,
                                      rtol=setup.adj_rtol, atol=setup.adj_atol,
                                      method=setup.adj_method, options=dict(opts))
                aug1 = [p[-1] for p in path]
                a, vt, args_bar = aug1[n_y:2 * n_y], aug1[2 * n_y], aug1[2 * n_y + 1:]
                t_bar[i] = dl_dt
        a = [al + g[0] for al, g in zip(a, grad_ys)]
        t_bar[0] = vt
        t_grad = (torch.stack(t_bar).to(t.dtype).to(t.device)
                  if ctx.needs_input_grad[1] else None)
        need_args = ctx.needs_input_grad[2 + n_y:]
        return (None, t_grad, *a,
                *[bar if need else None for bar, need in zip(args_bar, need_args)])

    @staticmethod
    def vmap(info, in_dims, setup, t, *leaves):
        k = info.batch_size
        # Every leaf per lane: each lane integrates its own cotangent of a
        # shared argument (a spline's coefficients) in its reverse solve,
        # as its serial backward does; the expand sums them.  Output times
        # that differ between lanes come stacked (K, T).
        leaves = [_lane_major(k, leaf, d) for leaf, d in zip(leaves, in_dims[2:])]
        t = t if in_dims[1] is None else t.movedim(in_dims[1], 0)
        out = _OdeintAdjointLanes.apply(setup, t, *leaves)
        return out, (0,) * len(out)


class _OdeintAdjointLanes(torch.autograd.Function):
    """``odeint_adjoint`` for K lanes (what :class:`_OdeintAdjoint`'s vmap
    rule records): inputs ``(setup, t, *y0 leaves, *arg leaves)``, every
    leaf (K, ...), ``t`` the output times the lanes share, (T,), or each
    lane's own, (K, T): a lane then reverses over its own intervals and its
    times' gradient is its own.  The forward is the K-lane solve
    (:func:`solvers.odeint_lanes`, the field under ``torch.func.vmap``)
    with no graph; the backward, under plain autograd, integrates every
    lane's augmented state ``(y, a, vt, args_bar)`` in reverse over each
    output interval with the K-lane controller, each reverse stage one
    K-lane field evaluation and its VJP.  ``seminorm`` leaves each lane's
    parameter-gradient block out of its own step control."""

    @staticmethod
    def forward(setup, t, *leaves):
        k = leaves[0].shape[0]
        t_host = solvers._host(t)
        func_k = setup.lane_func(k, leaves[setup.n_y:])
        y0 = list(leaves[:setup.n_y])
        ys, _ = solvers.odeint_lanes(func_k, y0, t_host, k, grid_of=lambda c: solvers.lane_grids(
                                         c, setup.func, setup.rebuild_y, y0, t,
                                         None if t.dim() == 1 else 0),
                                     **setup.lane_solve(
                                         setup.options, setup.rtol, setup.atol, setup.method,
                                         t_host, leaves[:setup.n_y], not isinstance(
                                             setup.rebuild_y(list(leaves[:setup.n_y])),
                                             torch.Tensor)))
        return tuple(ys)

    @staticmethod
    def setup_context(ctx, inputs, output):
        setup, t, *leaves = inputs
        ctx.setup = setup
        ctx.save_for_backward(t, *leaves[setup.n_y:], *output)

    @staticmethod
    def backward(ctx, *grad_ys):
        setup = ctx.setup
        t, *rest = ctx.saved_tensors
        n_y = setup.n_y
        arg_leaves, ys = rest[:len(rest) - n_y], rest[len(rest) - n_y:]
        k = ys[0].shape[0]
        grad_ys = [torch.zeros_like(y) if g is None else g for g, y in zip(grad_ys, ys)]
        args_d = [leaf.detach() for leaf in arg_leaves]
        func_k = setup.lane_func(k, args_d)
        mapped = torch.func.vmap(setup.flat, in_dims=(0, 0, 0))
        dtype, device = ys[0].dtype, ys[0].device

        def aug_dynamics(s, aug):
            """:class:`_OdeintAdjoint`'s augmented dynamics for every lane:
            ``s`` the (K,) times."""
            y, a = aug[:n_y], aug[n_y:2 * n_y]
            with torch.enable_grad():
                tau = (-s).detach().requires_grad_()
                y_ = [leaf.detach().requires_grad_() for leaf in y]
                th = [leaf.detach().requires_grad_() for leaf in args_d]
                f = mapped(tau, y_, th)
                inputs = [tau, *y_, *th]
                vjps = torch.autograd.grad(f, inputs, list(a), allow_unused=True)
            vjps = [torch.zeros_like(x) if v is None else v for v, x in zip(vjps, inputs)]
            return [*[-fl.detach() for fl in f], *vjps[1:1 + n_y], vjps[0],
                    *vjps[1 + n_y:]]

        t_host = solvers._host(t)
        lane_times = t_host.ndim == 2
        t_rows = np.stack(solvers._lane_rows(t_host, k))     # each lane's times
        a = [torch.zeros_like(y[:, 0]) for y in ys]
        vt = torch.zeros(k, dtype=dtype, device=device)
        args_bar = [torch.zeros_like(leaf) for leaf in args_d]
        n_t = t_host.shape[-1]
        t_bar = [None] * n_t
        opts = setup.reverse_options(len(args_d))
        with solvers.counting_as("reverse"):
            for i in range(n_t - 1, 0, -1):
                y_i = [y[:, i] for y in ys]
                g_i = [g[:, i] for g in grad_ys]
                f_i = func_k(solvers._column(t_rows[:, i], t.dtype, device), y_i)
                solvers._count(evals=k, lane_evals=1)
                # Each lane's dL/dt_i as its serial backward sums it.
                dl_dt = torch.stack([sum((g[j] * f[j]).sum() for g, f in zip(g_i, f_i))
                                     for j in range(k)]).to(dtype)
                vt = vt - dl_dt
                a = [al + gl for al, gl in zip(a, g_i)]
                s_span = np.stack([-t_host[..., i], -t_host[..., i - 1]], axis=-1)
                aug0 = [*y_i, *a, vt, *args_bar]
                # A grid_constructor sees the lanes' augmented states and
                # spans (the field of one lane's reverse solve is not
                # formed: it gets None).
                span = torch.from_numpy(s_span.astype(np.float64)).to(t.dtype)
                path, _ = solvers.odeint_lanes(
                    aug_dynamics, aug0, s_span, k, grid_of=lambda c: solvers.lane_grids(
                        c, None, tuple, aug0, span, None if span.dim() == 1 else 0),
                    **setup.lane_solve(opts, setup.adj_rtol, setup.adj_atol, setup.adj_method,
                                       s_span, aug0, True))
                aug1 = [p[:, -1] for p in path]
                a, vt, args_bar = aug1[n_y:2 * n_y], aug1[2 * n_y], aug1[2 * n_y + 1:]
                t_bar[i] = dl_dt
        a = [al + g[:, 0] for al, g in zip(a, grad_ys)]
        t_bar[0] = vt
        t_grad = (torch.stack(t_bar, dim=1).to(t.dtype).to(t.device)
                  if ctx.needs_input_grad[1] else None)
        if t_grad is not None and not lane_times:
            t_grad = t_grad.sum(0)           # t is shared by the lanes
        need_args = ctx.needs_input_grad[2 + n_y:]
        return (None, t_grad, *a,
                *[bar if need else None for bar, need in zip(args_bar, need_args)])


def odeint_adjoint(
    func: Callable[[Any, Any, Any], Any],
    y0,
    t,
    args=None,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    options: Optional[dict] = None,
    adjoint_options: Optional[dict] = None,
    row_args: Optional[list] = None,
):
    """``odeint`` whose gradient integrates the adjoint system backwards
    (O(1) memory in the solve's length).  ``adjoint_options`` may set the
    reverse solve's ``method`` / ``rtol`` / ``atol`` / ``norm``
    (``"seminorm"`` leaves the parameter-gradient block out of the step
    control) and its solver options (by default the forward's).  Gradients
    reach ``y0``, ``t`` and the tensors of ``args`` (nested dicts, lists,
    tuples and splines).  With no gradient needed it is ``odeint``.

    Over a mesh's data axis (``parallel.mesh.data_reductions``) the state's
    leaves are this rank's rows, and ``row_args`` says, for each tensor of
    ``args`` in order, whether it is split by rows too (a spline's
    coefficients); the others (by default all) are shared, so their
    cotangents are sums over every rank's rows, which the reverse solve's
    step decisions take whole."""
    if not isinstance(t, torch.Tensor) and not torch.compiler.is_exporting():
        # (A traced program keeps host times as numpy: it makes no tensor
        # it would have to read back.)
        t = torch.as_tensor(np.asarray(t))
    # Resolve grid-from-step_size against the concrete output times: the
    # reverse solves integrate one output interval at a time.
    options = dict(options or {})
    if solvers._batched((t,)) and any("step_size" in (o or {}) and not (o or {}).get("substeps")
                                      for o in (options, adjoint_options)):
        raise ValueError(solvers._TRACED_STEP_SIZE)    # JAX's rule for traced times
    if "step_size" in options:
        options["substeps"] = _resolve_substeps(options, solvers._host(t))
        options.pop("step_size")
    if adjoint_options and "step_size" in adjoint_options:
        adjoint_options = dict(adjoint_options)
        adjoint_options["substeps"] = _resolve_substeps(adjoint_options,
                                                        solvers._host(t))
        adjoint_options.pop("step_size")
    y_leaves, rebuild_y = flatten(y0)
    arg_leaves, rebuild_args = flatten(args)
    if not _needs_adjoint((t, *y_leaves, *arg_leaves)):
        return solvers.odeint(func, y0, t, args, rtol=rtol, atol=atol, method=method,
                              options=options)
    setup = _AdjointSetup(func, rebuild_y, len(y_leaves), rebuild_args, rtol, atol,
                          method, options, adjoint_options, row_args)
    if setup.adj_method == "scipy_solver":
        solvers.refuse_rank_local(f"odeint_adjoint's reverse {setup.adj_method!r} solve")
    return rebuild_y(list(_OdeintAdjoint.apply(setup, t, *y_leaves, *arg_leaves)))


# ---------------------------------------------------------------------------
# cdeint
# ---------------------------------------------------------------------------


def _t_matches_grid(t, grid_t, spline) -> bool:
    """True iff the requested times are the spline's full knot grid or its
    2-point interval -- the piece scan's contract.  A device tensor's
    values are not read (that would sync the card): as the JAX package
    does for traced arrays, the shapes having matched, the documented
    contract (the model passes ``grid_points`` / ``interval``) is
    trusted.  The spline's own ``interval`` is not read either, so an
    exported model takes its knot times from the shapes alone."""
    if t is grid_t or t.device.type != "cpu" or (
            not t.requires_grad and t is getattr(spline, "_interval", None)):
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


def _shared_leaf_ids(X) -> set:
    """The ids of a spline's knot times (its ``t`` fields, nested splines'
    too): the tensors of ``X`` that its rows share."""
    fields = getattr(type(X), "tree_fields", None)
    if isinstance(X, (list, tuple)):
        return set().union(*[_shared_leaf_ids(v) for v in X])
    if fields is None:
        return set()
    out = set()
    for name in fields:
        value = getattr(X, name)
        if name == "t" and isinstance(value, torch.Tensor):
            out.add(id(value))
        else:
            out |= _shared_leaf_ids(value)
    return out


def _generic_cdeint(X, func, z0, t, args, adjoint, vector_field_type, method, atol,
                    rtol, options, adjoint_options, return_stats):
    """JAX ``cdeint``'s generic branch (see :func:`cdeint`)."""
    vf = _make_cde_field(func, vector_field_type)
    if not t.requires_grad:
        # The solvers step with host times: the knot grid's host copy (all
        # of it, or the end points for the spline's interval), or one read
        # of the times.
        if t is X.grid_points or t is X.interval:
            grid = X.host_grid()
            grid = grid if t is X.grid_points else (grid[0], grid[-1])
            # A traced program makes no host tensor: its times stay numpy.
            t = (np.asarray(grid, dtype=solvers._NUMPY[t.dtype])
                 if torch.compiler.is_exporting() else torch.tensor(grid, dtype=t.dtype))
        else:
            t = solvers._host_tensor(t)
    if torch.compiler.is_exporting():
        # The traced solve's loops take the spline's and the arguments'
        # tensors as inputs, which may not alias one another (a spline's
        # pieces are views of its coefficients): copies.
        leaves, rebuild = flatten(X)
        X = rebuild([leaf.clone() for leaf in leaves])
        args = map_arrays(args, torch.clone)
    theta = (X, args)
    if "step_size" in options:
        options["substeps"] = _resolve_substeps(options, solvers._host(t))
        options.pop("step_size")
    if adjoint_options and "step_size" in adjoint_options:
        adjoint_options = dict(adjoint_options)
        adjoint_options["substeps"] = _resolve_substeps(adjoint_options,
                                                        solvers._host(t))
        adjoint_options.pop("step_size")
    stats = None
    if adjoint:
        if return_stats:
            # Adaptive NFE is data-dependent: one more forward solve.
            with torch.no_grad():
                _, stats = solvers.odeint(vf, z0, t, theta, rtol=rtol, atol=atol,
                                          method=method, options=dict(options),
                                          return_stats=True)
        shared = _shared_leaf_ids(X)
        zs = odeint_adjoint(vf, z0, t, theta, rtol=rtol, atol=atol, method=method,
                            options=options, adjoint_options=adjoint_options,
                            row_args=[id(leaf) not in shared for leaf in flatten(X)[0]]
                            + [False] * len(flatten(args)[0]))
    else:
        zs, stats = solvers.odeint(vf, z0, t, theta, rtol=rtol, atol=atol,
                                   method=method,
                                   options={**options, "differentiable": True},
                                   return_stats=True)
    zs = torch.movedim(zs, 0, -2)
    if return_stats:
        return zs, stats
    return zs


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

    ``vector_field_type``: ``"matmul_fused"``, ``func(t, z, dx, args)``
    returns f(z) contracted with dX/dt, (..., H); ``"matmul"``,
    ``func(t, z, args)`` returns the (..., H, I) matrix, contracted here
    (a ``TupleControl`` sums one matrix per control); ``"evaluate"`` /
    ``"derivative"``, ``func(t, [z, X(t)] or [z, dX/dt], args)`` returns
    dz/dt, (..., H).

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
    belong to the generic path.

    Any other ``t``, a spline without the piece API, or a method outside
    ``FIXED_METHODS`` takes the generic path: ``odeint`` over the field
    ``func(t, z, X.derivative(t), args)``, differentiated by
    ``odeint_adjoint`` (``adjoint=True``; ``return_stats`` then costs one
    more forward solve under no grad) or by the differentiable solve, the
    accepted-step grid replayed with grad (``adjoint=False``).
    ``even_func`` is not used there.
    """
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
        if torch.compiler.is_exporting():
            # The adaptive and Adams solves trace into their tensor form
            # (``solvers._adaptive_integrate_traced``, ``_adams_scan``).
            if method == "scipy_solver":
                raise ValueError(
                    "a 'scipy_solver' solve cannot be exported: it steps in scipy on the "
                    "host, which a traced program cannot carry (nor can the JAX package's "
                    "exporter)")
            if not (t is X.grid_points or t is X.interval):
                raise ValueError(
                    "output times other than the knot grid or its interval cannot be "
                    "exported: an exported solve takes its times from the spline's "
                    "host grid")
        return _generic_cdeint(X, func, z0, t, args, adjoint, vector_field_type, method,
                               atol, rtol, options, adjoint_options, return_stats)
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
    arg_leaves, rebuild_args = flatten(args)
    leaves = [pieces[k] for k in piece_keys] + arg_leaves
    if adjoint and _needs_adjoint((z0, *leaves)):
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
