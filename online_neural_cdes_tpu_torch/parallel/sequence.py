"""Sequence-sharded CDE solve over ``torch.distributed``: the time-pipelined
piece scan.

PyTorch counterpart of the JAX package's ``parallel/sequence.py``.  A
Neural CDE solve is a sequential recurrence over knot intervals, so it
pipelines over time: the knot axis of the per-piece coefficients is split
into ``n`` chunks along a mesh's ``seq`` axis, the batch into ``M``
microbatches, and each microbatch's hidden state streams from rank to
rank -- rank k integrates knot chunk k.  While rank k advances microbatch m
through chunk k, rank k+1 advances microbatch m-1 through chunk k+1 (GPipe
over time).  Across devices that buys:

- **memory**: a rank builds and keeps only its chunk of the pieces (1/n
  of the knots, and with a data axis 1/n_data of the rows) and its
  activations, so a series n times longer fits; the caller's observations
  or coefficients, the whole series, stay where the caller put them;
- **wall clock**: ``M + n - 1`` ticks of ``L/n`` intervals each, about n
  times fewer sequential interval latencies than the plain scan for
  ``M >> n``.

Where JAX runs one SPMD program that computes masked garbage in the fill
and drain ticks and hands states on with ``ppermute``, here each rank is a
process that computes only its valid ticks (microbatch ``s - k`` at tick
``s``) and hands a microbatch's ``(b, H)`` state to the next rank of its
``seq`` line by a point-to-point send (``dist.isend`` / ``dist.recv`` on
the axis's group, to global ranks from :meth:`Mesh.neighbour`).  Over gloo
a CUDA state is staged through host memory, since gloo sends CPU tensors
only (the backend's transport, not the pipeline's); NCCL sends it from the
device.  The pick is by ``dist.get_backend``.

**The caller's view is JAX's.**  Every rank passes the whole spline, ``z0``
and ``args`` and gets back the same global result: the terminal states
broadcast from the last ``seq`` rank, the per-knot states gathered over
the ``seq`` (and ``data``) group.  The fused field runs on its kernels on
the card: every tick's field call launches kernel 1 (``csrc/fused_field.cu``),
every reverse stage of the adjoint and every field VJP of the direct
backward kernel 2 (``csrc/fused_field_bwd.cu``).

**Gradients.**  ``adjoint=False`` differentiates straight through the
ticks: a receive whose backward sends the cotangent back, a send whose
backward receives it.  The backward then runs the reverse microbatch
order on every rank (autograd runs the ready node made last first, and a
microbatch's nodes are all made after the previous one's send), so the
blocking receives pair with the sends in the same order on both ends,
as NCCL, which ignores tags, needs.  ``adjoint=True`` is
:class:`_PipelinedAdjoint`: O(1) activation memory in the ticks, the
reverse schedule run explicitly.

**The gradient contract.**  When every rank computes the same loss over
the gathered outputs, the pipeline's backward already gives every rank
the full gradients of ``z0``, the spline's tensors and ``args``: the
cotangents of ``args`` are summed over ``seq`` (and ``data``), those of the
spline's tensors summed over ``seq`` (each rank's chunk reaches its own
knots), those of ``z0`` and the chunk's rows gathered.  So a train step
over a ``seq``-only mesh is built *without* ``mesh=``
(``make_train_step(PipelinedNCDE(model, mesh=mesh))``), and on a ``(data,
seq)`` mesh the step must not all-reduce again.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from online_neural_cdes_tpu_torch.ops import solvers
from online_neural_cdes_tpu_torch.ops.cdeint import (
    _interval_adjoint_bwd,
    _one_interval,
    _piece,
    _piece_field,
    _remat,
    _resolve_substeps,
    _split_pairs,
)
from online_neural_cdes_tpu_torch.parallel.mesh import Mesh, make_grid_mesh
from online_neural_cdes_tpu_torch.utils.tree import flatten

__all__ = ["PipelinedNCDE", "make_sequence_mesh", "ncde_apply_pipelined",
           "pipelined_cde_solve"]


def make_sequence_mesh(n_seq: Optional[int] = None, axis: str = "seq",
                       devices=None) -> Mesh:
    """A 1-D mesh over the world's first ``n_seq`` ranks (all of them by
    default).  The composed mesh is ``make_grid_mesh(("data", "seq"),
    (n_data, n_seq))``."""
    if n_seq is None and dist.is_initialized():
        n_seq = dist.get_world_size()
    return make_grid_mesh((axis,), (n_seq or 1,), devices)


def _fwd_slots(k: int, M: int):
    """The forward schedule of seq rank ``k`` as ``(tick, microbatch)``
    pairs in the order it runs them: microbatch ``s - k`` at tick ``s``
    (valid in [0, M)); the last rank finishes microbatch ``s - k`` there
    too.  One copy, shared by the direct pipeline and the adjoint's
    forward."""
    return [(m + k, m) for m in range(M)]


def _bwd_slots(k: int, n: int, M: int):
    """The reverse schedule: rank ``k`` reverses microbatch ``M-1 - (s -
    (n-1-k))`` at reverse tick ``s`` (the forward schedule run backwards:
    reverse tick ``M + n - 2 - s_fwd``)."""
    return [((M - 1 - m) + (n - 1 - k), m) for m in range(M - 1, -1, -1)]


def _interleave_pairs(evens: list, odds: list) -> list:
    """``[e0, o0, e1, o1, ...]``: a paired chunk's per-interval results back
    in knot order."""
    return [x for pair in zip(evens, odds) for x in pair]


def _chunk_solve(step, pf, pf_e, z, p_mb, grid, args, substeps):
    """Integrate one microbatch's ``(b, H)`` state through a rank's chunk
    of intervals (knot times ``grid``, host floats).  With ``pf_e`` the
    chunk runs as (even, odd) interval pairs, the rectilinear time-advance
    intervals on the cheap field (the port's paired scan, chunk-local; an
    even chunk length, so pairs never straddle ranks).  Returns ``(z_end,
    zs)``, ``zs[i]`` the state after local interval i, stacked."""

    def width(i):
        return (grid[i + 1] - grid[i]) / substeps

    if pf_e is None:
        zs = []
        for i in range(len(grid) - 1):
            z = _one_interval(step, pf, _piece(p_mb, i), grid[i], width(i), z, args,
                              substeps)
            zs.append(z)
        return z, torch.stack(zs)
    pe, po = _split_pairs(p_mb)
    mids, ends = [], []
    for j in range((len(grid) - 1) // 2):
        z_mid = _one_interval(step, pf_e, _piece(pe, j), grid[2 * j], width(2 * j), z,
                              args, substeps)
        z = _one_interval(step, pf, _piece(po, j), grid[2 * j + 1], width(2 * j + 1),
                          z_mid, args, substeps)
        mids.append(z_mid)
        ends.append(z)
    return z, torch.stack(_interleave_pairs(mids, ends))


def _chunk_adjoint(bwd_step, pf, pf_e, z_end, a, args_bar, p_mb, need, grid, args,
                   args_wrt, substeps, g_chunk):
    """Reverse one microbatch's augmented adjoint state through a rank's
    chunk; the per-knot cotangent ``g_chunk[i]`` (None: none) joins ``a``
    before interval i reverses.  The paired variant mirrors
    :func:`_chunk_solve`'s pairing.  ``need``: the piece keys whose
    cotangents are integrated.  Returns ``(z, a, args_bar)`` at the chunk's
    start and each interval's piece cotangents (a list over the chunk of
    lists over ``need``)."""

    def reverse(pf_i, i, z, a_, ab):
        if g_chunk is not None:
            a_ = a_ + g_chunk[i]
        piece = {key: v[i].detach().requires_grad_(key in need) for key, v in p_mb.items()}
        z, a_, ab, bar = _interval_adjoint_bwd(
            bwd_step, pf_i, piece, [piece[key] for key in need], grid[i], grid[i + 1],
            z, a_, args, args_wrt, ab, substeps, return_state=True)
        return z, a_, ab, bar

    z, bars = z_end, [None] * (len(grid) - 1)
    if pf_e is None:
        for i in range(len(grid) - 2, -1, -1):
            z, a, args_bar, bars[i] = reverse(pf, i, z, a, args_bar)
        return z, a, args_bar, bars
    evens, odds = [None] * (len(bars) // 2), [None] * (len(bars) // 2)
    for j in range(len(bars) // 2 - 1, -1, -1):
        z, a, args_bar, odds[j] = reverse(pf, 2 * j + 1, z, a, args_bar)
        z, a, args_bar, evens[j] = reverse(pf_e, 2 * j, z, a, args_bar)
    return z, a, args_bar, _interleave_pairs(evens, odds)


class _Plan:
    """One call's layout on this rank: its seq index ``k`` of ``n``, its
    data index ``d`` of ``nd``, the chunk of ``Tc`` pieces and the
    ``B/nd`` rows it holds, ``M`` microbatches of ``b_loc`` local rows, the
    neighbours and groups; and the point-to-point sends and receives along
    ``seq``, with the isends still in flight."""

    def __init__(self, mesh: Mesh, axis: str, data_axis: Optional[str], n_pieces: int,
                 B: int, M: int, feat, dtype):
        self.n, self.k = mesh.axis_size(axis), mesh.axis_index(axis)
        self.nd = mesh.axis_size(data_axis) if data_axis is not None else 1
        self.d = mesh.axis_index(data_axis) if data_axis is not None else 0
        self.Tc, self.M = n_pieces // self.n, M
        self.B_loc = B // self.nd
        self.b_loc = self.B_loc // M
        self.feat, self.dtype = tuple(feat), dtype
        self.device = mesh.device
        self.seq_group = mesh.groups[axis]
        self.data_group = mesh.groups[data_axis] if data_axis is not None else None
        self.prev, self.next = mesh.neighbour(axis, -1), mesh.neighbour(axis, 1)
        self.first, self.last = mesh.rank_along(axis, 0), mesh.rank_along(axis, self.n - 1)
        # gloo sends CPU tensors only: a state on the card goes through host memory.
        self.stage = (self.device.type != "cpu"
                      and dist.get_backend(self.seq_group) == "gloo")
        self.pending = []

    @property
    def is_first(self) -> bool:
        return self.k == 0

    @property
    def is_last(self) -> bool:
        return self.k == self.n - 1

    # -- point to point along seq ---------------------------------------

    def _send(self, t, dst, tag):
        t = t.detach()
        t = t.cpu() if self.stage else t.contiguous()
        self.pending.append((dist.isend(t, dst, group=self.seq_group, tag=tag), t))

    def _recv(self, shape, src, tag):
        buf = torch.empty(shape, dtype=self.dtype,
                          device="cpu" if self.stage else self.device)
        dist.recv(buf, src, group=self.seq_group, tag=tag)
        return buf.to(self.device)

    def state_shape(self, lead=()):
        return tuple(lead) + (self.b_loc,) + self.feat

    def send_next(self, t, tag):
        self._send(t, self.next, tag)

    def send_prev(self, t, tag):
        self._send(t, self.prev, tag)

    def recv_prev(self, tag, lead=()):
        return self._recv(self.state_shape(lead), self.prev, tag)

    def recv_next(self, tag, lead=()):
        return self._recv(self.state_shape(lead), self.next, tag)

    def wait(self):
        """Wait for this rank's sends still in flight."""
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()

    # -- this rank's part of the inputs ---------------------------------

    def local_z0(self, z0):
        """This rank's rows of ``z0`` as ``(M, b_loc, ...)``: global row
        ``d*B/nd + m*b_loc + i`` at (m, i), JAX's data-major permutation."""
        rows = z0[self.d * self.B_loc:(self.d + 1) * self.B_loc]
        return rows.to(self.device).reshape((self.M, self.b_loc) + self.feat)

    def local_piece(self, leaf):
        """This rank's part of its chunk's per-piece leaf (time-major, ``Tc``
        pieces): its rows of a batched leaf (batch at axis 1), as a copy on
        its device."""
        if leaf.dim() >= 2:
            leaf = leaf[:, self.d * self.B_loc:(self.d + 1) * self.B_loc]
        return leaf.to(self.device, copy=True, memory_format=torch.contiguous_format)

    def microbatch(self, pieces: dict, m: int) -> dict:
        """Microbatch ``m``'s rows of the chunk's pieces (batch-free
        leaves, ``ndim < 2``, whole)."""
        lo = m * self.b_loc
        return {key: v if v.dim() < 2 else v[:, lo:lo + self.b_loc]
                for key, v in pieces.items()}

    # -- the global outputs ---------------------------------------------

    def _gather(self, t, group, dim):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    def gather_outs(self, outs):
        """The terminal states ``(B, ...)`` on every rank: the last seq
        rank's ``(M, b_loc, ...)`` broadcast over seq, gathered over data."""
        rows = (outs.reshape((self.B_loc,) + self.feat) if self.is_last else
                torch.empty((self.B_loc,) + self.feat, dtype=self.dtype, device=self.device))
        dist.broadcast(rows, self.last, group=self.seq_group)
        return rows if self.data_group is None else self._gather(rows, self.data_group, 0)

    def gather_seq(self, seq):
        """The per-knot states ``(B, n_pieces, ...)`` on every rank from each
        rank's ``(M, Tc, b_loc, ...)``."""
        rows = seq.transpose(1, 2).reshape((self.B_loc, self.Tc) + self.feat)
        rows = self._gather(rows, self.seq_group, 1)
        return rows if self.data_group is None else self._gather(rows, self.data_group, 0)

    def local_cotangent(self, g, sequences):
        """This rank's slice of a replicated output cotangent: ``(M, Tc,
        b_loc, ...)`` of the per-knot states, ``(M, b_loc, ...)`` of the
        terminal ones."""
        rows = g[self.d * self.B_loc:(self.d + 1) * self.B_loc]
        if sequences:
            rows = rows[:, self.k * self.Tc:(self.k + 1) * self.Tc]
            return rows.reshape((self.M, self.b_loc, self.Tc) + self.feat).transpose(1, 2)
        return rows.reshape((self.M, self.b_loc) + self.feat)

    # -- the full cotangents of the inputs ------------------------------

    def full_z0(self, dz0):
        """``dz0`` ``(M, b_loc, ...)`` of seq rank 0 broadcast over seq and
        gathered over data: ``(B, ...)``."""
        rows = dz0.reshape((self.B_loc,) + self.feat).contiguous()
        dist.broadcast(rows, self.first, group=self.seq_group)
        return rows if self.data_group is None else self._gather(rows, self.data_group, 0)

    def full_piece(self, bar):
        """A leaf's cotangent over its whole chunk: gathered over data
        (rows); a batch-free leaf's summed over data."""
        if self.data_group is None:
            return bar
        if bar.dim() >= 2:
            return self._gather(bar, self.data_group, 1)
        bar = bar.contiguous()
        dist.all_reduce(bar, group=self.data_group)
        return bar

    def sum_args(self, bars, groups=None):
        """Cotangents (of ``args``) summed over seq, then data, or over
        ``groups``, in place."""
        for group in groups or (self.seq_group, self.data_group):
            if group is None or not bars:
                continue
            flat = torch.cat([t.reshape(-1) for t in bars])
            dist.all_reduce(flat, group=group)
            offset = 0
            for t in bars:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
        return bars


class _SumOverSeq(torch.autograd.Function):
    """A spline's tensors as they are; the backward sums their cotangents
    over seq.  Each rank builds only its chunk's pieces, which reach only
    its chunk's knots, so the sum gives every rank the whole series'
    cotangents."""

    @staticmethod
    def forward(ctx, plan, *tensors):
        ctx.plan = plan
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.plan.sum_args([g.clone() for g in grads],
                                         groups=(ctx.plan.seq_group,)))


def _chunk_pieces(X, plan: _Plan) -> dict:
    """This rank's ``Tc`` pieces of ``X``, built from its chunk's knots
    alone on ``X``'s device (never the whole series' pieces); with a data
    axis :meth:`_Plan.local_piece` then copies its rows out."""
    names = [name for name in type(X).tree_fields
             if isinstance(getattr(X, name), torch.Tensor) and getattr(X, name).requires_grad]
    if names:
        X = copy.copy(X)
        for name, t in zip(names, _SumOverSeq.apply(plan, *[getattr(X, n) for n in names])):
            setattr(X, name, t)
    k0 = plan.k * plan.Tc
    return X.piece_data(k0, k0 + plan.Tc)


class _Solve:
    """What a call's Functions need besides tensors: the plan, the piece
    fields (``pf_e`` None unless paired), the steppers, the chunk's knot
    times and substeps, the piece keys and how to rebuild ``args``."""

    def __init__(self, plan, pf, pf_e, step, bwd_step, grid, substeps, piece_keys,
                 rebuild_args, sequences, remat):
        self.plan, self.pf, self.pf_e = plan, pf, pf_e
        self.step, self.bwd_step = step, bwd_step
        self.grid, self.substeps = grid, substeps
        self.piece_keys, self.rebuild_args = piece_keys, rebuild_args
        self.sequences, self.remat = sequences, remat

    def split(self, leaves):
        n = len(self.piece_keys)
        return dict(zip(self.piece_keys, leaves[:n])), list(leaves[n:])

    def chunk(self, z, pieces, m, args):
        return _chunk_solve(self.step, self.pf, self.pf_e, z,
                            self.plan.microbatch(pieces, m), self.grid, args, self.substeps)


class _ShardInputs(torch.autograd.Function):
    """This rank's part of the inputs ``(z0, *pieces, *args)``: an anchor
    (the receives' input, so every rank's backward reaches this node), its
    rows of ``z0``, its rows of its chunk's pieces and ``args`` as they
    are.  The backward is the call's one set of collectives on every rank
    but :class:`_SumOverSeq`'s, which follows: the full cotangent of ``z0``
    (seq rank 0's, broadcast, gathered over data), of the chunk's pieces
    (gathered over data) and of ``args`` (summed)."""

    @staticmethod
    def forward(ctx, solve, z0, *leaves):
        plan = solve.plan
        pieces, args = solve.split(leaves)
        ctx.solve = solve
        ctx.devices = [t.device for t in (z0, *leaves)]
        anchor = torch.zeros((), dtype=plan.dtype, device=plan.device)
        return (anchor, plan.local_z0(z0),
                *[plan.local_piece(pieces[key]) for key in solve.piece_keys],
                *[a.view_as(a) for a in args])

    @staticmethod
    def backward(ctx, g_anchor, g_z0, *g_leaves):
        solve = ctx.solve
        plan = solve.plan
        plan.wait()
        need = ctx.needs_input_grad[1:]          # z0, *pieces, *args
        n_p = len(solve.piece_keys)
        dz0 = plan.full_z0(g_z0).to(ctx.devices[0]) if need[0] else None
        piece_grads = [plan.full_piece(g).to(dev) if nd else None
                       for g, nd, dev in zip(g_leaves[:n_p], need[1:1 + n_p],
                                             ctx.devices[1:1 + n_p])]
        arg_need = need[1 + n_p:]
        bars = plan.sum_args([g.clone() for g, nd in zip(g_leaves[n_p:], arg_need) if nd])
        bars = iter(bars)
        return (None, dz0, *piece_grads, *[next(bars) if nd else None for nd in arg_need])


class _Recv(torch.autograd.Function):
    """Microbatch ``tag``'s state from the previous seq rank; the backward
    sends its cotangent back."""

    @staticmethod
    def forward(ctx, plan, tag, anchor):
        ctx.plan, ctx.tag = plan, tag
        return plan.recv_prev(tag)

    @staticmethod
    def backward(ctx, g):
        ctx.plan.send_prev(g, ctx.plan.M + ctx.tag)
        return None, None, g.new_zeros(())


class _Send(torch.autograd.Function):
    """Microbatch ``tag``'s state to the next seq rank; returns a token the
    outputs take, whose backward receives the state's cotangent."""

    @staticmethod
    def forward(ctx, plan, tag, y):
        ctx.plan, ctx.tag = plan, tag
        plan.send_next(y, tag)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, g_token):
        return None, None, ctx.plan.recv_next(ctx.plan.M + ctx.tag)


class _GatherOutputs(torch.autograd.Function):
    """The global outputs from this rank's ``local`` (the per-knot states
    ``(M, Tc, b_loc, ...)``, or the last seq rank's terminal ``(M, b_loc,
    ...)``, None elsewhere) and the sends' tokens.  The cotangent of a
    replicated output is the same on every rank (the gradient contract),
    so the backward takes this rank's slice of it and communicates
    nothing."""

    @staticmethod
    def forward(ctx, plan, sequences, local, *tokens):
        plan.wait()
        ctx.plan, ctx.sequences, ctx.has_local = plan, sequences, local is not None
        ctx.n_tokens = len(tokens)
        return plan.gather_seq(local) if sequences else plan.gather_outs(local)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g_local = plan.local_cotangent(g, ctx.sequences) if ctx.has_local else None
        return (None, None, g_local, *[g.new_zeros(()) for _ in range(ctx.n_tokens)])


def _direct(solve: _Solve, z0, leaves):
    """The pipeline differentiated straight through its ticks: this rank's
    microbatches in the forward schedule's order."""
    plan = solve.plan
    anchor, z0_l, *local = _ShardInputs.apply(solve, z0, *leaves)
    pieces, arg_leaves = solve.split(local)
    args = solve.rebuild_args(arg_leaves)
    chunk = _remat(lambda z, m: solve.chunk(z, pieces, m, args), solve.remat)
    ys, seqs, tokens = [], [], []
    for _, m in _fwd_slots(plan.k, plan.M):
        x_in = z0_l[m] if plan.is_first else _Recv.apply(plan, m, anchor)
        y, zs = chunk(x_in, m)
        if not plan.is_last:
            tokens.append(_Send.apply(plan, m, y))
        ys.append(y)
        seqs.append(zs)
    if solve.sequences:
        local_out = torch.stack(seqs)
    else:
        local_out = torch.stack(ys) if plan.is_last else None
    return _GatherOutputs.apply(plan, solve.sequences, local_out, *tokens)


class _PipelinedAdjoint(torch.autograd.Function):
    """O(1)-activation-memory training through the time pipeline (JAX
    ``_pipelined_adjoint``).  The forward runs the pipeline with no graph;
    each rank keeps only the ``(M, b, H)`` chunk-boundary states it
    consumed (and the last rank its terminal states), nothing per tick.
    The backward runs the pipeline in reverse, microbatch M-1 first: the
    last seq rank starts from its terminal state and the output's
    cotangent; each rank reverse-integrates the augmented state ``(z, a_z,
    a_piece, a_args)`` through its chunk (with per-knot outputs, each
    knot's cotangent joins ``a`` before its interval reverses) and hands
    its *stored* boundary state and ``a`` to the previous rank, so each
    stage starts from the exact forward state; rank 0's ``a`` is ``dz0``.
    Inputs ``(solve, z0, *piece leaves, *arg leaves)``; output the global
    per-knot or terminal states."""

    @staticmethod
    def forward(ctx, solve, z0, *leaves):
        plan = solve.plan
        pieces_full, args_l = solve.split(leaves)
        pieces = {key: plan.local_piece(v) for key, v in pieces_full.items()}
        args = solve.rebuild_args(args_l)
        z0_l = plan.local_z0(z0) if plan.is_first else None
        bnd, ys, seqs = [], [], []
        for _, m in _fwd_slots(plan.k, plan.M):
            x_in = z0_l[m] if plan.is_first else plan.recv_prev(m)
            y, zs = solve.chunk(x_in, pieces, m, args)
            if not plan.is_last:
                plan.send_next(y, m)
            bnd.append(x_in)
            ys.append(y)
            seqs.append(zs)
        plan.wait()
        outs = torch.stack(ys) if plan.is_last else None
        ctx.solve = solve
        ctx.devices = [t.device for t in (z0, *leaves)]
        ctx.save_for_backward(torch.stack(bnd), outs, *[pieces[k] for k in solve.piece_keys],
                              *args_l)
        if solve.sequences:
            return plan.gather_seq(torch.stack(seqs))
        return plan.gather_outs(outs)

    @staticmethod
    def backward(ctx, g):
        solve = ctx.solve
        plan = solve.plan
        bnd, outs, *leaves = ctx.saved_tensors
        pieces, arg_leaves = solve.split(leaves)
        need = ctx.needs_input_grad[1:]
        n_p = len(solve.piece_keys)
        piece_need = [key for key, nd in zip(solve.piece_keys, need[1:1 + n_p]) if nd]
        arg_need = list(need[1 + n_p:])
        arg_leaves = [t.detach().requires_grad_(nd) for t, nd in zip(arg_leaves, arg_need)]
        args = solve.rebuild_args(arg_leaves)
        args_wrt = [t for t, nd in zip(arg_leaves, arg_need) if nd]
        args_bar = [torch.zeros_like(t) for t in args_wrt]
        g_local = plan.local_cotangent(g, solve.sequences)
        bars = {key: [None] * plan.M for key in piece_need}
        dz0 = [None] * plan.M
        for _, m in _bwd_slots(plan.k, plan.n, plan.M):
            if plan.is_last:
                z_in = outs[m]
                a_in = torch.zeros_like(z_in) if solve.sequences else g_local[m]
            else:
                z_in, a_in = plan.recv_next(plan.M + m, lead=(2,)).unbind(0)
            _, a, args_bar, pbs = _chunk_adjoint(
                solve.bwd_step, solve.pf, solve.pf_e, z_in, a_in, args_bar,
                plan.microbatch(pieces, m), piece_need, solve.grid, args, args_wrt,
                solve.substeps, g_local[m] if solve.sequences else None)
            for j, key in enumerate(piece_need):
                bars[key][m] = torch.stack([pb[j] for pb in pbs])
            if plan.is_first:
                dz0[m] = a
            else:
                # The stored boundary state, not the reverse-integrated z:
                # the previous stage starts drift-free.
                plan.send_prev(torch.stack([bnd[m], a]), plan.M + m)
        plan.wait()
        z0_bar = torch.stack(dz0) if plan.is_first else torch.zeros_like(bnd)
        dz0_full = plan.full_z0(z0_bar).to(ctx.devices[0]) if need[0] else None
        piece_grads = []
        for key, nd, dev in zip(solve.piece_keys, need[1:1 + n_p], ctx.devices[1:1 + n_p]):
            if not nd:
                piece_grads.append(None)
                continue
            per_mb = bars[key]
            # Batched leaves: each microbatch's rows; batch-free: the sum.
            local = (torch.cat(per_mb, dim=1) if per_mb[0].dim() >= 2
                     else torch.stack(per_mb).sum(0))
            piece_grads.append(plan.full_piece(local).to(dev))
        args_bar = iter(plan.sum_args(args_bar))
        return (None, dz0_full, *piece_grads,
                *[next(args_bar) if nd else None for nd in arg_need])


def pipelined_cde_solve(
    X,
    func: Callable,
    z0: torch.Tensor,
    args: Any = None,
    *,
    mesh: Mesh,
    axis: str = "seq",
    data_axis: Optional[str] = None,
    method: str = "rk4",
    substeps: int = 1,
    microbatches: Optional[int] = None,
    vector_field_type: str = "matmul",
    return_sequences: bool = False,
    remat: bool = False,
    adjoint: bool = False,
    adjoint_method: Optional[str] = None,
    even_func: Optional[Callable] = None,
) -> torch.Tensor:
    """Solve dz = f(t, z) dX over ``X``'s knots with the knot axis
    pipelined across ``mesh``'s ``axis`` (n ranks).  Every rank calls it
    with the same arguments and gets the same result: the ``(B, H)``
    terminal states, or with ``return_sequences=True`` the ``(B, L, H)``
    states at every knot, the ``z0`` row first (the plain scan's layout).

    Args:
        X: a spline with the piece API (``piece_data``, ``host_grid``)
           built from ``(B, L, C)`` observations; each rank builds only its
           chunk of the pieces (and copies its rows to its device).
        func: the field, as ``cdeint`` takes it for ``vector_field_type``.
        z0: ``(B, H)`` initial states.
        mesh: a mesh with ``axis``; its device is where the solve runs.
        data_axis: an optional second axis sharding the batch within each
           stage (a ``make_grid_mesh(("data", "seq"), (nd, ns))``): each
           stage works on its ``B / nd`` rows while states stream over
           ``seq``.  Microbatch rows must divide by its size.
        microbatches: M (default n); ``B % M == 0``.
        remat: recompute each chunk solve in the backward (``adjoint=False``).
        adjoint: the O(1)-activation-memory reverse pipeline
           (:class:`_PipelinedAdjoint`); ``adjoint_method`` its stepper.
        even_func: the rectilinear time-advance intervals' cheap field; used
           when the chunk length is even (JAX's rule: else the full field).

    Gradients reach ``z0``, the spline's tensors and ``args``; see the
    module's gradient contract.
    """
    n = mesh.axis_size(axis)
    spline_cls = type(X)
    pf = _piece_field(spline_cls, func, vector_field_type)
    step = solvers.tree_fixed_step(method)
    if adjoint_method is not None and adjoint_method not in solvers.FIXED_METHODS:
        # Same contract and message as cdeint's fixed-grid adjoint_options check.
        raise ValueError(
            f"fixed-grid adjoint_options method {adjoint_method!r} must be "
            f"one of {solvers.FIXED_METHODS}"
        )
    pf_e = (_piece_field(spline_cls, even_func, vector_field_type)
            if even_func is not None else None)
    grid = X.host_grid()
    n_pieces = len(grid) - 1
    if n_pieces % n != 0:
        raise ValueError(
            f"knot pieces ({n_pieces}) must divide evenly over the {n}-way "
            f"'{axis}' mesh axis — pad the series to a multiple."
        )
    # The paired chunk body needs whole pairs on each rank (an even chunk
    # length); otherwise every interval takes the full field, as in JAX.
    if pf_e is not None and (n_pieces // n) % 2 != 0:
        pf_e = None
    B = z0.shape[0]
    M = microbatches or n
    if B % M != 0:
        raise ValueError(f"batch {B} must split into {M} microbatches.")
    b = B // M
    if data_axis is not None:
        n_data = mesh.axis_size(data_axis)
        if b % n_data != 0:
            raise ValueError(
                f"microbatch rows ({b}) must divide over the {n_data}-way "
                f"'{data_axis}' mesh axis."
            )

    plan = _Plan(mesh, axis, data_axis, n_pieces, B, M, z0.shape[1:], z0.dtype)
    k0 = plan.k * plan.Tc
    pieces = _chunk_pieces(X, plan)
    piece_keys = sorted(pieces)
    arg_leaves, rebuild_args = flatten(args)
    bwd_step = (solvers.tree_fixed_step(adjoint_method or method, live=2)
                if adjoint else None)
    solve = _Solve(plan, pf, pf_e, step, bwd_step, grid[k0:k0 + plan.Tc + 1], substeps,
                   piece_keys, rebuild_args, return_sequences, remat and not adjoint)
    leaves = [pieces[key] for key in piece_keys] + arg_leaves
    if adjoint:
        out = _PipelinedAdjoint.apply(solve, z0, *leaves)
    else:
        out = _direct(solve, z0, leaves)
    if not return_sequences:
        return out
    # The z0 row's cotangent reaches z0 directly; the knots' flow through
    # the pipeline.
    return torch.cat([z0.to(out.device)[:, None], out], dim=1)


def ncde_apply_pipelined(
    model,
    inputs,
    *,
    mesh: Mesh,
    axis: str = "seq",
    data_axis: Optional[str] = None,
    microbatches: Optional[int] = None,
    remat: bool = False,
    adjoint: bool = False,
):
    """``model(inputs)`` with the solve routed through the time pipeline:
    the entry point for sequence-sharded long-context serving and training.
    The same h0, field (the fused field, on its kernels on the card, paired
    on rectilinear pieces), output head and rectilinear ``::2`` filtering
    as ``NeuralCDE.forward``; the knot axis pipelined across ``mesh``'s
    ``axis``.  Needs a fixed-grid solver, knot pieces dividing the axis and
    a batch dividing ``microbatches``."""
    if model.solver not in solvers.FIXED_METHODS:
        raise ValueError(
            f"pipelined NCDE forward requires a fixed-grid solver, got "
            f"{model.solver!r}."
        )
    spline, h0 = model._setup_h0(inputs)
    func, even_func, field_args, vf_type = model.make_solve_func(h0)
    substeps = _resolve_substeps(dict(model.solver_settings["options"]),
                                 spline.host_grid())
    hidden = pipelined_cde_solve(
        spline, func, h0, field_args, mesh=mesh, axis=axis, data_axis=data_axis,
        method=model.solver, substeps=substeps, microbatches=microbatches,
        vector_field_type=vf_type, return_sequences=model.return_sequences,
        remat=remat, adjoint=adjoint, adjoint_method=model.adjoint_method,
        even_func=even_func,
    )
    if not model.return_sequences:
        hidden = hidden[..., None, :]
    return model._make_outputs(hidden)


class PipelinedNCDE(torch.nn.Module):
    """:func:`ncde_apply_pipelined` of ``model`` as a module, for
    ``training.loop.make_train_step`` and the harness (the counterpart of
    the JAX tests' ``apply_piped`` closure).  Its parameters are
    ``model``'s, under ``model``'s names (the step's ``final_key`` finds the
    readout), so it trains the model in place; build the step without
    ``mesh=`` (the module's gradient contract)."""

    def __init__(self, model, *, mesh: Mesh, axis: str = "seq",
                 data_axis: Optional[str] = None, microbatches: Optional[int] = None,
                 remat: bool = False, adjoint: bool = False):
        super().__init__()
        for name, child in model.named_children():
            self.add_module(name, child)
        for name, p in model.named_parameters(recurse=False):
            self.register_parameter(name, p)
        # Not a submodule: its parameters are registered above, once.
        object.__setattr__(self, "model", model)
        self.options = dict(mesh=mesh, axis=axis, data_axis=data_axis,
                            microbatches=microbatches, remat=remat, adjoint=adjoint)

    def forward(self, inputs):
        return ncde_apply_pipelined(self.model, inputs, **self.options)
