"""The reductions over a batch that decide a solve's steps, over a mesh's
data axis.

The JAX package shards a batch under ``jit`` with a ``NamedSharding``:
one program runs over the whole batch, so an adaptive controller's error
norm is a mean over every row whatever the mesh, and every device takes
the steps one device would.  Here each rank runs its own rows.  So the
solvers (``ops/solvers.py``) send each reduction over the batch that
decides a step -- the sums of squares of the error norms and of the
initial step's norms, the Adams corrector's largest ratio -- through
:func:`all_reduce`, which sums (or maxes) it over the
data axis of the mesh whose context is open
(``parallel.mesh.data_reductions``, which the ``mesh=`` entry points
enter around the model call).  Every rank then decides as one process
does over the whole batch.  With no context open, or a data axis of one
rank, the solvers keep their one-process arithmetic bit for bit.

The reduction is the op ``oncde::data_all_reduce``, so an exported solve
records it as a node: the artifact stays mesh-agnostic (the op is the
identity with no group set) and a loaded one reduces over the mesh it
serves on.  The reduced tensors are decisions, never differentiated: the
op takes them detached.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = ["over", "group", "active", "all_reduce"]

_GROUPS: list = []


@contextlib.contextmanager
def over(group):
    """Inside the block the step-deciding reductions span ``group`` (a
    process group; None: this process alone)."""
    _GROUPS.append(group)
    try:
        yield
    finally:
        _GROUPS.pop()


def group():
    """The process group the reductions span, or None."""
    return _GROUPS[-1] if _GROUPS else None


def active() -> bool:
    """Whether the solvers take the reducing form: a group is set, or a
    program is being exported (which records the op, for the mesh the
    artifact will serve on)."""
    return group() is not None or torch.compiler.is_exporting()


@torch.library.custom_op("oncde::data_all_reduce", mutates_args=())
def data_all_reduce(x: torch.Tensor, count: int, op: str) -> torch.Tensor:
    """Over the group :func:`group` names: with ``op="sum"``, every rank's
    ``x`` summed and rescaled to this rank's share of the ranks' ``count``
    (sum of x * count / sum of counts), so that ``result / count`` is the
    mean over every rank's rows, as ``x / count`` is over this rank's; with
    ``"total"``, every rank's ``x`` summed (``count`` unused: the parts of
    one sum, such as an adjoint's weight cotangent, each rank's over its
    rows); with ``"max"``, the largest ``x``.  The sums run in float64.
    With no group set, a copy of ``x``: a solve divides by its own count as
    it does with no reduction, to the bit."""
    out = x.clone()
    g = group()
    if g is None:
        return out
    if op == "max":
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
        return out
    if op == "total":
        wide = x.to(torch.float64, copy=True)
        dist.all_reduce(wide, group=g)
        return wide.to(x.dtype)
    both = torch.cat([x.reshape(-1).double(), x.new_full((1,), count, dtype=torch.float64)])
    dist.all_reduce(both, group=g)
    return (both[:-1] / (both[-1] / count)).to(x.dtype).reshape(x.shape)


@data_all_reduce.register_fake
def _(x, count, op):
    return torch.empty_like(x)


def all_reduce(x: torch.Tensor, count: int, op: str) -> torch.Tensor:
    """:func:`data_all_reduce` of ``x`` detached."""
    return data_all_reduce(x.detach(), count, op)
