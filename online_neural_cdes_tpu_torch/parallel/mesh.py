"""Process meshes: data parallelism over ``torch.distributed``.

PyTorch counterpart of the JAX package's ``parallel/mesh.py``.  Where JAX
runs one SPMD program over a ``jax.sharding.Mesh`` of devices, PyTorch runs
one process per device, each with its rank, joined in a process group.  A
:class:`Mesh` here is that group seen from one rank: its axis names
(``("data",)``, or ``("ensemble", "data")`` for seed ensembles), its shape,
the process group of each axis that holds this rank, and this rank's
device.  The JAX names keep their meaning on top of that idiom:

- :func:`shard_batch` gives this rank its contiguous slice of a batch's
  leading axis, on its device (JAX places every slice on its device; here
  each process holds its own);
- :func:`replicate` broadcasts from the mesh's first rank, so every rank
  holds the same weights;
- a step built with ``mesh=`` all-reduces what it must (the loss's sums and
  counts, the gradients), so every rank takes the same update, and a
  forward built with it all-gathers the rows, so every rank returns every
  row.

The caller starts the processes and picks the backend
(:func:`initialize_multihost`): NCCL between cards; gloo on the CPU, and
for several ranks on one card, which NCCL refuses.  Nothing here switches
backend.  The collectives are the caller's group's, called by every rank
of an axis in the same order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from online_neural_cdes_tpu_torch.utils.tree import map_arrays

__all__ = [
    "Mesh", "Sharding", "make_mesh", "make_grid_mesh", "shard_batch", "replicate",
    "check_mesh",
    "data_parallel_sharding", "data_axis_size", "initialize_multihost",
    "DATA_AXIS", "ENSEMBLE_AXIS",
]

DATA_AXIS = "data"
ENSEMBLE_AXIS = "ensemble"


class Mesh:
    """A grid of ranks seen from this rank.

    ``axis_names`` / ``shape``: the grid (row-major over the first
    ``prod(shape)`` ranks of the world); ``coords``: this rank's index
    along each axis; ``groups[axis]``: the process group of the ranks that
    share every other coordinate with this one (the ranks a collective
    over ``axis`` spans); ``group``: the whole mesh's; ``device``: where
    this rank's tensors live."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 coords: Tuple[int, ...], groups: Dict[str, object], group,
                 device: torch.device, ranks: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.coords = dict(zip(axis_names, coords))
        self.groups = groups
        self.group = group
        self.device = device
        self.ranks = list(ranks)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def axis_size(self, axis: str) -> int:
        return int(self.shape[axis])

    def axis_index(self, axis: str) -> int:
        return int(self.coords[axis])

    def rank_along(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` that shares every
        other coordinate with this rank (the grid is row-major over
        ``ranks``)."""
        coords = [index if name == axis else self.coords[name] for name in self.axis_names]
        shape = [self.shape[name] for name in self.axis_names]
        return self.ranks[int(np.ravel_multi_index(coords, shape))]

    def neighbour(self, axis: str, step: int) -> Optional[int]:
        """The global rank ``step`` places along ``axis`` from this one
        (+1 the next, -1 the previous), or None past either end: the peer
        of a point-to-point send, which takes global ranks."""
        index = self.axis_index(axis) + step
        if not 0 <= index < self.axis_size(axis):
            return None
        return self.rank_along(axis, index)

    def __repr__(self):
        return (f"Mesh(axes={self.shape}, coords={self.coords}, device={self.device}, "
                f"backend={dist.get_backend(self.group)})")


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a :class:`Mesh` (the ``mesh=`` of
    every entry point)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")


class Sharding:
    """A placement ``prefetch_to_device(sharding=...)`` applies to each
    array leaf before copying it to the mesh's device: ``spec``
    ``("data",)`` keeps this rank's slice of the leading axis (a leaf of
    lower rank than the spec is replicated, as in JAX), ``()`` the whole
    leaf."""

    def __init__(self, mesh: Mesh, spec: Tuple[str, ...] = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def place(self, leaf) -> torch.Tensor:
        """The part of ``leaf`` this rank holds, where ``leaf`` lies (the
        caller copies it to the mesh's device)."""
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(leaf))
        if self.spec and t.dim() >= len(self.spec):
            t = _rows(t, self.mesh)
        return t


def initialize_multihost(**kwargs) -> None:
    """Join the process group: ``torch.distributed.init_process_group``
    with the caller's ``backend``, ``init_method`` (e.g.
    ``"tcp://localhost:29500"``), ``world_size`` and ``rank``.  Call once in
    each process before building a mesh."""
    dist.init_process_group(**kwargs)


def _rank_device(rank: int, devices) -> torch.device:
    """This rank's device: ``devices[rank]`` of a sequence, every rank's of
    a single device or string, else the card ``rank % device_count`` (the
    CUDA card unless ``"cpu"`` is asked for)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass devices='cpu' to build "
                               "the mesh on the CPU explicitly")
        return torch.device("cuda", rank % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    return torch.device(devices[rank])


def make_grid_mesh(axis_names: Sequence[str], shape: Sequence[int], devices=None) -> Mesh:
    """A mesh of ``shape`` over the world's first ``prod(shape)`` ranks
    (rank = row-major index).  Every rank of the world calls it; a rank
    outside the grid gets a ValueError after the groups are built."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.mesh.initialize_multihost(backend=..., init_method=..., "
                           "world_size=..., rank=...) in each process first")
    shape = tuple(int(s) for s in shape)
    need = int(np.prod(shape))
    world = dist.get_world_size()
    if world < need:
        raise ValueError(f"Requested {need} devices but only {world} available")
    rank = dist.get_rank()
    grid = np.arange(need).reshape(shape)
    whole = dist.group.WORLD if need == world else dist.new_group(list(range(need)))
    groups = {}
    for axis, name in enumerate(axis_names):
        # Every line of the grid along ``axis``, in one order on every rank.
        lines = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
        for line in lines:
            members = [int(r) for r in line]
            group = whole if len(members) == need else dist.new_group(members)
            if rank in members:
                groups[name] = group
    if rank >= need:
        raise ValueError(f"rank {rank} is outside the mesh of the first {need} ranks")
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    return Mesh(tuple(axis_names), shape, coords, groups, whole,
                _rank_device(rank, devices), range(need))


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D data-parallel mesh over the world's first ``n_devices`` ranks
    (all of them by default)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return make_grid_mesh((DATA_AXIS,), (n_devices,), devices)


def data_axis_size(mesh: Mesh) -> int:
    """Ranks along the axis batches shard over: the divisibility unit for
    batch, bucket and stream sizes (an (ensemble, data) mesh shards batches
    over its data axis only)."""
    return mesh.axis_size(DATA_AXIS)


def data_parallel_sharding(mesh: Mesh):
    """(batch sharding, replicated sharding) for the mesh."""
    return Sharding(mesh, (DATA_AXIS,)), Sharding(mesh, ())


def _rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of ``t``'s leading axis."""
    n = data_axis_size(mesh)
    b = int(t.shape[0])
    if b % n:
        raise ValueError(f"batch {b} does not divide the mesh's {n}-device data axis; "
                         "pad it to a multiple of it")
    i = mesh.axis_index(DATA_AXIS)
    return t[i * (b // n):(i + 1) * (b // n)]


def shard_batch(batch, mesh: Mesh):
    """The nested arrays of ``batch`` (numpy or tensors) with the leading
    axis split over the data axis: this rank's contiguous slice of each,
    as a tensor on its device.  Raises when a leading axis does not divide
    the data axis."""
    sharding = Sharding(mesh, (DATA_AXIS,))
    return map_arrays(batch, lambda leaf: sharding.place(leaf).to(mesh.device))


def replicate(tree, mesh: Mesh):
    """The same values on every rank of the mesh: a broadcast from its first
    rank.  An ``nn.Module`` is broadcast in place (parameters and buffers)
    and returned; nested arrays come back as tensors on this rank's
    device."""
    src = mesh.ranks[0]
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, src, group=mesh.group)
        return tree

    def bcast(leaf):
        t = torch.as_tensor(leaf).to(mesh.device).clone()
        dist.broadcast(t, src, group=mesh.group)
        return t

    return map_arrays(tree, bcast)


def all_reduce_sum(tensors, mesh: Mesh, axis: str = DATA_AXIS) -> None:
    """Sum each tensor over ``axis``, in place: one collective over the
    tensors flattened into one buffer."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated on the leading axis
    in rank order (each rank's slice back in its place)."""
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, t.contiguous(), group=mesh.groups[axis])
    return torch.cat(parts)
