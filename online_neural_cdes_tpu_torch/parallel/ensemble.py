"""Seed ensembles: the seeds of one configuration trained as one program.

PyTorch counterpart of the JAX package's ``parallel/ensemble.py``.  The
seeds are stacked as ``training/wave.py``'s lanes: their ``state_dict`` s
stacked key by key, one :class:`~online_neural_cdes_tpu_torch.training.wave.StackedAdam`,
and one step for all of them, which takes the fused field's kernels to
their K-replica entries through the Functions' ``vmap`` rules.  Every seed
trains on the same batch.

Over an (ensemble, data) mesh (:func:`make_ensemble_mesh`) the seed axis
is split over the ensemble groups, each holding a contiguous block of
``n_seeds / n_ensemble`` seeds, and each seed's batch over the data
groups: a rank steps its block of seeds on its shard of the batch, the
loss sums, label counts and gradients all-reduced over its data group
(``make_wave_step(mesh=)``), and the seeds' losses are gathered over the
ensemble axis, so the step returns every seed's loss on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch.distributed as dist

from online_neural_cdes_tpu_torch.parallel.mesh import (
    DATA_AXIS, ENSEMBLE_AXIS, Mesh, all_gather_rows, make_grid_mesh,
)

__all__ = ["make_ensemble_mesh", "init_ensemble", "make_ensemble_step", "EnsembleState"]


def make_ensemble_mesh(n_ensemble: int, n_data: int = 1, devices=None) -> Mesh:
    """An (ensemble, data) mesh of ``n_ensemble`` x ``n_data`` ranks over
    the world's first ranks (rank = e * n_data + d)."""
    need = n_ensemble * n_data
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise ValueError(f"Need {need} devices, have {have}")
    return make_grid_mesh((ENSEMBLE_AXIS, DATA_AXIS), (n_ensemble, n_data), devices)


def _local_seeds(n_seeds: int, mesh: Optional[Mesh]) -> range:
    """The seed indices this rank's ensemble group trains."""
    if mesh is None:
        return range(n_seeds)
    groups = mesh.axis_size(ENSEMBLE_AXIS)
    if n_seeds % groups:
        raise ValueError(f"{n_seeds} seeds do not divide the mesh's {groups}-group "
                         "ensemble axis")
    k = n_seeds // groups
    e = mesh.axis_index(ENSEMBLE_AXIS)
    return range(e * k, (e + 1) * k)


def init_ensemble(bundle, n_seeds: int, base_seed: int = 0, mesh: Optional[Mesh] = None,
                  params: Optional[dict] = None):
    """Stacked weights and Adam state of this rank's seeds: ``(state,
    adam)``, ``state`` a ``state_dict`` of (K, ...) tensors on the bundle's
    device (seed ``i``'s weights from ``bundle.init(base_seed + i)``, or
    lane ``i`` of ``params``, a stacked state of all ``n_seeds``, e.g. from
    ``utils.convert.params_from_jax(..., stacked=True)``) and ``adam`` its
    :class:`StackedAdam`.  With a mesh, K = ``n_seeds / n_ensemble``: this
    rank's ensemble group's block of seeds."""
    from online_neural_cdes_tpu_torch.training.wave import StackedAdam, _stack_states

    seeds = _local_seeds(n_seeds, mesh)
    if params is None:
        state = _stack_states([bundle.init(base_seed + i) for i in seeds])
    else:
        state = {k: v[seeds.start:seeds.stop].to(bundle.device).clone()
                 for k, v in params.items()}
    names = [n for n, _ in bundle.model.named_parameters()]
    return state, StackedAdam({k: state[k] for k in names})


def make_ensemble_step(bundle, loss: str = "bce", lr: float = 5e-3,
                       final_lr_multiplier: float = 10.0,
                       mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, adam, inputs, labels, lr_scale) -> (state, adam,
    losses)``: every seed takes one Adam step on the same batch (``inputs``
    prepared for the bundle's model; with a mesh, this rank's shard of it,
    ``parallel.mesh.shard_batch``), at ``lr * lr_scale`` and
    ``final_lr_multiplier`` times that on the readout, as the serial step.
    ``state`` and ``adam`` are updated in place and returned; ``losses``
    holds every seed's loss, (n_seeds,) on the device."""
    from online_neural_cdes_tpu_torch.training.wave import make_wave_step

    _, wave_step = make_wave_step(bundle, loss, mesh=mesh)

    def step(state, adam, inputs, labels, lr_scale):
        k = next(iter(state.values())).shape[0]
        rest = [lr * float(lr_scale)] * k
        final = [lr * final_lr_multiplier * float(lr_scale)] * k
        losses = wave_step(state, adam, inputs, labels, rest, final)
        if mesh is not None:
            losses = all_gather_rows(losses, mesh, ENSEMBLE_AXIS)
        return state, adam, losses

    return step


class EnsembleState:
    """The stacked weights and Adam state of an ensemble's seeds (this
    rank's block of them over a mesh), as the sweep's per-seed
    bookkeeping holds them."""

    def __init__(self, bundle, n_seeds: int, mesh: Optional[Mesh] = None,
                 base_seed: int = 0, params: Optional[dict] = None):
        self.bundle = bundle
        self.mesh = mesh
        self.seeds = _local_seeds(n_seeds, mesh)
        self.params, self.opt_state = init_ensemble(bundle, n_seeds, base_seed, mesh, params)
