"""Experiment harness: model setup, the training loop, results.

PyTorch port's counterpart of the JAX package's ``training/harness.py``,
with its public names and its results:

- ``setup_model``: the registry over ``model_string`` (``MODEL_STRINGS``),
  each model with its batch preparation (the GRU variants' tensors with
  the training set's feature means);
- ``train``: Adam with the 10x readout learning rate, the plateau
  schedule on validation loss (patience 15, factor 0.1), early stopping
  (patience 60) and the best epoch's weights by the monitored validation
  metric, then every split's metrics at those weights, with elapsed time,
  time per epoch, NFE, parameter count and peak device memory.

The model holds its weights and the optimizer updates them in place, so
the best weights are kept as detached clones of its ``state_dict`` (the
JAX trainer keeps an immutable tree).  ``train`` draws the initial weights
from ``torch.Generator().manual_seed(seed)``, as the JAX trainer draws
them from ``PRNGKey(seed)``.  Everything runs on the bundle's device, the
CUDA card unless ``setup_model(device="cpu")`` was asked for.

``mesh=`` trains over a process group (``parallel/mesh.py``): every rank
runs ``train`` on the same data with a bundle on its mesh device; each
batch is padded to a multiple of the data axis (``_pad_to_mesh_multiple``:
the inputs repeat their last row, the labels are NaN, which the loss
masks) and each rank steps on its shard, so the updates are the
single-process trainer's on the whole batch; evaluations gather every
rank's rows.  Only the mesh's first rank writes checkpoints and traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from online_neural_cdes_tpu_torch.data.loader import Batches, LoadedData
from online_neural_cdes_tpu_torch.models.attention import AttentionNeuralCDE
from online_neural_cdes_tpu_torch.models.grud import GRUD, prepare_gru_variant_data
from online_neural_cdes_tpu_torch.models.ncde import NeuralCDE
from online_neural_cdes_tpu_torch.models.odernn import ODERNN
from online_neural_cdes_tpu_torch.models.rnn import RNN
from online_neural_cdes_tpu_torch.models.stacked import StackedNeuralCDE
from online_neural_cdes_tpu_torch.ops.solvers import ADAPTIVE_METHODS
from online_neural_cdes_tpu_torch.parallel.mesh import (
    check_mesh, data_axis_size, data_parallel_sharding, replicate, shard_batch,
)
from online_neural_cdes_tpu_torch.training.loop import (
    make_epoch_step, make_eval_step, make_train_step,
)
from online_neural_cdes_tpu_torch.training.metrics import (
    METRICS, make_loss, masked_temporal_loss,
)
from online_neural_cdes_tpu_torch.utils.checkpoint import (
    load_checkpoint, optimizer_state_like, save_checkpoint,
)
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.profiling import device_memory_mb, device_sync, trace
from online_neural_cdes_tpu_torch.utils.tree import map_arrays

__all__ = ["setup_model", "train", "ModelBundle", "MODEL_STRINGS"]

# The reference trainer's plateau scheduler: ReduceLROnPlateau(threshold=
# 1e-6, min_lr=1e-7) in its default relative/min mode, always on VAL LOSS,
# whatever metric early stopping and the best epoch monitor.
PLATEAU_REL_THRESHOLD = 1e-6
PLATEAU_MIN_LR = 1e-7

MODEL_STRINGS = (
    "ncde", "ncde-stacked", "ncde-attention", "odernn",
    "gru-d", "gru", "gru-dt", "gru-intensity", "gru-dt-intensity",
)

# Batches enqueued before their predictions are copied to the host: the
# card runs ahead of the host without holding every batch's predictions.
EVAL_WINDOW = 8


def _to_device(tree, device: torch.device, dtype: torch.dtype):
    """Nested tuples / lists of numpy arrays or tensors -> tensors on
    ``device``, floating ones at ``dtype``.  A host array goes through
    pinned memory with a non-blocking copy, so the copy is queued behind
    the work already on the stream instead of waiting for it."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(t, device, dtype) for t in tree)
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.require(tree, requirements=["C", "W"]))
    if t.is_floating_point():
        t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class ModelBundle:
    """A model plus its batch-preparation adapter.

    ``prepare_batch`` takes a raw batch's inputs (numpy arrays, or tensors
    already on the device) to the model's inputs on the bundle's device;
    ``apply_fn(params, prepared)`` is the model's forward at the weights
    ``params`` (a ``state_dict``); ``make_model(generator)`` builds a fresh
    model of the same configuration, its weights drawn from
    ``generator``."""

    model: nn.Module
    model_string: str
    prepare_batch: Callable
    apply_fn: Callable
    make_model: Callable
    feature_means: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    def init(self, seed: int = 0) -> dict:
        """Initial weights drawn from ``torch.Generator().manual_seed(seed)``,
        as a ``state_dict``."""
        return self.make_model(torch.Generator().manual_seed(seed)).state_dict()

    def prepare_labels(self, labels) -> torch.Tensor:
        """Labels on the bundle's device; floating labels at the model's
        dtype, class ids as they are."""
        return _to_device(labels, self.device, self.dtype)


def _train_feature_means(train_data: LoadedData) -> np.ndarray:
    """Per-channel NaN-means of the raw training series (NaN -> 0)."""
    temporal = train_data.temporal
    if isinstance(temporal, list):
        flat = np.concatenate([np.asarray(t).reshape(-1, t.shape[-1]) for t in temporal])
    else:
        flat = np.asarray(temporal).reshape(-1, temporal.shape[-1])
    means = np.nanmean(flat, axis=0)
    means[np.isnan(means)] = 0.0
    return means.astype(np.float32)


def setup_model(
    model_string: str,
    input_dim: int,
    output_dim: int,
    static_dim: Optional[int] = None,
    hidden_dim: int = 15,
    hidden_hidden_dim: int = 15,
    num_layers: int = 3,
    vector_field: str = "original",
    vector_field_type: str = "matmul",
    interpolation: str = "linear",
    interpolation_eps: Optional[float] = None,
    sparsity: Optional[float] = None,
    adjoint: bool = True,
    adjoint_method: Optional[str] = None,
    solver: str = "rk4",
    return_sequences: bool = False,
    train_data: Optional[LoadedData] = None,
    *,
    device=None,
    dtype=torch.float32,
) -> ModelBundle:
    """Build a model and its batch adapter from a config, on ``device``
    (the CUDA card unless ``"cpu"`` is asked for) at ``dtype``.  Its
    weights come from the generator's seed 0 until ``train`` draws them
    from its ``seed``."""
    if model_string not in MODEL_STRINGS:
        raise ValueError(
            f"unknown model_string {model_string!r}; one of {MODEL_STRINGS}"
        )
    device = resolve_device(device)
    placed = dict(device=device, dtype=dtype)

    def bundle(make, prepare, means=None):
        model = make(torch.Generator().manual_seed(0))

        def apply_fn(params, prepared):
            return torch.func.functional_call(model, params, (prepared,))

        return ModelBundle(model, model_string, prepare, apply_fn, make, means)

    def to_model(inputs):
        return _to_device(inputs, device, dtype)

    if model_string == "ncde":
        def make(generator):
            return NeuralCDE(
                input_dim=input_dim, hidden_dim=hidden_dim, output_dim=output_dim,
                static_dim=static_dim, hidden_hidden_dim=hidden_hidden_dim,
                num_layers=num_layers, vector_field=vector_field,
                vector_field_type=vector_field_type, interpolation=interpolation,
                interpolation_eps=interpolation_eps, sparsity=sparsity,
                adjoint=adjoint, adjoint_method=adjoint_method, solver=solver,
                return_sequences=return_sequences, generator=generator, **placed,
            )

        return bundle(make, to_model)

    if model_string == "ncde-stacked":
        def make(generator):
            return StackedNeuralCDE(
                input_dim=input_dim, hidden_dims=(hidden_dim, hidden_dim),
                output_dim=output_dim, hidden_hidden_dim=hidden_hidden_dim,
                static_dim=static_dim, adjoint=adjoint,
                return_sequences=return_sequences, generator=generator, **placed,
            )

        return bundle(make, to_model)

    if model_string == "ncde-attention":
        if return_sequences:
            raise ValueError(
                "ncde-attention supports one-shot problems only: the "
                "attention pipeline compresses the path before the final "
                "NCDE, so per-step (online) outputs are undefined."
            )

        def make(generator):
            return AttentionNeuralCDE(
                input_dim=input_dim, hidden_dim=hidden_dim, output_dim=output_dim,
                static_dim=static_dim, adjoint=adjoint, generator=generator, **placed,
            )

        return bundle(make, to_model)

    means = _train_feature_means(train_data) if train_data is not None else None
    means_t = None if means is None else torch.from_numpy(means).to(device)

    def prep_variant(variant):
        def prep(inputs):
            temporal = inputs[1] if isinstance(inputs, tuple) else inputs
            return prepare_gru_variant_data(to_model(temporal), variant,
                                            feature_means=means_t)

        return prep

    if model_string == "odernn":
        # The ODE-RNN consumes the gru-intensity preparation (mean-imputed
        # values and cumulative observation-mask channels): twice the
        # input channels.
        def make(generator):
            return ODERNN(
                input_dim=input_dim * 2, hidden_dim=hidden_dim,
                output_dim=output_dim, hidden_hidden_dim=hidden_hidden_dim,
                num_layers=num_layers, solver=solver, adjoint=adjoint,
                return_sequences=return_sequences, generator=generator, **placed,
            )

        return bundle(make, prep_variant("gru-intensity"), means)

    if model_string == "gru-d":
        if means_t is None:
            means_t = torch.zeros(input_dim, device=device)

        def make(generator):
            return GRUD(input_dim=input_dim, hidden_dim=hidden_dim,
                        output_dim=output_dim, return_sequences=return_sequences,
                        feature_means=means_t, generator=generator, **placed)

        return bundle(make, prep_variant("gru-d"), means)

    # gru / gru-dt / gru-intensity / gru-dt-intensity: channel-concat input.
    multiplier = {"gru": 1, "gru-intensity": 2, "gru-dt": 2, "gru-dt-intensity": 3}[
        model_string
    ]

    def make(generator):
        return RNN(input_dim=input_dim * multiplier, hidden_dim=hidden_dim,
                   output_dim=output_dim, gru=True, return_sequences=return_sequences,
                   generator=generator, **placed)

    return bundle(make, prep_variant(model_string), means)


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


def _concat_ragged_time(chunks):
    """Concatenate per-batch arrays whose TIME axis (axis 1) may differ:
    ragged datasets pad each batch to its own bucketed length, so sequence
    outputs are (B, L_w, ...) with L_w varying across batches.  Shorter
    chunks NaN-pad to the longest: NaN labels are masked by every metric,
    and the matching prediction rows are never selected."""
    if len(chunks) == 1 or chunks[0].ndim < 2:
        return np.concatenate(chunks)
    max_len = max(c.shape[1] for c in chunks)
    if all(c.shape[1] == max_len for c in chunks):
        return np.concatenate(chunks)
    padded = []
    for c in chunks:
        if c.shape[1] < max_len:
            pad = [(0, 0)] * c.ndim
            pad[1] = (0, max_len - c.shape[1])
            c = np.pad(c, pad, constant_values=np.nan)
        padded.append(c)
    return np.concatenate(padded)


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()   # numpy holds no bf16
    return t.cpu().numpy()


def _pad_to_mesh_multiple(inputs, labels, n_data: int):
    """Pad a batch up to a multiple of the mesh's data axis: the inputs
    (nested tuples of numpy arrays or tensors) repeat their last row, the
    labels pad with NaN (integer labels become float32 to hold it), which
    the NaN-masked losses and metrics leave out, so the gradient (the sum
    over real rows over their count) is unchanged."""
    b = int(labels.shape[0])
    pad = (-b) % n_data
    if pad == 0:
        return inputs, labels

    def repeat_last(a):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    if isinstance(labels, torch.Tensor):
        labels = labels if labels.is_floating_point() else labels.float()
        labels = torch.cat([labels, labels.new_full((pad,) + tuple(labels.shape[1:]),
                                                    float("nan"))])
    else:
        labels = np.asarray(labels)
        if labels.dtype.kind != "f":
            labels = labels.astype(np.float32)
        labels = np.concatenate([labels, np.full((pad,) + labels.shape[1:], np.nan,
                                                 labels.dtype)])
    return map_arrays(inputs, repeat_last), labels


def _mesh_batches(batches, mesh):
    """``batches`` as this rank's shards: each batch padded to the data
    axis's multiple, then its rows for this rank (inputs and labels)."""
    for inputs, labels in batches:
        inputs, labels = _pad_to_mesh_multiple(inputs, labels, data_axis_size(mesh))
        yield shard_batch((inputs, labels), mesh)


def _evaluate(bundle, params, batches, loss_name, metric_names, mesh=None):
    """The loss (averaged over batches by their sizes) and ``metric_names``
    of the model at the weights ``params`` over ``batches``.  A window of
    ``EVAL_WINDOW`` batches is enqueued before their predictions are copied
    to the host, so there is no synchronisation per batch.  With ``mesh``
    each rank runs its shard of each batch (padded to the data axis's
    multiple) and gathers every rank's rows, so every rank computes the
    same results; the pad rows' NaN labels leave them out."""
    pointwise = make_loss(loss_name)
    preds_all, labels_all, losses_dev, counts, pending = [], [], [], [], []
    forward = make_eval_step(lambda prepared: bundle.apply_fn(params, prepared), mesh=mesh)
    with torch.inference_mode():
        for inputs, labels in batches:
            counts.append(len(labels))
            if mesh is not None:
                inputs, labels = _pad_to_mesh_multiple(inputs, labels, data_axis_size(mesh))
                inputs = shard_batch(inputs, mesh)
            preds = forward(bundle.prepare_batch(inputs))
            losses_dev.append(masked_temporal_loss(
                pointwise, preds, bundle.prepare_labels(labels), sqrt=loss_name == "rmse"))
            pending.append(preds)
            labels_all.append(np.asarray(labels))
            if len(pending) >= EVAL_WINDOW:
                preds_all.extend(_host(p) for p in pending)
                pending = []
        preds_all.extend(_host(p) for p in pending)
        losses = [float(v) for v in _host(torch.stack(losses_dev))]
    preds = _concat_ragged_time(preds_all)
    labels = _concat_ragged_time(labels_all)
    results = {"loss": float(np.average(losses, weights=counts))}
    for name in metric_names:
        if name == "loss":
            continue
        try:
            results[name] = METRICS[name](preds, labels)
        except ValueError:
            results[name] = float("nan")
    return results


def _shapes(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(t) for t in tree)
    return tuple(tree.shape)


def _stack(trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_stack([t[i] for t in trees]) for i in range(len(trees[0])))
    return torch.stack(trees)


def _build_fused_epoch(bundle, train_batches):
    """The epoch of ``epoch_fused``: every batch (this rank's shard of it,
    over a mesh) is prepared on the device once, and the longest same-shape
    prefix is stacked for one ``make_epoch_step`` call an epoch; the
    remaining batches (bucketed lengths, the ragged tail) follow one at a
    time, in order, so the updates are those of the default trainer.
    Returns (stacked inputs, stacked labels, tail), the stack None when no
    prefix of two or more batches exists."""
    prepared = [(bundle.prepare_batch(inputs), bundle.prepare_labels(labels))
                for inputs, labels in train_batches]
    k = 1
    while (k < len(prepared)
           and _shapes(prepared[k]) == _shapes(prepared[0])):
        k += 1
    if k < 2:
        return None, None, prepared
    return (_stack([p for p, _ in prepared[:k]]), torch.stack([lab for _, lab in prepared[:k]]),
            prepared[k:])


def train(
    bundle: ModelBundle,
    train_data: LoadedData,
    val_data: LoadedData,
    test_data: LoadedData,
    *,
    loss_str: str = "bce",
    metrics: tuple = ("loss",),
    val_metric_to_monitor: str = "loss",
    minimize: Optional[bool] = None,
    lr: float = 5e-3,
    final_lr_multiplier: float = 10.0,
    max_epochs: int = 1000,
    batch_size: int = 1024,
    plateau_patience: int = 15,
    plateau_factor: float = 0.1,
    early_stop_patience: int = 60,
    seed: int = 0,
    mesh=None,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    prefetch: int = 0,
    profile_dir: Optional[str] = None,
    compute_dtype: Optional[str] = None,
    epoch_fused: bool = False,
    accum_steps: Optional[int] = None,
    init_params: Optional[dict] = None,
    device=None,
) -> dict:
    """A full training run of ``bundle.model`` (updated in place) on the
    bundle's device; returns the metrics of every split at the best
    epoch's weights and the run's cost statistics, as the JAX ``train``.

    The initial weights are drawn from ``seed`` unless ``init_params`` (a
    ``state_dict``) is given.  ``device``, when given, must be the
    bundle's.

    ``checkpoint_dir`` with ``checkpoint_every=N``: the whole trainer state
    (weights, Adam, the best weights, the scheduler's counters, the
    history) is saved every N epochs, and ``resume=True`` continues from it
    exactly, bit for bit.  The best weights are saved there at the end
    (``best_params``).

    ``prefetch=N`` copies each epoch's batches to the card up to N ahead of
    the step (``data/prefetch.py``).  ``epoch_fused=True`` prepares the
    training batches on the device once and runs the same-shape prefix as
    one ``make_epoch_step`` call an epoch, the other batches one at a
    time, in order: the same updates as the default trainer.  The two are
    mutually exclusive.  ``profile_dir``: a ``torch.profiler`` trace of the
    second epoch (of the only one when one runs).  ``compute_dtype`` and
    ``accum_steps`` are ``make_train_step``'s.

    ``mesh``: every rank of the mesh calls ``train`` with the same
    arguments and a bundle on its mesh device; the steps are data-parallel
    (the module docstring), the results the same on every rank, and only
    the mesh's first rank writes checkpoints and traces."""
    check_mesh(mesh)
    if final_lr_multiplier is None:
        raise ValueError(
            "train(final_lr_multiplier=None): None is reserved for the "
            "runtime readout multiplier of make_train_step; pass a number "
            "(reference default 10.0)."
        )
    if epoch_fused and prefetch > 0:
        raise ValueError(
            "epoch_fused and prefetch are mutually exclusive: the fused "
            "epoch copies the whole split once, there is nothing to "
            "overlap per batch"
        )
    model = bundle.model
    if device is not None and resolve_device(device) != bundle.device:
        raise ValueError(f"train(device={device!r}): the bundle's model lives on "
                         f"{bundle.device}; build it with setup_model(device=...)")
    if mesh is not None and mesh.device != bundle.device:
        raise ValueError(f"train(mesh=...): this rank's mesh device is {mesh.device}, the "
                         f"bundle's model lives on {bundle.device}")
    if minimize is None:
        minimize = val_metric_to_monitor in ("loss",)
    sign = 1.0 if minimize else -1.0
    writer = mesh is None or mesh.coords == {axis: 0 for axis in mesh.axis_names}

    model.load_state_dict(bundle.init(seed) if init_params is None else init_params)
    num_params = sum(t.numel() for t in model.state_dict().values())
    if bundle.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(bundle.device)

    if mesh is not None:
        replicate(model, mesh)
    step_kw = dict(loss=loss_str, lr=lr, final_lr_multiplier=final_lr_multiplier,
                   compute_dtype=compute_dtype, accum_steps=accum_steps, mesh=mesh)
    step = make_epoch_step(model, **step_kw) if epoch_fused else make_train_step(model, **step_kw)
    optimizer = step.optimizer
    train_batches = Batches(train_data, batch_size)
    val_batches = Batches(val_data, batch_size)
    test_batches = Batches(test_data, batch_size)
    if len(train_batches) == 0:
        raise ValueError("Training split is empty — nothing to train on.")

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    best_score = np.inf
    best_params = snapshot()
    best_epoch = 0
    plateau_count = 0
    plateau_best = np.inf   # val LOSS tracked by the plateau scheduler
    stall_count = 0
    lr_scale = 1.0
    history = []
    start_epoch = 0
    nfe_resumed = 0

    ckpt_path = (
        os.path.join(checkpoint_dir, "trainer_state")
        if checkpoint_dir is not None else None
    )
    if resume and ckpt_path is not None and os.path.exists(ckpt_path + ".meta.json"):
        # A fresh Adam holds no state until its first step: the like is
        # built for a stepped one.
        like = {"params": model.state_dict(), "opt_state": optimizer_state_like(optimizer),
                "best": best_params}
        restored = load_checkpoint(ckpt_path, like)
        model.load_state_dict(restored["params"])
        optimizer.load_state_dict(restored["opt_state"])
        best_params = restored["best"]
        with open(ckpt_path + ".meta.json") as fh:
            meta = json.load(fh)
        start_epoch = int(meta["next_epoch"])
        best_score = float(meta["best_score"])
        best_epoch = int(meta["best_epoch"])
        plateau_count = int(meta["plateau_count"])
        plateau_best = float(meta.get("plateau_best", np.inf))
        stall_count = int(meta["stall_count"])
        lr_scale = float(meta["lr_scale"])
        nfe_resumed = int(meta.get("nfe_total", 0))
        history = list(meta.get("history", []))
    # A fixed grid's NFE does not depend on the weights: probe once.  An
    # adaptive solve's does: probe at the trained weights each epoch and
    # accumulate.
    nfe_adaptive = _nfe_is_adaptive(model)
    nfe_per_epoch = (
        None if nfe_adaptive else _probe_nfe(bundle, model.state_dict(), train_batches)
    )
    nfe_total = nfe_resumed

    if prefetch > 0:
        from online_neural_cdes_tpu_torch.data.prefetch import prefetch_to_device

        if mesh is None:
            def epoch_batches():
                return prefetch_to_device(train_batches, size=prefetch, device=bundle.device)
        else:
            # The prefetcher shards the raw batches, so the ragged tails
            # are padded before it.
            def epoch_batches():
                padded = (_pad_to_mesh_multiple(inputs, labels, data_axis_size(mesh))
                          for inputs, labels in train_batches)
                return prefetch_to_device(padded, size=prefetch,
                                          sharding=data_parallel_sharding(mesh)[0])
    elif mesh is None:

        def epoch_batches():
            return train_batches
    else:

        def epoch_batches():
            return _mesh_batches(train_batches, mesh)

    if epoch_fused:
        stacked_inputs, stacked_labels, fused_tail = _build_fused_epoch(bundle,
                                                                        epoch_batches())

    # Profile the second epoch (the first builds the kernels and fills the
    # allocator's caches), or the only one when just one will run.
    profile_epoch = (
        start_epoch + 1 if max_epochs - start_epoch > 1 else start_epoch
    )

    t_start = time.perf_counter()
    epochs_run = start_epoch
    for epoch in range(start_epoch, max_epochs):
        profiling = profile_dir is not None and epoch == profile_epoch and writer
        with trace(profile_dir) if profiling else contextlib.nullcontext():
            if epoch_fused:
                if stacked_inputs is not None:
                    loss_val = step(stacked_inputs, stacked_labels, lr_scale)[-1]
                for prepared, labels in fused_tail:
                    loss_val = step(_stack([prepared]), labels[None], lr_scale)[-1]
            else:
                for inputs, labels in epoch_batches():
                    loss_val = step(bundle.prepare_batch(inputs),
                                    bundle.prepare_labels(labels), lr_scale)
            device_sync(loss_val)
        epochs_run += 1
        if nfe_adaptive:
            epoch_nfe = _probe_nfe(bundle, model.state_dict(), train_batches)
            if epoch_nfe is not None:
                nfe_total += epoch_nfe

        val_results = _evaluate(bundle, model.state_dict(), val_batches, loss_str, metrics,
                                mesh=mesh)
        score = sign * val_results[val_metric_to_monitor]
        history.append({"epoch": epoch, "lr_scale": lr_scale, **val_results})
        if verbose:
            print(f"epoch {epoch}: train_loss {float(loss_val):.4f} val {val_results}")

        # The best epoch and early stopping follow the MONITORED score with
        # strict improvement (the reference's ignite handlers).
        if score < best_score:
            best_score = score
            best_params = snapshot()
            best_epoch = epoch
            stall_count = 0
        else:
            stall_count += 1
        # The plateau scheduler on VAL LOSS: a relative improvement test
        # loss < best * (1 - 1e-6), a reduction when the bad epochs exceed
        # the patience, clamped so the base group's rate stays >= min_lr.
        if val_results["loss"] < plateau_best * (1.0 - PLATEAU_REL_THRESHOLD):
            plateau_best = val_results["loss"]
            plateau_count = 0
        else:
            plateau_count += 1
            if plateau_count > plateau_patience:
                lr_scale = max(lr_scale * plateau_factor, PLATEAU_MIN_LR / lr)
                plateau_count = 0
        if stall_count >= early_stop_patience:
            break

        if (
            ckpt_path is not None and checkpoint_every > 0 and writer
            and (epoch + 1) % checkpoint_every == 0
        ):
            save_checkpoint(
                ckpt_path,
                {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
                 "best": best_params},
            )
            meta = {
                "next_epoch": epoch + 1,
                "best_score": float(best_score),
                "best_epoch": int(best_epoch),
                "plateau_count": int(plateau_count),
                "plateau_best": float(plateau_best),
                "stall_count": int(stall_count),
                "lr_scale": float(lr_scale),
                "nfe_total": int(nfe_total),
                "history": history,
            }
            tmp = ckpt_path + ".meta.json.tmp"
            with open(tmp, "w") as fh:
                json.dump(meta, fh)
            os.replace(tmp, ckpt_path + ".meta.json")

    elapsed = time.perf_counter() - t_start

    if checkpoint_dir is not None and writer:
        save_checkpoint(os.path.join(checkpoint_dir, "best_params"), best_params)

    if nfe_adaptive and nfe_total > 0:
        nfe = nfe_total
        nfe_per_epoch = nfe_total / max(epochs_run, 1)
    else:
        nfe = None if nfe_per_epoch is None else nfe_per_epoch * epochs_run
    results = {
        "num_params": int(num_params),
        "elapsed_time": elapsed,
        "time_per_epoch": elapsed / max(epochs_run, 1),
        "epochs_run": epochs_run,
        "best_epoch": best_epoch,
        "nfe_per_epoch": nfe_per_epoch,
        "nfe": nfe,
        "memory_usage": device_memory_mb(bundle.device),
        "history": history,
    }
    for split, batches in (
        ("train", train_batches), ("val", val_batches), ("test", test_batches)
    ):
        split_results = _evaluate(bundle, best_params, batches, loss_str, metrics, mesh=mesh)
        results.update({f"{split}.{k}": v for k, v in split_results.items()})
    results["best_params"] = best_params
    return results


def _nfe_is_adaptive(model) -> bool:
    return getattr(model, "solver", None) in ADAPTIVE_METHODS


def _probe_nfe(bundle, params, train_batches) -> Optional[int]:
    """An epoch's NFE for an NCDE (the paper's efficiency metric): the
    first batch's NFE at ``params`` times the number of batches; None for
    the other models, which report no solver statistics."""
    if not isinstance(bundle.model, NeuralCDE):
        return None
    inputs, _ = next(iter(train_batches))
    with torch.inference_mode():
        _, stats = torch.func.functional_call(
            bundle.model, params, (bundle.prepare_batch(inputs),), {"return_stats": True})
    return int(stats["nfe"]) * len(train_batches)
