"""Waves: K trials or seeds of one model shape trained as one program.

PyTorch port's counterpart of the JAX package's ``training/wave.py``.
Configs that differ only in their seed (a final config's seeds) or in the
trainer scalars of :data:`WAVEABLE_TRAINER_KEYS` (a hyperopt wave's
learning rates, readout boosts and scheduler knobs) train side by side:
the weights of the K lanes are stacked along a leading axis and one step
advances all of them.

The step follows PyTorch's model-ensembling idiom: ``bundle.init(seed)``
for each lane, the ``state_dict`` s stacked key by key, and
``torch.func.functional_call`` under ``torch.func.vmap`` of the loss,
differentiated by plain autograd (:func:`make_wave_step`).  The batch and
its labels are shared by every lane.  On the card, the fused field's Functions
take the K lanes to the kernels' multi entry points
(``ops/kernels.py``): one launch sequence per stage for the whole wave,
as Pallas's batching rule gives the TPU kernel under ``jax.vmap``.  The
solves have vmap rules of their own (``ops/cdeint.py``,
``ops/solvers.py``): the interval adjoint and ``odeint_adjoint`` record
K-lane Functions whose backward reverses every lane at once, and an
adaptive or Adams solve runs K host controllers side by side, each lane
with its own times, step sizes and accept/reject decisions, as JAX's
vmapped ``lax.while_loop`` gives each lane, in float32, float64 or a
bfloat16 step's bfloat16 (``compute_dtype``, as the JAX wave takes it).  The
update is a stacked Adam (:class:`StackedAdam`) with per-lane learning
rates, in the serial step's order of operations, so each lane follows its
serial run (``harness.train``).  The host bookkeeping -- plateau schedule,
early stopping, per-lane ``max_epochs``, the best weights and the cost
share -- is the JAX wave's, vectorised over the lanes.

A bundle whose step cannot be stacked raises :class:`WaveUnsupported`:
``scipy_solver``, a host callback the JAX package cannot trace under
``jax.vmap`` either.  The sweep and the hyperopt search catch only that
exception and run such members one after another.
"""

from __future__ import annotations

import json
import time
from typing import List

import numpy as np
import torch

__all__ = ["run_trials_vmapped", "vmappable_groups", "config_wave_groups",
           "WAVEABLE_TRAINER_KEYS", "WAVE_UNSUPPORTED_TRAINER_KEYS", "WaveUnsupported",
           "StackedAdam", "make_wave_step", "check_waveable"]

# Trainer scalars a wave varies per lane without changing the program:
# ``lr`` and ``final_lr_multiplier`` are the stacked Adam's per-lane rates;
# the scheduler knobs live in the host loop's per-lane arrays.  Everything
# else (widths, solver and field choices, dataset keys) changes the program
# and keeps candidates in separate groups.
WAVEABLE_TRAINER_KEYS = frozenset({
    "trainer__lr",
    "trainer__final_lr_multiplier",
    "trainer__plateau_patience",
    "trainer__plateau_factor",
    "trainer__early_stop_patience",
    "trainer__max_epochs",
})

# Per-run facilities the wave does not implement; a config using any of
# them runs on its own (which honours them) instead of silently dropping
# fault tolerance, profiling or accumulation.
WAVE_UNSUPPORTED_TRAINER_KEYS = frozenset({
    "checkpoint_dir", "checkpoint_every", "resume", "prefetch",
    "profile_dir", "accum_steps",
})


class WaveUnsupported(ValueError):
    """A wave group whose model's step cannot be stacked; its members train
    one after another."""


def _shape_signature(point: dict) -> tuple:
    """Program signature of a dunder-encoded candidate: everything except
    the per-lane waveable trainer scalars."""
    return tuple(sorted(
        (k, v) for k, v in point.items() if k not in WAVEABLE_TRAINER_KEYS
    ))


def vmappable_groups(points: List[dict]):
    """Partition hyperopt candidates into groups that train as one wave
    (same signature, differing only in :data:`WAVEABLE_TRAINER_KEYS`) and
    singletons.  Returns lists of indices into ``points``."""
    groups: dict = {}
    for i, p in enumerate(points):
        groups.setdefault(_shape_signature(p), []).append(i)
    return list(groups.values())


def config_wave_groups(configs: List[dict]):
    """Partition full experiment configs (the sweep's units) into groups
    that train as one wave: identical except ``seed`` and the waveable
    trainer scalars, with no wave-unsupported trainer option.  Returns
    lists of indices into ``configs``; singletons and unsupported configs
    come back as 1-element groups."""
    waveable = {key.split("__", 1)[1] for key in WAVEABLE_TRAINER_KEYS}
    groups: dict = {}
    for i, cfg in enumerate(configs):
        trainer = cfg.get("trainer", {}) or {}
        if any(trainer.get(key) for key in WAVE_UNSUPPORTED_TRAINER_KEYS):
            groups[("__solo__", i)] = [i]
            continue
        base = {k: v for k, v in cfg.items() if k not in ("trainer", "seed")}
        tr = {k: v for k, v in trainer.items() if k not in waveable}
        sig = json.dumps({"base": base, "trainer": tr}, sort_keys=True, default=str)
        groups.setdefault(sig, []).append(i)
    return list(groups.values())


def check_waveable(model) -> None:
    """Raise :class:`WaveUnsupported` for a model whose step cannot be
    stacked: a ``scipy_solver`` solve (a host callback through
    ``scipy.integrate.solve_ivp``, which the JAX package cannot trace under
    ``jax.jit`` or ``jax.vmap`` either, so its wave refuses it too: parity,
    not a gap).  Every other model stacks, in any compute dtype: the
    interval adjoint, ``odeint_adjoint`` and the adaptive and Adams solves
    have vmap rules of their own."""
    for module in model.modules():
        if getattr(module, "solver", None) == "scipy_solver":
            raise WaveUnsupported(
                f"{type(module).__name__} with solver 'scipy_solver': its solve is a host "
                "callback (scipy.integrate.solve_ivp) that no vmapped program can carry; "
                "the JAX package cannot trace it under jax.vmap either, so its members "
                "train one after another")


class StackedAdam:
    """Adam over K stacked lanes (``(K, ...)`` tensors) with per-lane
    learning rates: the update of ``torch.optim.Adam``'s single-tensor step
    in its order of operations (``exp_avg.lerp_``, ``exp_avg_sq.mul_(beta2)
    .addcmul_``, ``denom = sqrt(exp_avg_sq) / sqrt(bc2) + eps``, ``param +
    (-step_size * exp_avg) / denom``), so a lane's update is its serial
    step's.  Parameters under ``final_key`` take ``lr * final_mult``, the
    rest ``lr``, as ``training/loop.py``'s two groups."""

    def __init__(self, params: dict, final_key: str = "final",
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.final = {k: k.split(".")[0] == final_key for k in params}
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.steps = 0
        self.exp_avg = {k: torch.zeros_like(p) for k, p in params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, lr_rest, lr_final) -> None:
        """One update.  ``lr_rest`` / ``lr_final``: the K lanes' learning
        rates as host floats (each computed as the serial step computes its
        group's)."""
        self.steps += 1
        bc1 = 1 - self.beta1 ** self.steps
        bc2 = 1 - self.beta2 ** self.steps
        bc2_sqrt = bc2 ** 0.5
        first = next(iter(self.params.values()))
        neg_step = {final: torch.tensor([-(lr / bc1) for lr in lrs], dtype=first.dtype,
                                        device=first.device)
                    for final, lrs in ((False, lr_rest), (True, lr_final))}
        for key, param in self.params.items():
            grad = grads[key]
            exp_avg, exp_avg_sq = self.exp_avg[key], self.exp_avg_sq[key]
            exp_avg.lerp_(grad, 1 - self.beta1)
            exp_avg_sq.mul_(self.beta2).addcmul_(grad, grad, value=1 - self.beta2)
            denom = (exp_avg_sq.sqrt() / bc2_sqrt).add_(self.eps)
            scale = neg_step[self.final[key]].reshape((-1,) + (1,) * (param.dim() - 1))
            param.add_(scale * exp_avg / denom)


def _stack_states(states: List[dict]) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def make_wave_step(bundle, loss: str = "bce", compute_dtype=None, final_key: str = "final",
                   mesh=None):
    """The wave's step factory: returns ``(optimizer, step)`` for the
    bundle's model.  ``optimizer(state)`` is the :class:`StackedAdam` of a
    stacked ``state`` (a ``state_dict`` of (K, ...) tensors, updated in
    place); ``step(state, adam, prepared, labels, lr_rest, lr_final)``
    computes every lane's loss with one ``torch.func.vmap`` of the loss over
    the lanes and their gradients with one plain ``autograd.grad`` of the
    losses' sum (the lanes share no weight, so each lane's gradient is its
    own loss's), updates ``state`` and returns the lanes' losses (K,) on
    the device.  Plain autograd keeps ``torch.func`` out of the backward:
    the fused field's vmap rule records its K-replica Function, whose
    backward launches the multi kernel directly.  ``compute_dtype`` is the
    serial step's mixed precision.

    ``mesh``: the batch is sharded over the mesh's data axis (``prepared``
    and ``labels`` are this rank's shard); each lane's loss is the global
    NaN-masked mean (its per-rank sums and the label counts all-reduced
    before the backward, as ``training/loop.py``'s data-parallel step) and
    the gradients are all-reduced, so the ranks of a data group take the
    same update."""
    from online_neural_cdes_tpu_torch.parallel.mesh import all_reduce_sum, data_reductions
    from online_neural_cdes_tpu_torch.training.loop import _cast_floats, _compute_dtype
    from online_neural_cdes_tpu_torch.training.metrics import (
        make_loss, masked_temporal_loss, masked_temporal_loss_parts,
    )

    model = bundle.model
    pointwise = make_loss(loss)
    sqrt = loss == "rmse"
    names = [n for n, _ in model.named_parameters()]
    cdt = None if compute_dtype is None else _compute_dtype(compute_dtype)

    def lane_preds(params, buffers, prepared):
        if cdt is None:
            return torch.func.functional_call(model, (params, buffers), (prepared,))
        cast = {k: v.to(cdt) for k, v in params.items()}
        return torch.func.functional_call(
            model, (cast, buffers), (_cast_floats(prepared, cdt),)).to(torch.float32)

    def lane_loss(params, buffers, prepared, labels):
        return masked_temporal_loss(pointwise, lane_preds(params, buffers, prepared), labels,
                                    sqrt=sqrt)

    def lane_parts(params, buffers, prepared, labels):
        return masked_temporal_loss_parts(pointwise, lane_preds(params, buffers, prepared),
                                          labels)

    losses_fn = torch.func.vmap(lane_loss, in_dims=(0, 0, None, None))
    parts_fn = torch.func.vmap(lane_parts, in_dims=(0, 0, None, None))

    def sharded_grads(params, buffers, prepared, labels):
        """Each lane's global loss and this rank's share of its gradient
        (``training/loop.py``'s data-parallel arithmetic, lane by lane)."""
        totals, counts = parts_fn(params, buffers, prepared, labels)
        k = totals.shape[0]
        sums = torch.cat([totals.detach(), counts])
        all_reduce_sum([sums], mesh)
        denom = torch.clamp_min(sums[k:], 1)
        means = sums[:k] / denom
        values = torch.sqrt(means) if sqrt else means
        seed = torch.ones_like(values) / (2 * values) if sqrt else torch.ones_like(values)
        grads = torch.autograd.grad(totals / denom, list(params.values()), grad_outputs=seed,
                                    allow_unused=True)
        all_reduce_sum([g for g in grads if g is not None], mesh)
        return values, grads

    def step(state, adam, prepared, labels, lr_rest, lr_final):
        params = {k: state[k].detach().requires_grad_() for k in names}
        buffers = {k: v for k, v in state.items() if k not in params}
        with torch.enable_grad():
            if mesh is None:
                values = losses_fn(params, buffers, prepared, labels)
                grads = torch.autograd.grad(values.sum(), list(params.values()),
                                            allow_unused=True)
            else:
                with data_reductions(mesh):   # each lane's steps over the whole batch
                    values, grads = sharded_grads(params, buffers, prepared, labels)
        # A weight the loss does not reach gets a zero gradient: its Adam
        # update is 0, as the serial step's skip leaves it.
        adam.step({k: torch.zeros_like(p) if g is None else g
                   for (k, p), g in zip(params.items(), grads)}, lr_rest, lr_final)
        return values.detach()

    def optimizer(state):
        return StackedAdam({k: state[k] for k in names}, final_key=final_key)

    return optimizer, step


def _select_rows(mask_np, new: dict, old: dict) -> dict:
    """Per-lane best weights: lanes of ``new`` where ``mask`` else ``old``,
    as new detached tensors (neither aliases the live stacked weights, so a
    later update cannot reach the best ones)."""
    out = {}
    for k, n in new.items():
        mask = torch.as_tensor(mask_np, device=n.device).reshape((-1,) + (1,) * (n.dim() - 1))
        out[k] = torch.where(mask, n.detach(), old[k])
    return out


def _probe_nfe(bundle, state, train_batches):
    """``harness._probe_nfe`` for the stacked weights: each lane's epoch NFE
    for an NCDE (its first batch's, read from one vmapped forward, times
    the number of batches), None for the other models.  The forward is the
    wave's, so it launches the kernels' multi entries as every other call
    of the wave, and an adaptive solve's NFE is each lane's own."""
    from online_neural_cdes_tpu_torch.models.ncde import NeuralCDE

    if not isinstance(bundle.model, NeuralCDE):
        return None
    inputs, _ = next(iter(train_batches))
    prepared = bundle.prepare_batch(inputs)

    def nfe(params):
        return torch.func.functional_call(bundle.model, params, (prepared,),
                                          {"return_stats": True})[1]["nfe"]

    with torch.no_grad():
        per_lane = torch.func.vmap(nfe)(state)
    return [int(v) * len(train_batches) for v in per_lane.tolist()]


def _wave_evaluate(bundle, state, batches, loss_name, metric_names, k):
    """Every lane's loss and ``metric_names`` at the stacked weights: one
    vmapped forward a batch, ``harness.EVAL_WINDOW`` batches enqueued
    before their predictions reach the host (``harness._evaluate``'s
    window)."""
    from online_neural_cdes_tpu_torch.training.harness import (
        EVAL_WINDOW, _concat_ragged_time, _host,
    )
    from online_neural_cdes_tpu_torch.training.metrics import (
        METRICS, make_loss, masked_temporal_loss,
    )

    pointwise = make_loss(loss_name)
    sqrt = loss_name == "rmse"
    forward = torch.func.vmap(bundle.apply_fn, in_dims=(0, None))
    preds_all, labels_all, losses_dev, counts, pending = [], [], [], [], []
    with torch.no_grad():
        for inputs, labels in batches:
            preds = forward(state, bundle.prepare_batch(inputs))      # (K, B, ...)
            labels_dev = bundle.prepare_labels(labels)
            losses_dev.append(torch.func.vmap(
                lambda p: masked_temporal_loss(pointwise, p, labels_dev, sqrt=sqrt))(preds))
            counts.append(len(labels))
            pending.append(preds)
            labels_all.append(np.asarray(labels))
            if len(pending) >= EVAL_WINDOW:
                preds_all.extend(_host(p) for p in pending)
                pending = []
        preds_all.extend(_host(p) for p in pending)
        losses = _host(torch.stack(losses_dev))                        # (n_batches, K)
    labels_cat = _concat_ragged_time(labels_all)
    out = []
    for i in range(k):
        preds_i = _concat_ragged_time([p[i] for p in preds_all])
        res = {"loss": float(np.average(losses[:, i], weights=counts))}
        for name in metric_names:
            if name == "loss":
                continue
            try:
                res[name] = METRICS[name](preds_i, labels_cat)
            except ValueError:
                res[name] = float("nan")
        out.append(res)
    return out


def run_trials_vmapped(trial_cfgs: List[dict], data_root: str = "data/processed",
                       verbose: bool = False, device=None) -> List[dict]:
    """Train every config of ``trial_cfgs`` at once, as one wave on
    ``device`` (the CUDA card unless ``"cpu"`` is asked for), and return one
    results dict per config: the keys of ``harness.train``'s results
    (``memory_usage`` None, as the JAX wave's; ``best_params`` the lane's
    best weights).

    The configs must be identical except ``seed`` and the waveable trainer
    scalars (:data:`WAVEABLE_TRAINER_KEYS`); the caller groups them
    (:func:`vmappable_groups`, :func:`config_wave_groups`).  Raises
    ValueError on a mismatch or a wave-unsupported trainer option, and
    :class:`WaveUnsupported` for a model whose step cannot be stacked.
    Each lane's weights start from ``bundle.init(seed)`` and follow its
    serial run."""
    from online_neural_cdes_tpu_torch.data.loader import Batches
    from online_neural_cdes_tpu_torch.training.experiment import load_and_setup
    from online_neural_cdes_tpu_torch.training.harness import (
        PLATEAU_MIN_LR, PLATEAU_REL_THRESHOLD, _nfe_is_adaptive,
    )
    from online_neural_cdes_tpu_torch.utils.profiling import device_sync

    waveable = {key.split("__", 1)[1] for key in WAVEABLE_TRAINER_KEYS}
    k = len(trial_cfgs)
    cfg0 = trial_cfgs[0]

    def fixed_part(cfg):
        base = {key: val for key, val in cfg.items() if key not in ("trainer", "seed")}
        tr = {key: val for key, val in cfg.get("trainer", {}).items() if key not in waveable}
        return base, tr

    for cfg in trial_cfgs:
        if fixed_part(cfg) != fixed_part(cfg0):
            raise ValueError("run_trials_vmapped requires configs identical except the "
                             f"seed and the waveable trainer scalars {sorted(waveable)}")
        unsupported = [key for key in WAVE_UNSUPPORTED_TRAINER_KEYS
                       if cfg.get("trainer", {}).get(key)]
        if unsupported:
            raise ValueError(
                f"wave-incompatible trainer options {sorted(unsupported)}: "
                "checkpoint/resume/prefetch/profiling/accumulation run "
                "only on the sequential trial path")

    def per_lane(key, default, dtype):
        return np.asarray([dtype(cfg.get("trainer", {}).get(key, default))
                           for cfg in trial_cfgs])

    lrs = per_lane("lr", 5e-3, float)
    final_mults = per_lane("final_lr_multiplier", 10.0, float)
    plateau_patience = per_lane("plateau_patience", 15, int)
    plateau_factor = per_lane("plateau_factor", 0.1, float)
    early_stop_patience = per_lane("early_stop_patience", 60, int)
    max_epochs_arr = per_lane("max_epochs", 1000, int)

    ds = dict(cfg0.get("dataset", {}))
    trainer_cfg = dict(cfg0.get("trainer", {}))
    bundle, (train_data, val_data, test_data) = load_and_setup(cfg0, data_root, device)
    check_waveable(bundle.model)

    loss_str = trainer_cfg.get("loss_str", "bce")
    metric_names = tuple(trainer_cfg.get("metrics", ("loss",)))
    monitor = trainer_cfg.get("val_metric_to_monitor", "loss")
    minimize = ds.get("minimize")
    if minimize is None:
        minimize = monitor in ("loss",)
    sign = 1.0 if minimize else -1.0
    batch_size = int(ds.get("batch_size", 1024))
    seeds = [int(cfg.get("seed", cfg0.get("seed", 0))) for cfg in trial_cfgs]

    if bundle.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(bundle.device)
    inits = [bundle.init(s) for s in seeds]
    num_params = sum(t.numel() for t in inits[0].values())
    state = _stack_states(inits)
    make_optimizer, step = make_wave_step(bundle, loss_str,
                                          compute_dtype=trainer_cfg.get("compute_dtype"))
    adam = make_optimizer(state)

    train_batches = Batches(train_data, batch_size)
    val_batches = Batches(val_data, batch_size)
    test_batches = Batches(test_data, batch_size)
    if len(train_batches) == 0:
        raise ValueError("Training split is empty — nothing to train on.")
    # The sequential records' NFE: a fixed grid's does not depend on the
    # weights (probe once); an adaptive solve's does, so each lane's is
    # re-probed at its own trained weights after every epoch it is active
    # in, and accumulated (the JAX wave's bookkeeping).
    nfe_adaptive = _nfe_is_adaptive(bundle.model)
    nfe_fixed = None if nfe_adaptive else _probe_nfe(bundle, state, train_batches)
    nfe_total = np.zeros(k, np.int64)

    best_score = np.full(k, np.inf)
    best_state = {key: v.detach().clone() for key, v in state.items()}
    best_epoch = np.zeros(k, np.int64)
    plateau_count = np.zeros(k, np.int64)
    plateau_best = np.full(k, np.inf)   # val LOSS, the plateau scheduler's track
    stall_count = np.zeros(k, np.int64)
    decay = np.ones(k, np.float64)
    active = np.ones(k, bool)
    epochs_run = np.zeros(k, np.int64)
    histories: List[list] = [[] for _ in range(k)]

    t_start = time.perf_counter()
    n_wave_epochs = 0
    for epoch in range(int(max_epochs_arr.max())):
        # A lane past its own max_epochs freezes: its bookkeeping stops and
        # it rides the stacked step, as an early-stopped lane does.
        active = active & (epoch < max_epochs_arr)
        if not active.any():
            break
        # The serial step's group rates: lr * lr_scale and
        # lr * final_mult * lr_scale, in that order.
        lr_rest = [float(lrs[i]) * float(decay[i]) for i in range(k)]
        lr_final = [float(lrs[i]) * float(final_mults[i]) * float(decay[i]) for i in range(k)]
        for inputs, labels in train_batches:
            values = step(state, adam, bundle.prepare_batch(inputs),
                          bundle.prepare_labels(labels), lr_rest, lr_final)
        device_sync(values)
        epochs_run[active] = epoch + 1
        n_wave_epochs = epoch + 1
        if nfe_adaptive:
            per_lane = _probe_nfe(bundle, state, train_batches)
            if per_lane is not None:
                nfe_total += np.where(active, per_lane, 0)

        val_results = _wave_evaluate(bundle, state, val_batches, loss_str, metric_names, k)
        scores = np.asarray([sign * r[monitor] for r in val_results], np.float64)
        for i in range(k):
            if active[i]:
                histories[i].append({"epoch": epoch, "lr_scale": float(decay[i]),
                                     **val_results[i]})
        if verbose:
            print(f"wave epoch {epoch}: scores {scores}")

        # harness.train's rules per lane: the best epoch and early stopping
        # on the monitored score with strict improvement; the plateau
        # scheduler on val loss with a relative threshold and the min_lr
        # clamp.
        val_losses = np.asarray([r["loss"] for r in val_results], np.float64)
        improved = active & (scores < best_score)
        if improved.any():
            best_state = _select_rows(improved, state, best_state)
        best_score = np.where(improved, scores, best_score)
        best_epoch = np.where(improved, epoch, best_epoch)
        stall_count = np.where(improved, 0, stall_count + active)
        loss_improved = active & (val_losses < plateau_best * (1.0 - PLATEAU_REL_THRESHOLD))
        plateau_best = np.where(loss_improved, val_losses, plateau_best)
        plateau_count = np.where(loss_improved, 0, plateau_count + active)
        decayed = active & (plateau_count > plateau_patience)
        decay = np.where(decayed, np.maximum(decay * plateau_factor, PLATEAU_MIN_LR / lrs),
                         decay)
        plateau_count = np.where(decayed, 0, plateau_count)
        active = active & ~(stall_count >= early_stop_patience)
        if not active.any():
            break
    elapsed = time.perf_counter() - t_start

    split_results = {
        split: _wave_evaluate(bundle, best_state, batches, loss_str, metric_names, k)
        for split, batches in (("train", train_batches), ("val", val_batches),
                               ("test", test_batches))
    }
    # Cost: every wave epoch advances the K lanes in lockstep, so an epoch
    # costs wall / K a lane, and a lane is billed only the epochs it was
    # active (a lane frozen early still rides the step: that waste is the
    # wave's, so the costs stay comparable with serial records).
    per_epoch_share = elapsed / max(n_wave_epochs, 1) / k
    results = []
    for i in range(k):
        e_i = max(int(epochs_run[i]), 1)
        if nfe_adaptive and nfe_total[i] > 0:
            nfe_i = int(nfe_total[i])
            nfe_per_epoch_i = nfe_i / e_i
        else:
            nfe_per_epoch_i = None if nfe_fixed is None else nfe_fixed[i]
            nfe_i = None if nfe_fixed is None else nfe_fixed[i] * int(epochs_run[i])
        res = {
            "num_params": int(num_params),
            "elapsed_time": per_epoch_share * e_i,
            "time_per_epoch": per_epoch_share,
            "epochs_run": int(epochs_run[i]),
            "best_epoch": int(best_epoch[i]),
            "nfe_per_epoch": nfe_per_epoch_i,
            "nfe": nfe_i,
            "memory_usage": None,
            "history": histories[i],
        }
        for split, per_trial in split_results.items():
            res.update({f"{split}.{kk}": v for kk, v in per_trial[i].items()})
        res["best_params"] = {key: v[i].clone() for key, v in best_state.items()}
        results.append(res)
    return results
