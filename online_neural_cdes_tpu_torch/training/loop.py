"""Training steps for the port's models.

PyTorch counterpart of the JAX package's ``training/loop.py``, in
PyTorch's idiom: a step updates the module's parameters in place through a
``torch.optim.Adam`` and returns the loss as a tensor on the model's device
(no host sync).  The optimizer matches the JAX package's: Adam with a 10x
learning rate on the ``final`` readout, and a runtime ``lr_scale`` (and,
with ``final_lr_multiplier=None``, a runtime ``final_mult``) that set the
two parameter groups' learning rates before each update -- the update of
``optax.scale_by_adam`` followed by ``-lr * mult * lr_scale``.  Labels may
hold NaN (finished series); they are masked out of the loss.

``mesh=`` (data parallelism over several cards) is ROADMAP item 18 and
raises.  ``make_epoch_step`` runs the steps as a plain loop; capturing the
step in a CUDA graph is ROADMAP item D5.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from online_neural_cdes_tpu_torch.training.metrics import (
    make_loss, masked_temporal_loss, masked_temporal_loss_parts,
)

__all__ = ["make_optimizer", "make_train_step", "make_epoch_step",
           "make_eval_step"]


def _refuse_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP item 18: parallel/ as "
            "torch.distributed data parallel)"
        )


def _param_groups(model: nn.Module, final_key: str):
    rest, final = [], []
    for name, p in model.named_parameters():
        (final if name.split(".")[0] == final_key else rest).append(p)
    return rest, final


def make_optimizer(model: nn.Module, lr: float = 5e-3,
                   final_lr_multiplier: float = 10.0,
                   final_key: str = "final") -> torch.optim.Adam:
    """Static-LR Adam with the boosted readout learning rate: the
    parameters under ``final_key`` at ``lr * final_lr_multiplier``, the
    rest at ``lr``.  For plateau scheduling prefer :func:`make_train_step`'s
    built-in ``lr_scale`` argument."""
    rest, final = _param_groups(model, final_key)
    return torch.optim.Adam(
        [{"params": rest, "lr": lr},
         {"params": final, "lr": lr * final_lr_multiplier}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8,
    )


def _compute_dtype(compute_dtype):
    cdt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    if not (isinstance(cdt, torch.dtype) and cdt.is_floating_point):
        raise ValueError(f"compute_dtype must be a floating dtype, got {compute_dtype!r}")
    return cdt


def _cast_floats(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(t, dtype) for t in tree)
    return tree


def _split_batch(tree, n_micro: int):
    """Leaves (B, ...) -> n_micro microbatches along the batch axis."""
    if isinstance(tree, torch.Tensor):
        b = tree.shape[0]
        if b % n_micro:
            raise ValueError(f"accum_steps={n_micro} must divide the batch size {b}")
        return list(tree.split(b // n_micro))
    parts = [_split_batch(t, n_micro) for t in tree]
    return [type(tree)(p[m] for p in parts) for m in range(n_micro)]


def _index(tree, s: int):
    if isinstance(tree, torch.Tensor):
        return tree[s]
    return type(tree)(_index(t, s) for t in tree)


def _make_step_body(model, optimizer, loss, lr, final_lr_multiplier, final_key,
                    compute_dtype=None, accum_steps=None):
    """The per-batch update shared by :func:`make_train_step` and
    :func:`make_epoch_step`."""
    pointwise = make_loss(loss)
    sqrt = loss == "rmse"

    if compute_dtype is None:
        preds_fn = model
    else:
        # Mixed-precision compute: the master weights and Adam stay in
        # their own dtype; the forward and backward run on parameters and
        # float inputs cast to compute_dtype, and gradients return through
        # the casts.  On the card the fused field's kernels take float32
        # and bfloat16.
        cdt = _compute_dtype(compute_dtype)

        def preds_fn(inputs):
            params = {name: p.to(cdt) for name, p in model.named_parameters()}
            out = torch.func.functional_call(model, params, (_cast_floats(inputs, cdt),))
            return out.to(torch.float32)

    n_micro = 1 if accum_steps is None else int(accum_steps)

    def loss_and_grads(inputs, labels):
        """The loss (detached) with the parameters' .grad holding its
        gradient."""
        if n_micro <= 1:
            value = masked_temporal_loss(pointwise, preds_fn(inputs), labels, sqrt=sqrt)
            value.backward()
            return value.detach()
        # Gradient accumulation: microbatches with sum-form masked losses
        # (micro sums add exactly), one update.  For rmse the sqrt is
        # chained on after: d sqrt(m)/dm = 1/(2 sqrt(m)).
        tsum = csum = None
        for mb_in, mb_lab in zip(_split_batch(inputs, n_micro),
                                 _split_batch(labels, n_micro)):
            t, c = masked_temporal_loss_parts(pointwise, preds_fn(mb_in), mb_lab)
            t.backward()
            t = t.detach()
            tsum = t if tsum is None else tsum + t
            csum = c if csum is None else csum + c
        csafe = torch.clamp_min(csum, 1)
        mean = tsum / csafe
        if sqrt:
            value = torch.sqrt(mean)
            scale = 1.0 / (2.0 * torch.clamp_min(value, 1e-12) * csafe)
        else:
            value = mean
            scale = 1.0 / csafe
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(scale.to(p.grad.dtype))
        return value

    if optimizer is not None:

        def step(inputs, labels):
            optimizer.zero_grad(set_to_none=True)
            value = loss_and_grads(inputs, labels)
            optimizer.step()
            return value

        step.optimizer = optimizer
        return step

    adam = make_optimizer(model, lr, 1.0, final_key)
    rest, final = adam.param_groups

    def apply_scaled(inputs, labels, lr_scale, final_mult):
        adam.zero_grad(set_to_none=True)
        value = loss_and_grads(inputs, labels)
        rest["lr"] = lr * lr_scale
        final["lr"] = lr * final_mult * lr_scale
        adam.step()
        return value

    if final_lr_multiplier is None:

        def step(inputs, labels, lr_scale, final_mult):
            return apply_scaled(inputs, labels, float(lr_scale), float(final_mult))

    else:

        def step(inputs, labels, lr_scale):
            return apply_scaled(inputs, labels, float(lr_scale), final_lr_multiplier)

    step.optimizer = adam
    return step


def make_train_step(
    model: nn.Module,
    optimizer: Optional[torch.optim.Optimizer] = None,
    loss: str = "bce",
    lr: float = 5e-3,
    final_lr_multiplier: Optional[float] = 10.0,
    final_key: str = "final",
    mesh=None,
    compute_dtype=None,
    accum_steps: Optional[int] = None,
) -> Callable:
    """Returns a step that updates ``model``'s parameters in place and
    returns the loss as a device tensor.

    With ``optimizer`` given (e.g. from :func:`make_optimizer`):
        ``step(inputs, labels) -> loss``
    Without it, Adam with a runtime learning-rate scale is built in
    (``step.optimizer``):
        ``step(inputs, labels, lr_scale) -> loss``: the learning rate is
        ``lr * lr_scale`` (x ``final_lr_multiplier`` on ``final_key``);
        ``final_lr_multiplier=None`` makes the boost a runtime scalar too:
        ``step(inputs, labels, lr_scale, final_mult)``.
    ``lr_scale`` and ``final_mult`` are host numbers (what a plateau
    scheduler keeps).

    ``compute_dtype``: the forward and backward run with parameters and
    float inputs cast to it; the master weights and the optimizer keep
    theirs.  ``accum_steps=N``: the batch splits into N microbatches with
    sum-form masked losses and one update (N must divide the batch size).
    NaN labels are masked.
    """
    _refuse_mesh(mesh)
    return _make_step_body(model, optimizer, loss, lr, final_lr_multiplier,
                           final_key, compute_dtype, accum_steps)


def make_epoch_step(
    model: nn.Module,
    optimizer: Optional[torch.optim.Optimizer] = None,
    loss: str = "bce",
    lr: float = 5e-3,
    final_lr_multiplier: Optional[float] = 10.0,
    final_key: str = "final",
    mesh=None,
    compute_dtype=None,
    accum_steps: Optional[int] = None,
) -> Callable:
    """One call per epoch: ``inputs``/``labels`` carry a leading steps axis
    ``(S, B, ...)`` and the train step runs over it in order, returning the
    per-step losses ``(S,)``.  Same optimizer and ``lr_scale`` semantics as
    :func:`make_train_step`:

        ``epoch(inputs, labels[, lr_scale[, final_mult]]) -> losses``
    """
    step = make_train_step(model, optimizer, loss, lr, final_lr_multiplier,
                           final_key, mesh, compute_dtype, accum_steps)

    def epoch(inputs, labels, *extra):
        return torch.stack([step(_index(inputs, s), labels[s], *extra)
                            for s in range(labels.shape[0])])

    epoch.optimizer = step.optimizer
    return epoch


def make_eval_step(model: nn.Module, mesh=None) -> Callable:
    """Forward without gradients: ``step(inputs) -> predictions``."""
    _refuse_mesh(mesh)

    def step(inputs):
        with torch.inference_mode():
            return model(inputs)

    return step
