"""Losses and metrics with NaN masking for online tasks.

PyTorch counterpart of the JAX package's ``training/metrics.py``: the
ce/bce/mse/rmse pointwise losses, the NaN-masked reductions
``masked_temporal_loss_parts`` / ``masked_temporal_loss`` (a NaN label
marks a finished series and is left out), and ``accuracy`` in numpy.

``auc``, ``auprc``, ``precision`` and ``f1`` are rank and threshold
statistics that the JAX package takes from scikit-learn on the host; the
machine with the card has no scikit-learn, so they raise until ROADMAP
item 20 ports them without it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["make_loss", "masked_temporal_loss", "masked_temporal_loss_parts",
           "accuracy", "auc", "auprc", "precision", "f1", "METRICS"]


def _bce_logits(logits, labels):
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _ce_logits(logits, labels):
    # labels: integer class ids
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def _mse(preds, labels):
    return torch.square(preds - labels)


def make_loss(name: str) -> Callable:
    """Pointwise loss registry; reduce with :func:`masked_temporal_loss` or a
    plain mean.  ``preds`` carry a trailing output-dim axis which bce/mse
    squeeze when it is 1."""

    def squeeze(preds):
        return preds[..., 0] if preds.shape[-1] == 1 else preds

    if name == "bce":
        return lambda preds, labels: _bce_logits(squeeze(preds), labels)
    if name == "ce":
        return lambda preds, labels: _ce_logits(preds, labels)
    if name in ("mse", "rmse"):
        # rmse is a reduction-level transform: pointwise it is mse, and
        # masked_temporal_loss applies the sqrt.
        return lambda preds, labels: _mse(squeeze(preds), labels)
    raise ValueError(f"Unknown loss {name!r}")


def masked_temporal_loss_parts(pointwise, preds, labels):
    """(sum of the pointwise loss over non-NaN labels, non-NaN count), the
    accumulable form of :func:`masked_temporal_loss`: microbatch sums add
    exactly."""
    # One-shot labels stored with a trailing singleton axis ((N, 1)) align
    # with the squeezed (B,) predictions instead of broadcasting to (B, B).
    if labels.dim() >= 2 and labels.shape[-1] == 1 and labels.dim() == preds.dim():
        labels = labels[..., 0]
    mask = ~torch.isnan(labels)
    safe_labels = torch.where(mask, labels, torch.zeros_like(labels))
    values = pointwise(preds, safe_labels)
    # For ce the mask may lack the trailing class axis; broadcast.
    mask = torch.broadcast_to(mask, values.shape)
    total = torch.sum(torch.where(mask, values, torch.zeros_like(values)))
    return total, torch.sum(mask, dtype=values.dtype)


def masked_temporal_loss(pointwise, preds, labels, sqrt: bool = False):
    """Mean of the pointwise loss over non-NaN labels; works for per-step
    (online) and terminal labels."""
    total, count = masked_temporal_loss_parts(pointwise, preds, labels)
    mean = total / torch.clamp_min(count, 1)
    return torch.sqrt(mean) if sqrt else mean


# -- host-side evaluation metrics (NaN labels masked out) -------------------

def _flat_mask(preds, labels):
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds)
    preds = preds.reshape(-1, preds.shape[-1]) if preds.ndim > 1 else preds.reshape(-1, 1)
    keep = ~np.isnan(labels)
    return preds[keep], labels[keep]


def accuracy(preds, labels) -> float:
    p, l = _flat_mask(preds, labels)
    if p.shape[-1] == 1:
        pred_cls = (1 / (1 + np.exp(-p[:, 0])) > 0.5).astype(l.dtype)
    else:
        pred_cls = p.argmax(-1).astype(l.dtype)
    return float((pred_cls == l).mean())


def _needs_sklearn(name):
    def metric(preds, labels) -> float:
        raise NotImplementedError(
            f"{name} is not ported yet: the JAX package computes it with "
            "scikit-learn, which the card's machine lacks (ROADMAP item 20)"
        )

    metric.__name__ = name
    return metric


auc = _needs_sklearn("auc")
auprc = _needs_sklearn("auprc")
precision = _needs_sklearn("precision")
f1 = _needs_sklearn("f1")

METRICS = {"acc": accuracy, "auc": auc, "auprc": auprc,
           "precision": precision, "f1": f1}
