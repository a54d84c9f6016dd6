"""Losses and metrics with NaN masking for online tasks.

PyTorch counterpart of the JAX package's ``training/metrics.py``: the
ce/bce/mse/rmse pointwise losses, the NaN-masked reductions
``masked_temporal_loss_parts`` / ``masked_temporal_loss`` (a NaN label
marks a finished series and is left out), and ``accuracy`` in numpy.

``auc``, ``auprc``, ``precision`` and ``f1`` are the rank and threshold
statistics the JAX package takes from scikit-learn, here in numpy (the
machine with the card has no scikit-learn), with its rules: ties in the
scores share a threshold (ROC AUC is the trapezoid, average precision the
step sum, over the distinct thresholds), the larger of two label values
is the positive class for the ROC and label 1 for the rest, a single
class gives the ROC NaN with a warning, and labels that are not binary
raise where scikit-learn raises.
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


def _scores(p: np.ndarray) -> np.ndarray:
    return p[:, 0] if p.shape[-1] == 1 else p.max(-1)


def _binary_curve(y: np.ndarray, scores: np.ndarray):
    """(false positives, true positives) at each distinct score threshold,
    highest first (scikit-learn's ``_binary_clf_curve``)."""
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, y = scores[order], y[order]
    last = np.r_[np.nonzero(np.diff(scores))[0], y.size - 1]
    tps = np.cumsum(y)[last]
    return 1.0 + last - tps, tps


def _binary_labels(labels: np.ndarray, what: str) -> np.ndarray:
    classes = np.unique(labels)
    if labels.size == 0:
        raise ValueError(f"{what}: no labelled sample (every label is NaN)")
    if classes.size > 2:
        raise ValueError(f"{what}: labels take {classes.size} values; binary labels only")
    return classes


def auc(preds, labels) -> float:
    """ROC AUC of the scores (the single logit, or the largest of several)
    against binary labels, the larger label value positive."""
    import warnings

    p, l = _flat_mask(preds, labels)
    classes = _binary_labels(l, "auc")
    if classes.size < 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not "
                      "defined in that case.")
        return float("nan")
    fps, tps = _binary_curve((l == classes[1]).astype(np.float64), _scores(p))
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def auprc(preds, labels) -> float:
    """Average precision (the step sum over distinct thresholds, no
    interpolation) of the scores, label 1 positive."""
    import warnings

    p, l = _flat_mask(preds, labels)
    if l.size == 0:
        raise IndexError("auprc: no labelled sample (every label is NaN)")
    classes = _binary_labels(l, "auprc")
    if classes.size == 2 and 1 not in classes:
        raise ValueError(f"auprc: pos_label=1 is not a valid label: {classes}")
    fps, tps = _binary_curve((l == 1).astype(np.float64), _scores(p))
    precision = tps / (tps + fps)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for "
                      "all thresholds.")
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    # Highest threshold first: recall rises from 0.
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _predicted_classes(p: np.ndarray, like_dtype):
    if p.shape[-1] == 1:
        return (1 / (1 + np.exp(-p[:, 0])) > 0.5).astype(like_dtype)
    return p.argmax(-1).astype(like_dtype)


def _class_counts(y_true, y_pred, average):
    """Per class (label 1 alone under ``average="binary"``): true
    positives, predicted and true counts."""
    if y_true.size == 0:
        raise ValueError("Found empty input array (e.g., `y_true` or `y_pred`) while a "
                         "minimum of 1 sample is required.")
    present = np.union1d(y_true, y_pred)
    if average == "binary":
        if present.size > 2:
            raise ValueError("Target is multiclass but average='binary'. Please choose "
                             "another average setting.")
        if present.size == 2 and 1 not in present:
            raise ValueError(f"pos_label=1 is not a valid label: {present}")
        present = np.array([1])
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in present], np.float64)
    pred = np.array([np.sum(y_pred == c) for c in present], np.float64)
    true = np.array([np.sum(y_true == c) for c in present], np.float64)
    return tp, pred, true


def _ratio(num, den):
    """num / den, 0 where den is 0 (``zero_division=0``)."""
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def precision(preds, labels) -> float:
    """NaN-masked precision: of label 1 for a single logit ("binary"), the
    mean over classes for several ("macro"); 0 where nothing is predicted."""
    p, l = _flat_mask(preds, labels)
    avg = "binary" if p.shape[-1] == 1 else "macro"
    tp, pred, _ = _class_counts(l, _predicted_classes(p, l.dtype), avg)
    return float(np.mean(_ratio(tp, pred)))


def f1(preds, labels) -> float:
    """NaN-masked F1, 2 TP / (predicted + true) per class, averaged as
    :func:`precision`; 0 where both counts are 0."""
    p, l = _flat_mask(preds, labels)
    avg = "binary" if p.shape[-1] == 1 else "macro"
    tp, pred, true = _class_counts(l, _predicted_classes(p, l.dtype), avg)
    return float(np.mean(_ratio(2.0 * tp, pred + true)))


METRICS = {"acc": accuracy, "auc": auc, "auprc": auprc,
           "precision": precision, "f1": f1}
