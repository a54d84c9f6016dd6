"""Dataset preprocessing: normalisation, time channels, interpolation
precompute, train/val/test splits, npz persistence.

PyTorch counterpart of the JAX package's ``data/common.py``: the
processed-dataset contract is an ``.npz`` holding
``temporal_data_{linear,rectilinear,cubic,linear_forward_fill,hermite,raw}``,
``static_data``, ``labels`` and ``{train,val,test}_idxs``, which the loader
consumes per interpolation key.

An equal-length corpus (an array (N, L, C)) goes through the port's
coefficient builders (``ops.interpolation``) on the card unless the caller
asks for the CPU; a ragged one goes through the native C++ library
(``data.native``), or, with ``use_native=False``, through the builders one
length at a time.  ``train_val_test_indices`` is numpy code that returns
the indices of scikit-learn's ``train_test_split`` (which the port does
not import) for a seed.
"""

from __future__ import annotations

import numbers
import os
from math import ceil
from typing import List, Optional

import numpy as np
import torch

from online_neural_cdes_tpu_torch.ops.interpolation import (
    hermite_cubic_coefficients_with_backward_differences,
    linear_interpolation_coeffs,
    natural_cubic_coeffs,
)
from online_neural_cdes_tpu_torch.utils.device import resolve_device

INTERPOLATION_METHODS = (
    "linear",
    "rectilinear",
    "cubic",
    "linear_forward_fill",
    "hermite",
)


def add_time(temporal_data: np.ndarray) -> np.ndarray:
    """Prepend a 0..L-1 time channel."""
    times = np.repeat(
        np.arange(temporal_data.shape[1]).reshape(1, -1, 1), len(temporal_data), 0
    )
    return np.concatenate([times, temporal_data], axis=-1)


def normalise(data) -> list:
    """NaN-aware z-score with statistics over all samples and times.
    ``data``: an array (N, L, C) or a ragged list."""
    if isinstance(data, np.ndarray) and data.ndim == 3:
        flat = data.reshape(-1, data.shape[-1])
        seq = [d for d in data]
    else:
        seq = [np.asarray(d) for d in data]
        flat = np.concatenate(seq, axis=0)
    mean = np.nanmean(flat, axis=0)
    std = np.nanstd(flat, axis=0)
    return [(d - mean) / (std + 1e-6) for d in seq]


def negative_filter(static: np.ndarray) -> np.ndarray:
    """Mark negative placeholder entries as missing."""
    out = np.array(static, dtype=np.float64, copy=True)
    out[out < 0] = np.nan
    return out


def static_pipeline(static: np.ndarray) -> np.ndarray:
    """negative-filter -> z-score -> constant-impute 0."""
    out = negative_filter(static)
    mean = np.nanmean(out, axis=0)
    std = np.nanstd(out, axis=0)
    out = (out - mean) / (std + 1e-6)
    out[np.isnan(out)] = 0.0
    return out.astype(np.float32)


def _coeff_fn(method: str):
    if method == "linear":
        return linear_interpolation_coeffs
    if method == "rectilinear":
        return lambda x: linear_interpolation_coeffs(x, rectilinear=0)
    if method == "linear_forward_fill":
        return lambda x: linear_interpolation_coeffs(x, forward_fill=True)
    if method == "cubic":
        return natural_cubic_coeffs
    if method == "hermite":
        return hermite_cubic_coefficients_with_backward_differences
    raise ValueError(method)


def _zero_first_nans(arr: np.ndarray) -> None:
    first = arr[..., :1, :]
    first[np.isnan(first)] = 0.0


def interpolate(data, method: str = "linear", initial_nan_to_zero: bool = True,
                use_native: bool = True, device=None):
    """Coefficients of ``method`` for an array (N, L, C) or a ragged list,
    with the causal fill of initial NaNs by 0.  An array runs through the
    port's builders on ``device`` (the card unless ``device="cpu"``) and
    comes back as numpy.  A ragged list runs through the native library
    (a failed build raises), or, with ``use_native=False``, through the
    builders one distinct length at a time."""
    fn = _coeff_fn(method)

    def one_batch(arr):
        arr = np.array(arr, dtype=np.float32, copy=True)
        if initial_nan_to_zero:
            _zero_first_nans(arr)
        x = torch.from_numpy(arr).to(resolve_device(device))
        return fn(x).cpu().numpy()

    if isinstance(data, np.ndarray) and data.ndim == 3:
        return one_batch(data)
    if use_native:
        return _interpolate_native(data, method, initial_nan_to_zero)

    lengths = [len(d) for d in data]
    out: List[Optional[np.ndarray]] = [None] * len(data)
    for length in sorted(set(lengths)):
        idxs = [i for i, n in enumerate(lengths) if n == length]
        coeffs = one_batch(np.stack([np.asarray(data[i]) for i in idxs]))
        for j, i in enumerate(idxs):
            out[i] = coeffs[j]
    return out


def _interpolate_native(data, method: str, initial_nan_to_zero: bool):
    from online_neural_cdes_tpu_torch.data import native

    series = []
    for d in data:
        d = np.array(d, dtype=np.float32, copy=True)
        if initial_nan_to_zero:
            _zero_first_nans(d)
        series.append(d)
    if method == "cubic":
        return native.natural_cubic_ragged(series)
    if method == "hermite":
        return native.hermite_ragged(series)
    if method == "rectilinear":
        series = native.rectilinear_ragged(series, time_index=0)
        return native.linear_fill_ragged(series)
    if method == "linear_forward_fill":
        series = native.forward_fill_ragged(series)
    return native.linear_fill_ragged(series)


# ----------------------------------------------------------------- splits
# scikit-learn's train_test_split (ShuffleSplit / StratifiedShuffleSplit,
# one split) step for step: the same size arithmetic, the same draws from
# a RandomState in the same order, and a ValueError wherever it raises
# one.


def _check_random_state(seed):
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def _split_sizes(n_samples: int, test_size):
    """(n_train, n_test) of a split with ``test_size`` (a fraction, or a
    count) and the rest for training."""
    kind = np.asarray(test_size).dtype.kind
    if (kind == "i" and (test_size >= n_samples or test_size <= 0)) or (
            kind == "f" and (test_size <= 0 or test_size >= 1)):
        raise ValueError(f"test_size={test_size} should be either positive and smaller "
                         f"than the number of samples {n_samples} or a float in the "
                         "(0, 1) range")
    if kind not in ("i", "f"):
        raise ValueError(f"Invalid value for test_size: {test_size}")
    n_test = ceil(test_size * n_samples) if kind == "f" else int(test_size)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples} and test_size={test_size} the "
                         "resulting train set will be empty")
    return int(n_train), int(n_test)


def _check_labels(y, n_samples: int) -> np.ndarray:
    """The checks scikit-learn makes of stratification labels."""
    y = np.asarray(y)
    if y.ndim == 0:
        raise TypeError(f"Singleton array {y!r} cannot be considered a valid collection.")
    if y.ndim > 2:
        raise ValueError(f"Found array with dim {y.ndim}; expected <= 2.")
    if y.shape[0] < 1:
        raise ValueError("Found array with 0 sample(s) while a minimum of 1 is required.")
    if y.dtype.kind == "c":
        raise ValueError("Complex data not supported")
    if y.dtype.kind == "f" and not np.isfinite(y).all():
        raise ValueError("Input y contains NaN or infinity.")
    if y.dtype == object and (y != y).any():
        raise ValueError("Input y contains NaN.")
    if y.shape[0] != n_samples:
        raise ValueError(f"Found input variables with inconsistent numbers of samples: "
                         f"[{n_samples}, {y.shape[0]}]")
    return y


def _approximate_mode(class_counts, n_draws: int, rng) -> np.ndarray:
    """Per-class draws near the mode of the multivariate hypergeometric,
    ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _shuffle_split(n_samples: int, test_size, seed):
    n_train, n_test = _split_sizes(n_samples, test_size)
    permutation = _check_random_state(seed).permutation(n_samples)
    return permutation[n_test:n_test + n_train], permutation[:n_test]


def _stratified_shuffle_split(n_samples: int, test_size, seed, y):
    n_train, n_test = _split_sizes(n_samples, test_size)
    y = _check_labels(y, n_samples)
    if y.ndim == 2:
        y = np.array([" ".join(row.astype("str")) for row in y])
    classes, y_indices, class_counts = np.unique(y, return_inverse=True,
                                                 return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which "
                         f"is too few: {classes[class_counts < 2].tolist()}")
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(f"The train_size = {n_train} and test_size = {n_test} should "
                         f"be greater or equal to the number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = _check_random_state(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[: n_i[i]])
        test.extend(members[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _train_test_split(idxs: np.ndarray, test_size, seed, stratify=None):
    """``sklearn.model_selection.train_test_split(idxs, test_size=...,
    random_state=seed, stratify=stratify)``."""
    if stratify is None:
        train, test = _shuffle_split(len(idxs), test_size, seed)
    else:
        train, test = _stratified_shuffle_split(len(idxs), test_size, seed, stratify)
    return idxs[train], idxs[test]


def train_val_test_indices(length: int, stratification_labels=None,
                           fractions=(0.70, 0.15, 0.15), seed: int = 0):
    """Stratified 70/15/15 split; unstratified where stratification is
    infeasible (a class with one member, a split smaller than the number
    of classes)."""
    idxs = np.arange(length)
    strat = None if stratification_labels is None else np.asarray(stratification_labels)
    test_size = fractions[1] + fractions[2]
    rest_size = fractions[2] / (fractions[1] + fractions[2])
    try:
        train, rest = _train_test_split(idxs, test_size, seed, strat)
        val, test = _train_test_split(rest, rest_size, seed,
                                      None if strat is None else strat[rest])
    except ValueError:
        train, rest = _train_test_split(idxs, test_size, seed)
        val, test = _train_test_split(rest, rest_size, seed)
    return train, val, test


def process_all_interpolations(
    static_data,
    temporal_data,
    stratification_labels=None,
    split: bool = True,
) -> dict:
    """Normalise (which makes the corpus a list, so every interpolation
    runs through the native library), precompute every interpolation's
    coefficients and split."""
    processed = {}
    if static_data is not None:
        processed["static_data"] = static_pipeline(np.asarray(static_data))

    temporal_data = normalise(temporal_data)
    processed["temporal_data_raw"] = temporal_data
    for method in INTERPOLATION_METHODS:
        processed[f"temporal_data_{method}"] = interpolate(temporal_data, method)

    if split:
        train, val, test = train_val_test_indices(
            len(temporal_data), stratification_labels
        )
        processed["train_idxs"] = train
        processed["val_idxs"] = val
        processed["test_idxs"] = test
    return processed


def save_processed(processed: dict, labels, directory: str, test_mode: bool = False):
    """Write ``improved-neural-cdes_data[_test].npz`` under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    payload = dict(processed)
    payload["labels"] = labels
    for key, val in list(payload.items()):
        if isinstance(val, list):
            if all(isinstance(v, np.ndarray) and v.shape == val[0].shape for v in val):
                payload[key] = np.stack(val)
            else:
                payload[key] = np.array(val, dtype=object)
    name = "improved-neural-cdes_data{}.npz".format("_test" if test_mode else "")
    np.savez(os.path.join(directory, name), **payload)
    return os.path.join(directory, name)


def reduce_tensor_samples(tensors, num_samples: int = 100):
    """Shrink datasets for test mode."""
    return [t[:num_samples] for t in tensors]


def rolling_window(x: np.ndarray, window_size: int, step_size: int = 1,
                   return_same_size: bool = True) -> np.ndarray:
    """(N, L, C) -> (N, L', C, W) rolling windows over time."""
    x = np.asarray(x)
    if return_same_size:
        pad = np.full((x.shape[0], window_size - 1, x.shape[2]), np.nan, x.dtype)
        x = np.concatenate([pad, x], axis=1)
    n, length, channels = x.shape
    n_windows = (length - window_size) // step_size + 1
    out = np.empty((n, n_windows, channels, window_size), x.dtype)
    for w in range(n_windows):
        start = w * step_size
        out[:, w] = np.moveaxis(x[:, start:start + window_size], 1, -1)
    return out
