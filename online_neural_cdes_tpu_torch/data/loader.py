"""Data loading: interpolation-key parsing, the log-ODE transform of raw
series, rectilinear-intensity augmentation, sort-by-length and
length-bucketed padding, batch iteration.

PyTorch counterpart of the JAX package's ``data/loader.py``, with its
semantics: ``load_numpy_data`` reads a processed npz into train / val /
test ``LoadedData``, and ``Batches`` yields numpy ``(inputs, labels)``
batches, ragged series padded per batch to lengths rounded up to
``bucket_multiple`` (so a run sees few distinct shapes).  The log-ODE
transform runs on the card unless the caller asks for the CPU, and
returns numpy, as the JAX package's does.  Batches stay numpy: the
consumer moves them to the card (``data.prefetch.prefetch_to_device``, or
``.to``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from online_neural_cdes_tpu_torch.ops.logsig import logsig_windows, num_windows
from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = [
    "parse_interpolation_string",
    "parse_logsig_string",
    "apply_logsig_transform",
    "load_numpy_data",
    "sort_unequal_lengths",
    "pad_ragged",
    "add_rectilinear_intensity",
    "Batches",
    "LoadedData",
]


def parse_interpolation_string(interpolation: Optional[str]):
    """user interpolation string -> (data array key, model scheme)."""
    if interpolation in ("linear", "rectilinear", "cubic"):
        return interpolation, interpolation
    if interpolation == "rectilinear-intensity":
        return "rectilinear", interpolation
    if interpolation in ("linear_cubic_smoothing", "linear_quintic_smoothing"):
        return "linear", interpolation
    if interpolation == "linear_forward_fill":
        return interpolation, "linear"
    if interpolation == "cubic_forward_fill":
        return "linear_forward_fill", "linear_cubic_smoothing"
    if interpolation == "hermite":
        return "hermite", "hermite"
    if interpolation is not None and interpolation.startswith("logsig"):
        # "logsig-<depth>-<window>": the raw series become per-window
        # depth-d log-signature increments (the log-ODE method).
        parse_logsig_string(interpolation)  # validate eagerly
        return "raw", interpolation
    if interpolation is None:
        return "raw", None
    raise NotImplementedError(f"Not implemented for interpolation {interpolation}")


def parse_logsig_string(interpolation: str) -> Tuple[int, float]:
    """'logsig-<depth>-<window>' -> (depth, window_length in observation-index
    units).  e.g. 'logsig-2-8' = depth-2 log-signatures over 8-step windows."""
    parts = interpolation.split("-")
    if len(parts) != 3:
        raise ValueError(
            f"logsig interpolation key must be 'logsig-<depth>-<window>', "
            f"got {interpolation!r}"
        )
    depth, window = int(parts[1]), float(parts[2])
    if depth < 1 or window <= 0:
        raise ValueError(f"invalid logsig depth/window in {interpolation!r}")
    return depth, window


def apply_logsig_transform(temporal, depth: int, window: float, chunk: int = 512,
                           device=None) -> np.ndarray:
    """Log-ODE preprocessing of raw (..., L, C) series in float32 (NaNs are
    linearly in-filled by the transform), ``chunk`` series at a time on
    ``device`` (the card unless ``device="cpu"``); returns numpy.  A ragged
    corpus (an object array of (L_i, C) series) runs as one batch: every
    series NaN-padded to the longest (the in-fill repeats the last row, so
    pad rows have zero increments, Chen's identity), then each truncated to
    its own window count."""
    device = resolve_device(device)

    def transform(block):
        x = torch.from_numpy(np.asarray(block, np.float32)).to(device)
        return logsig_windows(x, depth, window).cpu().numpy()

    if temporal.dtype == object:
        lens = [len(t) for t in temporal]
        c = np.asarray(temporal[0]).shape[-1]
        padded = np.full((len(temporal), max(lens), c), np.nan, np.float32)
        for i, t in enumerate(temporal):
            padded[i, : lens[i]] = np.asarray(t, np.float32)
        full = np.concatenate([transform(padded[i: i + chunk])
                               for i in range(0, len(padded), chunk)], axis=0)
        out = np.empty(len(temporal), dtype=object)
        for i, length in enumerate(lens):
            out[i] = full[i, : num_windows(length - 1, window) + 1]
        return out
    return np.concatenate([transform(temporal[i: i + chunk])
                           for i in range(0, len(temporal), chunk)], axis=0)


def sort_unequal_lengths(static, temporal, labels):
    """Sort ragged series shortest-first."""
    lengths = [len(x) for x in temporal]
    order = sorted(range(len(lengths)), key=lambda k: lengths[k])
    static = None if static is None else static[order]
    temporal = [temporal[i] for i in order]
    if isinstance(labels, list):
        labels = [labels[i] for i in order]
    else:
        labels = labels[order]
    return static, temporal, labels, order


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_ragged(
    series: Sequence[np.ndarray],
    bucket_multiple: int = 16,
    forward_fill: bool = True,
    pad_value: float = np.nan,
    target_len: Optional[int] = None,
) -> np.ndarray:
    """Pad a list of (L_i, C) arrays to a common bucketed length (or the
    explicit ``target_len``).  With ``forward_fill`` the pad region repeats
    the final row; otherwise it is ``pad_value``."""
    max_len = max(len(s) for s in series)
    target = target_len if target_len is not None else _round_up(max_len, bucket_multiple)
    if target < max_len:
        raise ValueError(f"target length {target} < longest series {max_len}")
    trailing = np.asarray(series[0]).shape[1:]
    out = np.full((len(series), target) + trailing, pad_value, dtype=np.float32)
    for i, s in enumerate(series):
        s = np.asarray(s, dtype=np.float32)
        out[i, : len(s)] = s
        if forward_fill and len(s) < target:
            out[i, len(s):] = s[-1]
    return out


def add_rectilinear_intensity(rect_coeffs: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Append cumulative per-channel measurement counts as extra channels to
    rectilinear coefficients.  ``raw`` is the un-interpolated series (L, C)
    with time in channel 0; zero times past the series end count as
    unobserved."""
    raw = np.array(raw, copy=True)
    raw[0, :][raw[0, :] == 0] = np.nan
    observed = ~np.isnan(raw[:, 1:])
    counts = np.cumsum(observed, axis=0).astype(rect_coeffs.dtype)
    counts = np.repeat(counts, 2, axis=0)[:-1]  # interleave-lag to 2L-1
    return np.concatenate([rect_coeffs, counts], axis=1)


@dataclasses.dataclass
class LoadedData:
    """One split's data plus problem metadata."""

    static: Optional[np.ndarray]
    temporal: object              # array (N, L, C) or list of ragged arrays
    labels: object
    input_dim: int
    output_dim: int
    static_dim: Optional[int]
    model_interpolation: Optional[str]
    return_sequences: bool


def load_numpy_data(
    npz_path: str,
    interpolation: Optional[str],
    use_static: bool = True,
    problem: Optional[str] = None,
    output_dim: int = 1,
    label_dtype: Optional[str] = None,
    device=None,
) -> List[LoadedData]:
    """Load a processed npz and return [train, val, test] LoadedData.  A
    ``logsig-<depth>-<window>`` key transforms the raw series on
    ``device`` (the card unless ``device="cpu"``)."""
    npz = np.load(npz_path, allow_pickle=True)
    data_key, model_interpolation = parse_interpolation_string(interpolation)

    use_static = use_static and "static_data" in npz.files and interpolation is not None
    static = npz["static_data"].astype(np.float32) if use_static else None
    temporal = npz[f"temporal_data_{data_key}"]
    labels = npz["labels"]
    splits = [npz[k] for k in ("train_idxs", "val_idxs", "test_idxs")]

    if model_interpolation == "rectilinear-intensity":
        model_interpolation = "rectilinear"
        raw = npz["temporal_data_raw"]
        temporal = np.array(
            [add_rectilinear_intensity(np.asarray(t), np.asarray(r))
             for t, r in zip(temporal, raw)],
            dtype=object,
        ) if temporal.dtype == object else np.stack(
            [add_rectilinear_intensity(t, r) for t, r in zip(temporal, raw)]
        )

    if model_interpolation is not None and model_interpolation.startswith("logsig"):
        # Each transformed row summarises a whole window, so per-timestep
        # labels cannot align with it: a one-shot tool only.
        if problem == "online":
            raise ValueError(
                "logsig interpolation compresses the time axis (one row per "
                "window); online problems' per-timestep labels cannot align "
                "with it — use it for one-shot tasks."
            )
        depth, window = parse_logsig_string(model_interpolation)
        temporal = apply_logsig_transform(temporal, depth, window, device=device)
        # The transformed path is consumed as a piecewise-linear control.
        model_interpolation = "linear"

    ragged = temporal.dtype == object
    first = np.asarray(temporal[0])
    input_dim = (
        first.shape[-1] // 4 if data_key in ("cubic", "hermite") else first.shape[-1]
    )
    static_dim = static.shape[-1] if use_static else None
    return_sequences = problem == "online"

    out = []
    for idxs in splits:
        st = None if static is None else static[idxs]
        tp = [np.asarray(temporal[i]) for i in idxs] if ragged else temporal[idxs]
        lb = (
            [np.asarray(labels[i]) for i in idxs]
            if labels.dtype == object
            else labels[idxs]
        )
        if ragged:
            st, tp, lb, _ = sort_unequal_lengths(st, tp, lb)
        if label_dtype is not None and not isinstance(lb, list):
            lb = lb.astype(label_dtype)
        out.append(
            LoadedData(
                static=st, temporal=tp, labels=lb,
                input_dim=input_dim, output_dim=output_dim,
                static_dim=static_dim,
                model_interpolation=model_interpolation,
                return_sequences=return_sequences,
            )
        )
    return out


class Batches:
    """Iterate numpy ``(inputs, labels)`` batches: ``inputs`` is the
    temporal batch, or ``(static, temporal)`` with statics.  Ragged series
    are padded per batch to a bucketed length (forward-filled), ragged
    online labels to theirs (NaN, which the losses mask)."""

    def __init__(
        self,
        data: LoadedData,
        batch_size: int = 1024,
        bucket_multiple: int = 16,
        forward_fill: bool = True,
    ):
        self.data = data
        self.batch_size = batch_size
        self.bucket_multiple = bucket_multiple
        self.forward_fill = forward_fill

    def __len__(self):
        n = len(self.data.temporal)
        return (n + self.batch_size - 1) // self.batch_size

    def _temporal_target(self, label_target: int) -> int:
        """Pad target for the coefficient rows so that the model's output
        length matches the padded labels: rectilinear rows are 2L-1,
        cubic/hermite piece rows are L-1, linear-family rows are L."""
        mi = self.data.model_interpolation
        if mi in ("rectilinear", "rectilinear-intensity"):
            return 2 * label_target - 1
        if mi in ("cubic", "hermite"):
            return label_target - 1
        return label_target

    def __iter__(self) -> Iterator[Tuple[object, np.ndarray]]:
        d = self.data
        n = len(d.temporal)
        for start in range(0, n, self.batch_size):
            sl = slice(start, min(start + self.batch_size, n))
            temporal = d.temporal[sl]
            labels = d.labels[sl]
            label_target = None
            if isinstance(labels, list):
                # Online labels may carry a trailing singleton dim (the
                # MIMIC tasks store (L, 1)); flatten to (L,).
                flat = []
                for lab in labels:
                    lab = np.atleast_1d(np.asarray(lab))
                    if lab.ndim == 2 and lab.shape[1] == 1:
                        lab = lab[:, 0]
                    flat.append(lab)
                label_target = _round_up(
                    max(len(lab) for lab in flat), self.bucket_multiple
                )
                labels = pad_ragged(
                    flat, self.bucket_multiple, forward_fill=False,
                    target_len=label_target,
                )
            if isinstance(temporal, list):
                target = (
                    self._temporal_target(label_target)
                    if label_target is not None
                    else None
                )
                temporal = pad_ragged(
                    temporal, self.bucket_multiple, self.forward_fill,
                    target_len=target,
                )
            inputs = temporal if d.static is None else (d.static[sl], temporal)
            yield inputs, np.asarray(labels)
