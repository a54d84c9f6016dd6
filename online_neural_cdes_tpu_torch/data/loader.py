"""Ragged-batch padding for serving, and the log-ODE transform of raw
series.

The port's own copies of ``pad_ragged``, ``parse_logsig_string`` and
``apply_logsig_transform`` from the JAX package's ``data/loader.py``
(unchanged semantics).  The transform runs on the card unless the caller
asks for the CPU, and returns numpy, as the JAX package's does.  The rest
of the data pipeline comes with a later slice (ROADMAP item 16).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from online_neural_cdes_tpu_torch.ops.logsig import logsig_windows, num_windows
from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = ["pad_ragged", "parse_logsig_string", "apply_logsig_transform"]


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
