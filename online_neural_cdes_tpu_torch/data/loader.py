"""Ragged-batch padding for serving.

The port's own copy of ``pad_ragged`` from the JAX package's
``data/loader.py`` (host-side numpy, unchanged semantics).  The rest of the
data pipeline comes with a later slice (ROADMAP item 16).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["pad_ragged"]


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
