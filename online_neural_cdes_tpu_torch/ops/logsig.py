"""Log-ODE method: log-signatures over windows, in PyTorch.

PyTorch counterpart of the JAX package's ``ops/logsig.py``: log-signatures
of any depth in the truncated tensor algebra with flattened levels, on the
device of the input.

1. each window's piecewise-linear path signature is folded from its
   segments' signatures exp(delta) by Chen's identity (a loop over the M
   segments of batched tensor ops; a ragged window is zero-padded, and a
   zero increment is the identity),
2. the truncated tensor logarithm is taken in closed form,
3. the coefficients of the Lyndon words are gathered (signatory's
   ``mode='words'`` coordinates, in Duval's order of the words).

The window grid (its boundaries, the union with the observation times, the
segments of each window) is host arithmetic in float64, as in the JAX
package.  The transformed series is [x_0-padded first row; per-window
logsigs], cumulative-summed over windows: a shorter path with more
channels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from online_neural_cdes_tpu_torch.ops.fill import linear_fill

__all__ = [
    "logsig_windows",
    "logsignature_windows",
    "logsignature_channels",
    "lyndon_words",
    "num_windows",
]


def num_windows(timespan: float, window_length: float) -> int:
    """The transform's window count for a span (the ragged loader truncates
    each series' output with it)."""
    return int(np.ceil(timespan / window_length - 1e-9))


def lyndon_words(channels: int, depth: int) -> List[Tuple[int, ...]]:
    """All Lyndon words over {0..channels-1} of length <= depth, in
    (length, lexicographic) order -- signatory's channel ordering.
    Generated by Duval's algorithm (any depth)."""
    assert depth >= 1 and channels >= 1
    words: List[Tuple[int, ...]] = []
    w = [-1]
    while w:
        w[-1] += 1
        m = len(w)
        words.append(tuple(w))
        while len(w) < depth:
            w.append(w[len(w) - m])
        while w and w[-1] == channels - 1:
            w.pop()
    words.sort(key=lambda word: (len(word), word))
    return words


def logsignature_channels(channels: int, depth: int) -> int:
    return len(lyndon_words(channels, depth))


def _outer(a, b):
    """Flattened tensor product of two flattened levels."""
    out = a[..., :, None] * b[..., None, :]
    return out.reshape(*a.shape[:-1], a.shape[-1] * b.shape[-1])


def _chen(sig_a, sig_b, depth):
    """Chen's identity for truncated signatures as lists of flattened levels
    [s1 (C,), s2 (C^2,), ..., sd (C^d,)]: the concatenation product
    (1 + A)(1 + B) truncated at ``depth``."""
    out = []
    for k in range(1, depth + 1):
        term = sig_a[k - 1] + sig_b[k - 1]
        for i in range(1, k):
            term = term + _outer(sig_a[i - 1], sig_b[k - i - 1])
        out.append(term)
    return out


def _mul_nounit(a, b, depth):
    """Product of two scalar-free tensor series (levels >= 1 only)."""
    out = []
    for k in range(1, depth + 1):
        term = None
        for i in range(1, k):
            piece = _outer(a[i - 1], b[k - i - 1])
            term = piece if term is None else term + piece
        out.append(torch.zeros_like(a[k - 1]) if term is None else term)
    return out


def _segment_signature(delta, depth):
    """exp(delta): the signature of one linear segment -- level k is
    delta^(x)k / k! (flattened)."""
    levels = [delta]
    for k in range(2, depth + 1):
        levels.append(_outer(levels[-1], delta) / k)
    return levels


def _tensor_log(sig, depth):
    """log(1 + S) = sum_m (-1)^(m+1)/m S^m, truncated at ``depth``."""
    log = list(sig)
    power = sig
    for m in range(2, depth + 1):
        power = _mul_nounit(power, sig, depth)
        coef = ((-1.0) ** (m + 1)) / m
        log = [l + coef * p for l, p in zip(log, power)]
    return log


def _words_index(channels: int, depth: int):
    """Per-length flat indices of the Lyndon words into the flattened level
    arrays."""
    idx = {}
    for word in lyndon_words(channels, depth):
        flat = 0
        for c in word:
            flat = flat * channels + c
        idx.setdefault(len(word), []).append(flat)
    return {k: np.asarray(v, np.int64) for k, v in idx.items()}


def _window_logsig(deltas, depth, words_idx):
    """deltas: (..., M, C) zero-padded segment increments of one window (any
    leading dims, windows among them) -> (..., logsig_channels)
    Lyndon-word coefficients."""
    channels = deltas.shape[-1]
    sig = [deltas.new_zeros(deltas.shape[:-2] + (channels ** k,))
           for k in range(1, depth + 1)]
    for m in range(deltas.shape[-2]):
        sig = _chen(sig, _segment_signature(deltas[..., m, :], depth), depth)
    log = _tensor_log(sig, depth)
    parts = [log[0]]
    for ell in range(2, depth + 1):
        if ell in words_idx:
            index = torch.as_tensor(words_idx[ell], device=deltas.device)
            parts.append(log[ell - 1].index_select(-1, index))
    return torch.cat(parts, dim=-1)


def _logsignature_windows(x, depth, window_length, t, version):
    x = torch.as_tensor(x)
    channels, length = x.shape[-1], x.shape[-2]
    t_np = (np.arange(length, dtype=np.float64) if t is None
            else np.asarray(t, dtype=np.float64))

    # Host-side window grid: boundaries at multiples of window_length,
    # merged into the observation grid.
    timespan = t_np[-1] - t_np[0]
    num_pieces = num_windows(timespan, window_length)
    new_t = np.minimum(t_np[0] + window_length * np.arange(num_pieces + 1), t_np[-1])
    union = np.unique(np.concatenate([t_np, new_t]))
    boundary_pos = np.searchsorted(union, new_t)

    # The (NaN-infilled) linear interpolation on the union grid.
    filled = linear_fill(x, t=torch.as_tensor(t_np, dtype=x.dtype, device=x.device),
                         axis=-2)
    idx = np.clip(np.searchsorted(t_np, union, side="right") - 1, 0, length - 2)
    frac = (union - t_np[idx]) / (t_np[idx + 1] - t_np[idx])
    left = filled[..., torch.as_tensor(idx, device=x.device), :]
    right = filled[..., torch.as_tensor(idx + 1, device=x.device), :]
    xu = left + torch.as_tensor(frac, dtype=x.dtype, device=x.device)[:, None] * (right - left)

    # Zero-padded per-window segment increments (zero = Chen identity).
    deltas = xu[..., 1:, :] - xu[..., :-1, :]
    seg_window = np.searchsorted(boundary_pos[1:], np.arange(len(union) - 1), "right")
    max_segs = int(np.max(np.bincount(seg_window, minlength=num_pieces)))
    gather = np.full((num_pieces, max_segs), len(union) - 1, dtype=np.int64)
    for w in range(num_pieces):
        segs = np.nonzero(seg_window == w)[0]
        gather[w, : len(segs)] = segs
    pad = torch.cat([deltas, torch.zeros_like(deltas[..., :1, :])], dim=-2)
    win_deltas = pad[..., torch.as_tensor(gather, device=x.device), :]   # (..., W, M, C)

    words = lyndon_words(channels, depth)
    logsigs = _window_logsig(win_deltas, depth, _words_index(channels, depth))

    if version == 0:
        widths = torch.as_tensor(np.diff(new_t), dtype=x.dtype, device=x.device)
        logsigs = logsigs * widths[:, None]

    first = x.new_zeros(x.shape[:-2] + (1, len(words)))
    first[..., 0, :channels] = xu[..., 0, :]
    path = torch.cumsum(torch.cat([first, logsigs], dim=-2), dim=-2)
    if version == 0:
        return path, torch.as_tensor(new_t, dtype=x.dtype, device=x.device)
    return path


def logsig_windows(x, depth: int, window_length, t=None):
    """Transformed path of shape (..., num_windows+1, logsig_channels);
    times are the implicit unit grid."""
    return _logsignature_windows(x, depth, window_length, t, version=1)


def logsignature_windows(x, depth: int, window_length, t=None):
    """The deprecated variant with the window-width rescaling; returns
    (values, times)."""
    return _logsignature_windows(x, depth, window_length, t, version=0)
