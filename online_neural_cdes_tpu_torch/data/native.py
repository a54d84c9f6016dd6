"""ctypes binding to the repository's native C++ preprocessing library
(``csrc/preprocess.cpp``): ragged forward fill, linear NaN infill,
rectilinear preparation, natural-cubic and Hermite-cubic coefficients and
GRU-D delta/mask, one pass per series, threaded over series.

The port's own binding, with the JAX package's ``data/native.py``
signatures.  ``build()`` compiles the source with ``g++`` into
``build/native/`` beside the package (git-ignored), and again whenever the
source is newer than the library.  A failed build raises: a ragged corpus
then takes the plain path only when the caller asks for it
(``data.common.interpolate(..., use_native=False)``), whose results are
the same.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "build",
    "forward_fill_ragged",
    "linear_fill_ragged",
    "rectilinear_ragged",
    "natural_cubic_ragged",
    "hermite_ragged",
    "delta_mask_ragged",
]

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "csrc" / "preprocess.cpp"
LIBRARY = _REPO / "build" / "native" / "libncde_preprocess.so"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lib: Optional[ctypes.CDLL] = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def build() -> Path:
    """Compile the library unless it is newer than its source; returns
    its path.  Raises if ``g++`` fails."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native preprocessing library from {SOURCE} failed "
            f"(g++ exit {proc.returncode}); interpolate(..., use_native=False) "
            f"takes the plain path, with the same results:\n{proc.stdout}")
    os.replace(tmp, LIBRARY)  # atomic: a concurrent loader never sees half a file
    return LIBRARY


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.ncde_forward_fill.argtypes = [_f32p, _i64p, _i64, _i64]
    lib.ncde_linear_fill.argtypes = [_f32p, _f64p, _i64p, _i64, _i64]
    lib.ncde_rectilinear.argtypes = [_f32p, _f32p, _i64p, _i64p, _i64, _i64, _i64]
    lib.ncde_natural_cubic.argtypes = [_f32p, _f64p, _f32p, _i64p, _i64p, _i64, _i64]
    lib.ncde_hermite.argtypes = [_f32p, _f64p, _f32p, _i64p, _i64p, _i64, _i64]
    lib.ncde_delta_mask.argtypes = [_f32p, _f32p, _f32p, _i64p, _i64, _i64]
    _lib = lib
    return lib


def _ragged_pack(series: Sequence[np.ndarray], min_length: int = 1):
    lengths = np.asarray([len(s) for s in series], np.int64)
    if len(lengths) == 0:
        raise ValueError("empty series list")
    if lengths.min() < min_length:
        # The 2L-1 rectilinear rows and L-1 cubic pieces go negative for
        # shorter series, which would make the library write out of bounds.
        raise ValueError(
            f"every series must have at least {min_length} rows; got "
            f"lengths down to {int(lengths.min())}"
        )
    offsets = _offsets(lengths)
    flat = np.concatenate([np.ascontiguousarray(s, np.float32) for s in series])
    return flat, offsets


def _times(times, offsets, flat) -> np.ndarray:
    """The concatenated per-series times (0..L_i-1 by default), checked
    against the series' rows."""
    if times is None:
        return np.concatenate([np.arange(n, dtype=np.float64) for n in np.diff(offsets)])
    t = np.concatenate([np.asarray(x, np.float64) for x in times])
    if t.shape[0] != flat.shape[0]:
        raise ValueError(
            f"concatenated times have {t.shape[0]} rows but the series have "
            f"{flat.shape[0]} — per-series times must match series lengths"
        )
    return np.ascontiguousarray(t)


def _unpack(flat: np.ndarray, offsets: np.ndarray) -> List[np.ndarray]:
    return [flat[offsets[i]: offsets[i + 1]] for i in range(len(offsets) - 1)]


def _offsets(lengths) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def forward_fill_ragged(series: Sequence[np.ndarray]) -> List[np.ndarray]:
    lib = _load()
    flat, offsets = _ragged_pack(series)
    lib.ncde_forward_fill(flat, offsets, len(series), flat.shape[-1])
    return _unpack(flat, offsets)


def linear_fill_ragged(series: Sequence[np.ndarray],
                       times: Optional[Sequence[np.ndarray]] = None) -> List[np.ndarray]:
    lib = _load()
    flat, offsets = _ragged_pack(series)
    lib.ncde_linear_fill(flat, _times(times, offsets, flat), offsets, len(series),
                         flat.shape[-1])
    return _unpack(flat, offsets)


def rectilinear_ragged(series: Sequence[np.ndarray], time_index: int = 0) -> List[np.ndarray]:
    lib = _load()
    flat, offsets = _ragged_pack(series, min_length=1)
    out_offsets = _offsets(2 * np.diff(offsets) - 1)
    out = np.empty((out_offsets[-1], flat.shape[-1]), np.float32)
    lib.ncde_rectilinear(flat, out, offsets, out_offsets, len(series),
                         flat.shape[-1], time_index)
    return _unpack(out, out_offsets)


def _cubic_coeffs_ragged(entry_point, series, times) -> List[np.ndarray]:
    """Packed [a|b|two_c|three_d] coefficients per series, rows = len-1."""
    lib = _load()
    flat, offsets = _ragged_pack(series, min_length=2)
    channels = flat.shape[-1]
    t = _times(times, offsets, flat)
    piece_offsets = _offsets(np.diff(offsets) - 1)
    coeffs = np.zeros((piece_offsets[-1], 4 * channels), np.float32)
    getattr(lib, entry_point)(flat, t, coeffs, offsets, piece_offsets, len(series),
                              channels)
    return _unpack(coeffs, piece_offsets)


def natural_cubic_ragged(series: Sequence[np.ndarray],
                         times: Optional[Sequence[np.ndarray]] = None) -> List[np.ndarray]:
    """Natural cubic coefficients, packed [a|b|two_c|three_d] per series,
    rows = len-1."""
    return _cubic_coeffs_ragged("ncde_natural_cubic", series, times)


def hermite_ragged(series: Sequence[np.ndarray],
                   times: Optional[Sequence[np.ndarray]] = None) -> List[np.ndarray]:
    """Hermite-cubic (backward differences) coefficients, packed
    [a|b|two_c|three_d] per series, rows = len-1: the causal cubic scheme
    of ``ops/interpolation.py``."""
    return _cubic_coeffs_ragged("ncde_hermite", series, times)


def delta_mask_ragged(series: Sequence[np.ndarray]):
    """GRU-D time-since-last-observation deltas and masks (time in
    channel 0)."""
    lib = _load()
    flat, offsets = _ragged_pack(series)
    delta = np.zeros_like(flat)
    mask = np.zeros_like(flat)
    lib.ncde_delta_mask(flat, delta, mask, offsets, len(series), flat.shape[-1])
    return _unpack(delta, offsets), _unpack(mask, offsets)
