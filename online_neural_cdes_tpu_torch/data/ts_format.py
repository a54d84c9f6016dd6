"""Reader for the sktime/UEA ``.ts`` time-series file format.

Numpy counterpart of the JAX package's ``data/ts_format.py``, with its
semantics: multivariate series with optional class labels (UEA
classification) or regression targets (TSER), '?' missing values and
ragged lengths, in both on-disk layouts:

* plain format -- dimensions separated by ':', observations
  comma-separated: ``1.0,2.0,?:5.0,6.0,7.0:label``
* ``@timestamps true`` tuple format -- each observation is a
  ``(timestamp, value)`` tuple, timestamps int, float, or ISO date strings:
  ``(0,1.0),(2,2.0):(0,5.0),(1,6.0):label``

Format recap: '#' comment lines, '@tag value' header lines, then '@data'
followed by one line per case -- dimensions separated by ':', with the
label/target as the final ':'-field when ``@classLabel``/``@targetlabel``
is true.

Timestamped cases align every dimension on the case's union timestamp
grid (sorted), with NaN where a dimension has no observation at that
time -- the irregular-sampling layout the NCDE pipeline consumes.  Their
rows gain a leading time column (column 0), rebased to each case's first
observation -- date timestamps as float seconds, numeric timestamps as
offsets (an affine reparametrisation: CDE solutions are invariant to it,
the corpus normalisation rescales the channel anyway, and rebasing keeps
epoch-scale stamps exact under float32; see ``_timestamped_case``).  An
empty dimension (``::``) stays its own all-NaN column.  Plain-format rows
have no time column.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

__all__ = ["load_ts_file"]

_TUPLE_RE = re.compile(r"\(([^)]*)\)")


def _parse_value(tok: str) -> float:
    tok = tok.strip()
    return np.nan if tok in ("?", "") else float(tok)


def _parse_timestamp(tok: str):
    """int/float pass through; anything else must parse as a date (the
    three kinds the format allows)."""
    tok = tok.strip().strip("'\"")
    try:
        return float(tok)
    except ValueError:
        return np.datetime64(tok)


def _parse_tuple_dimension(field: str):
    """One dimension's ``(t, v), (t, v), ...`` string -> (timestamps,
    values) lists.  The value is everything after the tuple's LAST comma
    (date timestamps may themselves contain commas)."""
    ts, vs = [], []
    for body in _TUPLE_RE.findall(field):
        cut = body.rfind(",")
        if cut == -1:
            raise ValueError(f"tuple without a comma in .ts dimension: ({body})")
        ts.append(_parse_timestamp(body[:cut]))
        vs.append(_parse_value(body[cut + 1:]))
    return ts, vs


def _split_colons_outside_parens(line: str) -> List[str]:
    """Split a timestamped data line on the ':' separators at paren-depth
    zero.  Date timestamps contain ':' only INSIDE '(...)' tuples, so
    depth-zero colons are exactly the dimension/label separators — and
    it keeps empty dimensions (legal in the format, '::') as empty fields
    instead of merging their neighbours into one column."""
    parts: List[str] = []
    depth = 0
    cur: List[str] = []
    for ch in line:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == ":" and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _timestamped_case(fields: List[str]) -> np.ndarray:
    """Tuple-format case -> (L, 1 + C) float32: union timestamp grid in
    column 0, per-dimension values aligned on it with NaN holes.

    Column 0 is rebased to the case's first observation for numeric and
    date stamps alike: epoch-scale absolute stamps (~1.7e9 s) otherwise
    collapse to duplicate knots under float32 (resolution ~256 s there),
    producing zero-width intervals in the downstream interpolation.  The
    grid arithmetic runs in float64 and is cast to float32 last."""
    dims = [_parse_tuple_dimension(f) for f in fields]
    all_ts = [t for ts, _ in dims for t in ts]
    if not all_ts:
        return np.zeros((0, 1 + len(dims)), np.float32)
    if isinstance(all_ts[0], np.datetime64):
        origin = min(all_ts)
        to_num = lambda t: float((t - origin) / np.timedelta64(1, "s"))  # noqa: E731
    else:
        to_num = float
    grid = np.array(sorted({to_num(t) for t in all_ts}), np.float64)
    index = {t: i for i, t in enumerate(grid)}
    arr = np.full((len(grid), 1 + len(dims)), np.nan, np.float32)
    arr[:, 0] = (grid - grid[0]).astype(np.float32)
    for c, (ts, vs) in enumerate(dims):
        for t, v in zip(ts, vs):
            arr[index[to_num(t)], 1 + c] = v
    return arr


def load_ts_file(path: str) -> Tuple[List[np.ndarray], List[str]]:
    """Returns (series, labels): series[i] is (L_i, C) float32 with NaN for
    missing values — (L_i, 1 + C) with a leading time column for
    ``@timestamps true`` files; labels[i] is the raw label/target string
    ('' if the file has none).

    For timestamped files column 0 already is the time channel, so a corpus
    builder passes the rows to ``process_all_interpolations`` directly
    instead of prepending an index-time channel with ``add_time`` (the
    plain-format builders' recipe, ``builders.py``)."""
    has_labels = False
    timestamps = False
    in_data = False
    series: List[np.ndarray] = []
    labels: List[str] = []

    with open(path) as f:
        for raw_line in f:
            line = raw_line.strip()
            if not line or line.startswith("#"):
                continue
            if not in_data:
                low = line.lower()
                if low.startswith("@classlabel") or low.startswith("@targetlabel"):
                    has_labels = "true" in low.split()
                if low.startswith("@timestamps"):
                    timestamps = "true" in low.split()
                if low.startswith("@data"):
                    in_data = True
                continue

            if timestamps:
                # ':' inside date timestamps must not split: depth-zero
                # colons are the dimension (and label) separators.
                parts = _split_colons_outside_parens(line)
                if has_labels:
                    if ")" in parts[-1]:
                        raise ValueError(
                            f"missing label field in timestamped case: {line[:60]}"
                        )
                    label = parts[-1].strip()
                    fields = parts[:-1]
                else:
                    label = ""
                    fields = parts
                series.append(_timestamped_case(fields))
                labels.append(label)
                continue

            fields = line.split(":")
            if has_labels:
                label = fields[-1].strip()
                fields = fields[:-1]
            else:
                label = ""
            dims = [
                np.asarray([_parse_value(tok) for tok in field.split(",")],
                           dtype=np.float32)
                for field in fields
            ]
            length = max(len(d) for d in dims)
            arr = np.full((length, len(dims)), np.nan, dtype=np.float32)
            for c, d in enumerate(dims):
                arr[: len(d), c] = d
            series.append(arr)
            labels.append(label)

    return series, labels
