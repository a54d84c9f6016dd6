"""MIMIC-IV raw construction: BigQuery CSV exports -> reduced_format.npz.

Counterpart of the JAX package's ``data/mimic_raw.py`` (built on pandas)
in numpy and the standard library's ``csv``, with its stages, their
arguments and the npz it writes.  A frame here is a ``dict`` of column
name -> 1-D numpy array, in column order; the pandas behaviour each stage
relies on is spelled out where it is rebuilt:

- ``read_csv``'s type inference (:func:`_infer_column`): an empty field
  (or another of pandas' default NA strings) is missing; a column of
  integers is int64, and float64 when a field is missing; a column of
  numbers is float64, each parsed as pandas' default converter parses it
  (:func:`_parse_float`, which is not always correctly rounded); anything
  else keeps its strings, missing as NaN;
- ``to_datetime`` on the export's timestamp strings (numpy
  ``datetime64``, at microseconds unless a string carries more digits,
  then at nanoseconds, as pandas picks), and ``Timedelta.total_seconds``
  as the delta's integer count over the unit's count a second;
- ``factorize``: codes in order of first appearance, missing -1;
- ``groupby``: keys sorted, rows in their frame order within a key;
  ``first`` / ``last`` skip missing values, ``mean`` skips them and sums
  with pandas' Kahan compensation, in row order.

The BigQuery step itself needs credentialed network access and runs
elsewhere; the extraction SQL ships beside this module as
``data/mimic_query.sql``, and this module reads its CSV exports from
``data/raw/mimic-iv/*.csv``.
"""

from __future__ import annotations

import csv
import logging
import os
import re
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["combine_csvs", "build_times", "encode_categoricals",
           "remove_continuously_monitored", "merge_nearby_vitals", "convert_to_numpy",
           "build_reduced_format", "read_csv", "STATIC_FEATURES", "TEMPORAL_FEATURES",
           "VENT_CODES"]

Frame = Dict[str, np.ndarray]

# Final model features (the reference build's FEATURES_TO_USE).
STATIC_FEATURES = ["gender", "ethnicity", "admission_age", "height", "weight",
                   "mortality", "los"]
TEMPORAL_VITALS = ["dbp", "dbp_ni", "heart_rate", "mbp", "mbp_ni", "o2_flow",
                   "resp_rate", "sbp", "spo2", "temperature"]
TEMPORAL_LABS = ["alp", "ast", "baseexcess", "bicarbonate_bg", "bilirubin_direct",
                 "bilirubin_total", "bun", "calcium", "chloride", "creatinine",
                 "fibrinogen", "fio2", "glucose", "glucose_bg", "hematocrit",
                 "hemoglobin", "lactate", "pco2", "ph", "platelet", "po2",
                 "potassium_bg", "ptt", "so2", "sodium", "troponin_i", "wbc"]
TEMPORAL_FEATURES = ["time"] + TEMPORAL_VITALS + TEMPORAL_LABS + ["sepsis", "ventilation"]

# Ventilation status -> ordinal code; a missing status is 0.
VENT_CODES = {"Oxygen": 1, "InvasiveVent": 2, "Trach": 3, "HighFlow": 4,
              "NonInvasiveVent": 5}

# pandas' default NA strings of read_csv.
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT_RE = re.compile(r"[+-]?\d+\Z")
_FLOAT_RE = re.compile(
    r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\Z", re.IGNORECASE)
_NUMBER_RE = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*\Z")
_POWERS = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------


def _isna(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "M":
        return np.isnat(col)
    if col.dtype.kind == "O":
        return np.fromiter((v is None or (isinstance(v, float) and v != v) for v in col),
                           bool, len(col))
    return np.zeros(len(col), bool)


def _take(frame: Frame, rows) -> Frame:
    return {k: v[rows] for k, v in frame.items()}


def _parse_float(text: str) -> float:
    """A decimal string as pandas' default float converter (the C parser's
    ``precise_xstrtod``) reads it: the first 17 digits, leading zeros
    included, accumulated as ``number * 10 + digit`` in double precision
    (exact up to 16 digits), then one product with (or quotient by) the
    power of ten of the exponent."""
    m = _NUMBER_RE.match(text)
    if m is None or not (m[2] or m[3]):
        return float(text)     # inf / infinity
    sign, whole, frac, exp = m[1], m[2], m[3] or "", m[4]
    digits = (whole + frac)[:_MAX_DIGITS]
    exponent = max(len(whole) - _MAX_DIGITS, 0) - max(len(digits) - len(whole), 0)
    if len(digits) < _MAX_DIGITS:
        number = float(int(digits))
    else:
        number = float(int(digits[:-1])) * 10.0 + int(digits[-1])
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return float(text)
    if exponent > 0:
        return number * _POWERS[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POWERS[-308 - exponent] / _POWERS[308]
    return number / _POWERS[-exponent]


def _infer_column(fields) -> np.ndarray:
    """One column's strings -> the array ``pandas.read_csv`` infers."""
    missing = [f in NA_STRINGS for f in fields]
    present = [f for f, m in zip(fields, missing) if not m]
    if not present:
        return np.full(len(fields), np.nan)
    if all(_INT_RE.match(f) for f in present):
        if not any(missing):
            return np.asarray([int(f) for f in fields], np.int64)
        return np.asarray([np.nan if m else float(int(f)) for f, m in zip(fields, missing)])
    if all(_FLOAT_RE.match(f) for f in present):
        return np.asarray([np.nan if m else _parse_float(f) for f, m in zip(fields, missing)])
    if all(f in _BOOLS for f in present) and not any(missing):
        return np.asarray([_BOOLS[f] for f in fields], bool)
    out = np.empty(len(fields), object)
    out[:] = [np.nan if m else f for f, m in zip(fields, missing)]
    return out


def read_csv(path: str) -> Frame:
    """A CSV file with a header row -> a frame, each column typed as
    ``pandas.read_csv`` types it."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        raise ValueError(f"{path}: no header row")
    header, body = rows[0], rows[1:]
    for i, row in enumerate(body):
        if len(row) != len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(row)} fields, the header "
                             f"{len(header)}")
    return {name: _infer_column([row[j] for row in body]) for j, name in enumerate(header)}


def _concat(columns) -> np.ndarray:
    """``pd.concat``'s column: one numeric dtype if every part is numeric
    (int with float is float), else objects."""
    kinds = {c.dtype.kind for c in columns}
    if kinds <= {"i", "u", "f", "b"} and len(kinds) == 1:
        return np.concatenate(columns)
    if kinds <= {"i", "u", "f"}:
        return np.concatenate([c.astype(np.float64) for c in columns])
    out = np.empty(sum(len(c) for c in columns), object)
    out[:] = [v for c in columns for v in c.tolist()]
    return out


def _sorted_groups(keys: np.ndarray):
    """(order, starts, sizes): the rows sorted by key, stably, and each
    key's run in that order -- pandas' groupby with sorted keys."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    starts = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]]) \
        if len(keys) else np.zeros(0, np.int64)
    sizes = np.diff(np.r_[starts, len(keys)])
    return order, starts, sizes


def _group_pick(col: np.ndarray, starts, sizes, last: bool) -> np.ndarray:
    """Each group's first (or last) non-missing value, missing where the
    group has none: ``groupby.first`` / ``groupby.last``."""
    valid = ~_isna(col)
    pos = np.arange(len(col))
    if last:
        idx = np.maximum.reduceat(np.where(valid, pos, -1), starts) if len(col) else pos
    else:
        idx = np.minimum.reduceat(np.where(valid, pos, len(col)), starts) if len(col) else pos
    found = (idx >= 0) & (idx < len(col))
    if col.dtype.kind in "iub" and found.all():
        return col[idx]
    out = col[np.clip(idx, 0, max(len(col) - 1, 0))].astype(
        np.float64 if col.dtype.kind in "iubf" else col.dtype)
    if col.dtype.kind == "M":
        out[~found] = np.datetime64("NaT")
    else:
        out[~found] = np.nan
    return out


def _group_mean(col: np.ndarray, starts, sizes) -> np.ndarray:
    """``groupby.mean``: the non-missing values of each group summed in
    row order with Kahan compensation, over their count."""
    values = col.astype(np.float64)
    n_groups = len(starts)
    sumx = np.zeros(n_groups)
    comp = np.zeros(n_groups)
    nobs = np.zeros(n_groups)
    for r in range(int(sizes.max()) if n_groups else 0):
        sel = np.flatnonzero(sizes > r)
        val = values[starts[sel] + r]
        ok = ~np.isnan(val)
        g, v = sel[ok], val[ok]
        nobs[g] += 1
        y = v - comp[g]
        t = sumx[g] + y
        c = (t - sumx[g]) - y
        # An infinite value makes the compensation NaN; pandas resets it.
        c[np.isnan(c)] = 0.0
        comp[g] = c
        sumx[g] = t
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(nobs == 0, np.nan, sumx / nobs)


def _to_datetime(col: np.ndarray) -> np.ndarray:
    """Timestamp strings -> datetime64, at microseconds unless a string has
    more than six fractional digits (then nanoseconds), missing as NaT."""
    if col.dtype.kind == "M":
        return col
    missing = _isna(col)
    if missing.all():
        return np.full(len(col), np.datetime64("NaT"), "datetime64[ns]")
    strings = [str(v) for v, m in zip(col, missing) if not m]
    fine = any(len(s.rsplit(".", 1)[1]) > 6 for s in strings if "." in s[10:])
    out = np.full(len(col), np.datetime64("NaT"), "datetime64[ns]" if fine else "datetime64[us]")
    out[~missing] = np.asarray(strings, out.dtype)
    return out


def _total_seconds(delta: np.ndarray) -> np.ndarray:
    """``Timedelta.total_seconds``: the delta's count in its unit over the
    unit's count a second; NaT -> NaN."""
    unit = np.datetime_data(delta.dtype)[0]
    per_second = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[unit]
    out = delta.astype(np.int64) / per_second
    out[np.isnat(delta)] = np.nan
    return out


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def combine_csvs(raw_dir: str) -> Frame:
    """Every ``*.csv`` under ``raw_dir``, in name order, as one frame."""
    frames = [read_csv(os.path.join(raw_dir, f))
              for f in sorted(os.listdir(raw_dir)) if f.endswith(".csv")]
    if not frames:
        raise FileNotFoundError(
            f"No BigQuery CSV exports under {raw_dir} (zero-egress image: "
            "run get_data/mimic-iv/query.sql externally first)."
        )
    names = list(dict.fromkeys(name for fr in frames for name in fr))
    return {name: _concat([fr[name] if name in fr else np.full(len(next(iter(fr.values()))),
                                                                np.nan)
                           for fr in frames])
            for name in names}


def build_times(frame: Frame) -> Frame:
    """Measurement time, length of stay and the sepsis time from ICU
    admission: ``time`` and ``sepsis`` in hours, ``los`` in days."""
    frame = dict(frame)
    for col in ("charttime", "icu_outtime", "icu_intime", "t_sofa"):
        frame[col] = _to_datetime(frame[col])
    frame["time"] = _total_seconds(frame["charttime"] - frame["icu_intime"]) / 3600.0
    frame["los"] = _total_seconds(frame["icu_outtime"] - frame["icu_intime"]) / 86400.0
    frame["sepsis"] = _total_seconds(frame["t_sofa"] - frame["icu_intime"]) / 3600.0
    return frame


def _factorize(col: np.ndarray) -> np.ndarray:
    codes: dict = {}
    missing = _isna(col)
    out = np.empty(len(col), np.int64)
    for i, (v, m) in enumerate(zip(col.tolist(), missing)):
        out[i] = -1 if m else codes.setdefault(v, len(codes))
    return out


def encode_categoricals(frame: Frame, columns=("gender", "ethnicity")) -> Frame:
    """Each column's values as their codes in order of first appearance
    (missing -1), as floats."""
    frame = dict(frame)
    for col in columns:
        frame[col] = _factorize(frame[col]).astype(float)
    return frame


def remove_continuously_monitored(frame: Frame, consecutive_time=2.0,
                                  num_consecutive=5) -> Frame:
    """Drop patients with ``num_consecutive`` consecutive gaps between
    their unique measurement times all under ``consecutive_time``
    minutes."""

    def is_continuous(times: np.ndarray) -> bool:
        times = np.unique(times)
        diffs = np.diff(times) * 60.0
        if len(diffs) <= num_consecutive:
            return False
        close = diffs < consecutive_time
        run = np.convolve(close.astype(int), np.ones(num_consecutive, int), "valid")
        return bool((run == num_consecutive).any())

    ids, times = frame["id"], frame["time"]
    order, starts, sizes = _sorted_groups(ids)
    drop_ids = [ids[order[s]] for s, n in zip(starts, sizes)
                if is_continuous(times[order[s:s + n]])]
    logger.info("Removed %d continuously monitored patients", len(drop_ids))
    return _take(frame, ~np.isin(ids, drop_ids))


def merge_nearby_vitals(frame: Frame, window_minutes=2.0) -> Frame:
    """Merge each measurement within ``window_minutes`` of the previous
    one of its patient into it: the features' means, the last time,
    ventilation and sepsis (``groupby.agg`` over the runs)."""
    frame = _take(frame, np.lexsort((frame["time"], frame["id"])))
    ids, times = frame["id"], frame["time"]
    same_id = np.r_[False, ids[1:] == ids[:-1]]
    with np.errstate(invalid="ignore"):
        close = np.r_[False, (times[1:] - times[:-1]) * 60.0 < window_minutes]
    starts = np.flatnonzero(~(same_id & close))
    sizes = np.diff(np.r_[starts, len(ids)])
    merged = {}
    for col, values in frame.items():
        if col == "id":
            merged[col] = values[starts]
        elif col in ("time", "ventilation", "sepsis"):
            merged[col] = _group_pick(values, starts, sizes, last=True)
        else:
            merged[col] = _group_mean(values, starts, sizes)
    return merged


def _columns(frame: Frame, names) -> np.ndarray:
    """(rows, len(names)) float32 in Fortran order, as ``DataFrame.to_numpy``
    gives one float block: the npz keeps the order, and numpy's reductions
    over the corpus (``data.common.normalise``) sum in another order, and
    round otherwise, over a C-ordered copy."""
    return np.stack([frame[c] for c in names], 0).T.astype(np.float32)


def convert_to_numpy(static_frame: Frame, temporal_frame: Frame, out_path: str,
                     min_points=4, min_hours=4.0) -> str:
    """Per-patient arrays and the four label structures ->
    ``reduced_format.npz``.  ``static_frame`` holds one row per id (its
    ``id`` column sorted, as ``groupby("id").first()``'s index)."""
    temporal_frame = _take(temporal_frame,
                           np.lexsort((temporal_frame["time"], temporal_frame["id"])))
    static_cols = [c for c in static_frame if c not in ("id", "los", "mortality")]
    static_row = {k: i for i, k in enumerate(static_frame["id"].tolist())}
    static_data, temporal_data = [], []
    los, mort, vent, sepsis = [], [], [], []
    feature_cols = [c for c in temporal_frame if c not in ("id", "sepsis", "ventilation")]
    _, starts, sizes = _sorted_groups(temporal_frame["id"])
    for s, n in zip(starts, sizes):
        g = {k: v[s:s + n] for k, v in temporal_frame.items()}
        if n < min_points or np.nanmax(g["time"]) < min_hours:
            continue
        row = static_row[g["id"][0].item()]
        static_data.append(np.asarray([static_frame[c][row] for c in static_cols],
                                      np.float64).astype(np.float32))
        los.append(float(static_frame["los"][row]))
        mort.append(float(static_frame["mortality"][row]))
        temporal_data.append(_columns(g, feature_cols))
        vent.append(_columns(g, ["time", "ventilation"]))
        sep = _columns(g, ["time", "sepsis"])
        t_sepsis = sep[0, 1]
        sep[:, 1] = 0.0
        if np.isfinite(t_sepsis):
            sep[int(np.argmin(np.abs(sep[:, 0] - t_sepsis))), 1] = 1.0
        sepsis.append(sep)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(
        out_path,
        static_data=np.stack(static_data),
        temporal_data=np.array(temporal_data, dtype=object),
        los_data=np.asarray(los, np.float32),
        mortality_data=np.asarray(mort, np.float32),
        ventilation_data=np.array(vent, dtype=object),
        sepsis_data=np.array(sepsis, dtype=object),
        static_columns=static_cols,
        temporal_columns=feature_cols,
    )
    return out_path


def _static_frame(frame: Frame) -> Frame:
    """``frame[["id"] + STATIC_FEATURES].groupby("id").first()`` with the
    index as the ``id`` column."""
    order, starts, sizes = _sorted_groups(frame["id"])
    out = {"id": frame["id"][order][starts]}
    for col in STATIC_FEATURES:
        out[col] = _group_pick(frame[col][order], starts, sizes, last=False)
    return out


def build_reduced_format(raw_dir: str = "data/raw/mimic-iv",
                         out_path: Optional[str] = None) -> str:
    """The whole pipeline: CSVs -> cleaned frames -> reduced_format.npz."""
    out_path = out_path or os.path.join(raw_dir, "reduced_format.npz")
    frame = combine_csvs(raw_dir)
    renames = {"stay_id": "id", "hospital_expire_flag": "mortality"}
    frame = {renames.get(k, k): v for k, v in frame.items()}
    frame = build_times(frame)
    with np.errstate(invalid="ignore"):
        frame = _take(frame, frame["time"] > 0)
    frame["ventilation"] = np.asarray(
        [VENT_CODES.get(v, 0) if isinstance(v, str) else 0
         for v in frame["ventilation_status"].tolist()], np.int64).astype(float)
    frame = encode_categoricals(frame)
    frame = _take(frame, np.argsort(frame["time"], kind="stable"))
    frame = remove_continuously_monitored(frame)

    static_frame = _static_frame(frame)
    temporal_frame = merge_nearby_vitals({c: frame[c] for c in ["id"] + TEMPORAL_FEATURES})
    return convert_to_numpy(static_frame, temporal_frame, out_path)
