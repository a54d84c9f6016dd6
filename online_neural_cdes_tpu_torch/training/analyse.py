"""Result analysis: ledger -> seed-averaged tables, in numpy.

PyTorch port's counterpart of the JAX package's ``training/analyse.py``,
with its public names and its tables, without pandas (the card's machine
has none): runs flattened from the ledger, the per-dataset evaluation
metric unified, seed averages as mean +- std, and every table kind of the
paper -- the sparsity and gating tables, the medical-sota model ranking
and the interpolation metric, NFE and matching-region tables.

:func:`runs_frame` returns a :class:`RunsFrame` (named columns of equal
length, one row per run) and every table is a :class:`Table`.  The
semantics are ``pandas.pivot_table``'s as the JAX module calls it: rows
with a missing key are left out, row and column labels sorted, a value
list per cell, a missing cell shown as "-".  :meth:`Table.to_latex`
writes what ``DataFrame.to_latex(escape=False)`` writes for the same
table, byte for byte: the column format ("r" for float columns), one
header row per column level with the column level's name, a row of index
names, ``\\multicolumn`` / ``\\multirow`` for repeated outer labels,
``\\cline`` after each outer row group, floats at six decimals and NaN as
"NaN".
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

from online_neural_cdes_tpu_torch.training.ledger import Ledger

__all__ = [
    "runs_frame", "seed_averaged", "metric_table", "nfe_table",
    "sparsity_tables", "medical_sota_table", "interpolation_eps_table",
    "write_analysis_tables", "IRREGULAR_DATASETS", "REGULAR_DATASETS",
    "ROUNDING", "RunsFrame", "Table",
]

# Dataset categories: the paper's tables split columns into irregularly
# sampled medical tasks and regularly sampled benchmark series.
IRREGULAR_DATASETS = ("Mortality", "Sepsis", "LOS")
REGULAR_DATASETS = (
    "BeijingPM10", "BeijingPM2pt5", "SpeechCommands", "CharacterTrajectories",
)

# Per-dataset display precision of the evaluation metric: the Beijing RMSE
# targets print at 1 decimal, the rest at 3.
ROUNDING = {"BeijingPM10": 1, "BeijingPM2pt5": 1}
_DEFAULT_DIGITS = 3


def _isna(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


class RunsFrame:
    """Named columns of equal length, one row per run (the JAX module's
    DataFrame): a column absent from a run holds None there."""

    def __init__(self, columns: Optional[dict] = None):
        self.columns = dict(columns or {})

    @classmethod
    def from_rows(cls, rows: list) -> "RunsFrame":
        """Columns in order of first appearance, with the types a DataFrame
        infers for them (which set how a label prints): a column of
        numbers with a float or a gap among them holds floats, and a column
        of strings with a gap NaN in the gap (pandas' string dtype), NaN
        in both cases where a run lacks the key."""
        names: dict = {}
        for row in rows:
            for key in row:
                names.setdefault(key, None)
        columns = {}
        for name in names:
            col = [row.get(name) for row in rows]
            present = [v for v in col if v is not None]
            numbers = present and all(isinstance(v, (int, float)) and not isinstance(v, bool)
                                      for v in present)
            if numbers and (len(present) < len(col)
                            or any(isinstance(v, float) for v in present)):
                col = [float("nan") if v is None else float(v) for v in col]
            elif present and all(isinstance(v, str) for v in present):
                col = [float("nan") if v is None else v for v in col]
            columns[name] = col
        return cls(columns)

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __contains__(self, name) -> bool:
        return name in self.columns

    @property
    def empty(self) -> bool:
        return len(self) == 0

    def to_rows(self) -> list:
        names = list(self.columns)
        return [dict(zip(names, values)) for values in zip(*self.columns.values())]

    def filter(self, keep) -> "RunsFrame":
        """The rows where ``keep`` (a bool per row) holds."""
        keep = list(keep)
        return RunsFrame({k: [v for v, m in zip(col, keep) if m]
                          for k, col in self.columns.items()})

    def assign(self, **columns) -> "RunsFrame":
        return RunsFrame({**self.columns, **{k: list(v) for k, v in columns.items()}})


class Table:
    """A labelled 2-D table: ``index`` and ``columns`` are lists of label
    tuples (one entry per level), ``cells`` rows of values (strings, or
    floats in the columns flagged ``numeric``)."""

    def __init__(self, index, columns, cells, index_names, column_names, numeric=None):
        self.index = [tuple(i) for i in index]
        self.columns = [tuple(c) for c in columns]
        self.cells = [list(r) for r in cells]
        self.index_names = list(index_names)
        self.column_names = list(column_names)
        self.numeric = list(numeric) if numeric is not None else [False] * len(self.columns)

    @classmethod
    def blank(cls) -> "Table":
        return cls([], [], [], [None], [None])

    @property
    def empty(self) -> bool:
        return not self.index or not self.columns

    def cell(self, row, col):
        return self.cells[self.index.index(tuple(row))][self.columns.index(tuple(col))]

    def select_columns(self, cols) -> "Table":
        js = [self.columns.index(tuple(c)) for c in cols]
        return Table(self.index, [self.columns[j] for j in js],
                     [[r[j] for j in js] for r in self.cells], self.index_names,
                     self.column_names, [self.numeric[j] for j in js])

    def select_rows(self, rows) -> "Table":
        ids = [self.index.index(tuple(r)) for r in rows]
        return Table([self.index[i] for i in ids], self.columns,
                     [self.cells[i] for i in ids], self.index_names, self.column_names,
                     self.numeric)

    def relabel_index(self, fn) -> "Table":
        """Every index label through ``fn`` (level by level)."""
        return Table([tuple(fn(v) for v in ix) for ix in self.index], self.columns,
                     self.cells, self.index_names, self.column_names, self.numeric)

    # -- rendering ---------------------------------------------------------

    @staticmethod
    def _fmt(v) -> str:
        if _isna(v):
            return "NaN"
        if isinstance(v, (float, np.floating)):
            return f"{float(v):.6f}"
        return str(v)

    def to_latex(self) -> str:
        """What ``pandas.DataFrame.to_latex(escape=False)`` writes."""
        nl, ncl = len(self.index_names), len(self.column_names)
        width = nl + len(self.columns)
        fmt = "l" * nl + "".join("r" if n else "l" for n in self.numeric)
        lines = [f"\\begin{{tabular}}{{{fmt}}}", "\\toprule"]
        for lev in range(ncl if self.columns else 0):
            row = [""] * (nl - 1) + [self.column_names[lev] or ""]
            j = 0
            while j < len(self.columns):
                span = 1
                if lev < ncl - 1:
                    while (j + span < len(self.columns)
                           and self.columns[j + span][:lev + 1] == self.columns[j][:lev + 1]):
                        span += 1
                label = self._fmt(self.columns[j][lev])
                row.append(label if span == 1 else f"\\multicolumn{{{span}}}{{r}}{{{label}}}")
                j += span
            lines.append(" & ".join(row) + " \\\\")
        if any(name is not None for name in self.index_names):
            lines.append(" & ".join([name or "" for name in self.index_names]
                                    + [""] * len(self.columns)) + " \\\\")
        lines.append("\\midrule")
        n = len(self.index)
        for i, ix in enumerate(self.index):
            row = []
            for lev in range(nl):
                label = self._fmt(ix[lev])
                if lev == nl - 1:
                    row.append(label)
                    continue
                if i > 0 and self.index[i - 1][:lev + 1] == ix[:lev + 1]:
                    row.append("")
                    continue
                span = 1
                while i + span < n and self.index[i + span][:lev + 1] == ix[:lev + 1]:
                    span += 1
                row.append(label if span == 1 else f"\\multirow[t]{{{span}}}{{*}}{{{label}}}")
            row += [self._fmt(v) for v in self.cells[i]]
            lines.append(" & ".join(row) + " \\\\")
            for lev in range(nl - 1):
                if i == n - 1 or self.index[i + 1][:lev + 1] != ix[:lev + 1]:
                    lines.append(f"\\cline{{{lev + 1}-{width}}}")
        lines += ["\\bottomrule", "\\end{tabular}", ""]
        return "\n".join(lines)

    def __str__(self) -> str:
        """A plain-text rendering for the console."""
        if self.empty:
            return "(empty table)"
        heads = [" / ".join(str(c) for c in col if c is not None) for col in self.columns]
        labels = [" / ".join(self._fmt(v) for v in ix) for ix in self.index]
        corner = " / ".join(n for n in self.index_names if n) or ""
        body = [[self._fmt(v) for v in row] for row in self.cells]
        widths = [max([len(corner)] + [len(l) for l in labels])] + [
            max([len(h)] + [len(r[j]) for r in body]) for j, h in enumerate(heads)]
        out = ["  ".join(s.rjust(w) for s, w in zip([corner] + heads, widths))]
        out += ["  ".join(s.rjust(w) for s, w in zip([l] + r, widths))
                for l, r in zip(labels, body)]
        return "\n".join(out)


def runs_frame(ledger: Ledger, run_name: Optional[str] = None) -> RunsFrame:
    """Flatten completed ledger entries into a :class:`RunsFrame`, one row
    per run."""
    rows = []
    for entry in ledger.query(
        lambda e: e.get("status") == "completed"
        and (run_name is None or e.get("run_name") == run_name)
    ):
        cfg = entry["config"]
        res = entry.get("results", {})
        model_cfg = cfg.get("model", {})
        row = {
            "dataset_name": cfg.get("dataset_name"),
            "model": model_cfg.get("model_string"),
            "interpolation": cfg.get("dataset", {}).get("interpolation"),
            "adjoint": model_cfg.get("adjoint"),
            "vector_field": model_cfg.get("vector_field", "original"),
            # Absent means the default matmul contraction.
            "vector_field_type": model_cfg.get("vector_field_type", "matmul"),
            "sparsity": model_cfg.get("sparsity"),
            "interpolation_eps": model_cfg.get("interpolation_eps"),
            "seed": cfg.get("seed"),
            "eval_metric": cfg.get("dataset", {}).get("evaluation_metric"),
        }
        for k, v in res.items():
            if isinstance(v, (int, float)) or v is None:
                row[k] = v
        # The headline number: the dataset's own eval metric on test.
        row["test_metric"] = res.get(f"test.{row['eval_metric']}")
        rows.append(row)
    return RunsFrame.from_rows(rows)


def _mean_std(values, digits: int = _DEFAULT_DIGITS) -> str:
    """mean $\\pm$ std (ddof 0) of the values that are not missing, or "-";
    the sums in pandas' order (``nanops``: the mean as sum / n, the
    variance as sum((mean - v)^2) / n)."""
    vals = np.asarray([float(v) for v in values if not _isna(v)], np.float64)
    if len(vals) == 0:
        return "-"
    mean = vals.sum(dtype=np.float64) / len(vals)
    std = np.sqrt(((mean - vals) ** 2).sum(dtype=np.float64) / len(vals))
    return f"{mean:.{digits}f} $\\pm$ {std:.{digits}f}"


def _groups(frame: RunsFrame, keys, value) -> dict:
    """{key tuple: [value, ...]} over the rows whose keys are all present
    (groupby's dropna), keys sorted."""
    cols = [frame.columns[k] for k in keys]
    vals = frame.columns[value]
    out: dict = {}
    for i in range(len(frame)):
        key = tuple(c[i] for c in cols)
        if any(_isna(x) for x in key):
            continue
        out.setdefault(key, []).append(vals[i])
    return dict(sorted(out.items()))


def _pivot(frame: RunsFrame, value, index, columns, agg):
    """``pandas.pivot_table(frame, values=value, index=index,
    columns=columns, aggfunc=agg)`` with its dropna: {(row key, col key):
    cell}, the sorted row keys and the sorted column keys (``(value,)``
    alone when ``columns`` is empty).  ``agg`` maps a group's value list
    to its cell; a cell that is None (NaN) drops its group."""
    groups = _groups(frame, list(index) + list(columns), value)
    nl = len(index)
    cells, rows, cols = {}, {}, {}
    for key, vals in groups.items():
        cell = agg(vals)
        if _isna(cell):
            continue
        r, c = key[:nl], (key[nl:] if columns else (value,))
        cells[(r, c)] = cell
        rows.setdefault(r, None)
        cols.setdefault(c, None)
    return cells, sorted(rows), sorted(cols)


def seed_averaged(frame: RunsFrame, value: str = "test_metric",
                  index=("model",), columns=("dataset_name",)) -> Table:
    """Seed-averaged mean +- std pivot.  The eval metric formats with the
    per-dataset precision (:data:`ROUNDING`) when the dataset is a row or
    column key; other values at 3 decimals."""
    if frame.empty or value not in frame:
        return Table.blank()
    idx_names, col_names = list(index), list(columns)

    def digits(i, j):
        if value != "test_metric":
            return _DEFAULT_DIGITS
        if "dataset_name" in col_names:
            ds = j[col_names.index("dataset_name")]
        elif "dataset_name" in idx_names:
            ds = i[idx_names.index("dataset_name")]
        else:
            return _DEFAULT_DIGITS
        return ROUNDING.get(ds, _DEFAULT_DIGITS)

    cells, rows, cols = _pivot(frame, value, idx_names, col_names, list)
    body = [[_mean_std(cells[(i, j)], digits(i, j)) if (i, j) in cells else "-"
             for j in cols] for i in rows]
    return Table(rows, cols, body, idx_names, col_names or [None])


def _as_frame(ledger_or_frame, run_name) -> RunsFrame:
    """Table builders take a Ledger (parsed on demand) or a built
    :class:`RunsFrame` (``write_analysis_tables`` parses the ledger once)."""
    if isinstance(ledger_or_frame, RunsFrame):
        return ledger_or_frame
    return runs_frame(ledger_or_frame, run_name)


def metric_table(ledger: Ledger, run_name: Optional[str] = None,
                 index=("model",), columns=("dataset_name",), latex: bool = False):
    table = seed_averaged(_as_frame(ledger, run_name), "test_metric", index, columns)
    return table.to_latex() if latex else table


def nfe_table(ledger: Ledger, run_name: Optional[str] = None, latex: bool = False):
    """NFE-per-epoch comparison across interpolation schemes."""
    table = seed_averaged(_as_frame(ledger, run_name), "nfe_per_epoch",
                          index=("interpolation",), columns=("dataset_name",))
    return table.to_latex() if latex else table


# --- Sparsity / gating tables ----------------------------------------------

# Sparsity levels the paper presents; the sweep trains more.
PRESENTED_SPARSITIES = (0.5, 0.7, 0.9, 0.95, 0.99)

# LaTeX names of the gating table's rows.
_GATING_RENAMES = {
    "matmul": r"$f(z) \dby X$",
    "evaluate": r"$f(z, x) \dby t$",
    "derivative": r"$f(z, \frac{dx}{dt})dt$",
    "original": "Original",
    "minimal": "Minimal",
    "gru": "GRU",
}


def _split_datasets(table: Table):
    """(irregular, regular) views of a dataset-columned table: the
    irregular datasets in their order, then the regular ones and any other
    dataset (a synthetic one) in the table's order."""
    present = [c[0] for c in table.columns]
    irregular = [d for d in IRREGULAR_DATASETS if d in present]
    regular = [d for d in REGULAR_DATASETS if d in present]
    other = [c for c in present if c not in irregular + regular]
    return (table.select_columns([(d,) for d in irregular]),
            table.select_columns([(d,) for d in regular + other]))


def _sparsity_table(mm: RunsFrame) -> Table:
    """Test metric and parameter fraction by (vector field, sparsity) and
    dataset, the parameter counts normalised by the dense original's."""
    mm = mm.assign(sparsity=[-1.0 if _isna(s) else s for s in mm.columns["sparsity"]])
    metric = seed_averaged(mm, "test_metric", index=("vector_field", "sparsity"),
                           columns=("dataset_name",))
    if metric.empty:
        return Table.blank()

    cells, rows, cols = _pivot(mm, "num_params", ("vector_field", "sparsity"),
                               ("dataset_name",), _groupby_mean)
    # A dataset column with no count at all drops (pivot_table's dropna).
    params = {(r, c): cells.get((r, c)) for r in rows for c in cols}
    originals = [r for r in rows if r[0] == "original"]
    if originals:
        base = originals[0]
        params = {(r, c): (None if v is None or params[(base, c)] is None
                           else np.round(np.float64(v) / params[(base, c)], 2))
                  for (r, c), v in params.items()}
    keep = [ix for ix in metric.index if ix[0] == "original"] + [
        ix for ix in metric.index if ix[0] != "original" and ix[1] in PRESENTED_SPARSITIES]
    columns = sorted([(c[0], "Test metric") for c in metric.columns]
                     + [(c[0], "Parameter fraction") for c in cols])
    body = []
    for ix in keep:
        row = []
        for ds, kind in columns:
            if kind == "Test metric":
                row.append(metric.cell(ix, (ds,)))
            else:
                v = params.get((ix, (ds,)))
                row.append(float("nan") if v is None else float(v))
        body.append(row)
    index = [(vf, "-" if sp == -1.0 else sp) for vf, sp in keep]
    return Table(index, columns, body, [r"\textbf{Vector field}", r"\textbf{Sparsity}"],
                 ["dataset_name", None], [kind == "Parameter fraction" for _, kind in columns])


def _groupby_mean(vals):
    """A group's mean as ``groupby.mean`` takes it: over the present
    values, NaN (None) when there are none."""
    present = np.asarray([float(v) for v in vals if not _isna(v)], np.float64)
    return None if len(present) == 0 else present.sum() / len(present)


def sparsity_tables(ledger: Ledger, run_name: Optional[str] = None) -> dict:
    """The paper's sparsity and gating tables, keyed like the saved files:
    ``sparsity_irregular`` / ``sparsity_regular`` -- test metric and
    parameter fraction of the original, sparse and low-rank fields under
    the matmul contraction, counts normalised by the dense original's;
    ``gating_irregular`` / ``gating_regular`` -- test metric by
    (vector_field_type, gating) over the non-sparse runs."""
    frame = _as_frame(ledger, run_name)
    out = {k: Table.blank() for k in (
        "sparsity_irregular", "sparsity_regular", "gating_irregular", "gating_regular")}
    if frame.empty:
        return out

    vf, vft = frame.columns["vector_field"], frame.columns["vector_field_type"]
    mm = frame.filter(v in ("original", "sparse", "low-rank") and t == "matmul"
                      for v, t in zip(vf, vft))
    # A ledger without parameter counts has no sparsity table.
    if (not mm.empty and "num_params" in mm
            and any(not _isna(v) for v in mm.columns["num_params"])):
        sparsity = _sparsity_table(mm)
        if not sparsity.empty:
            out["sparsity_irregular"] = sparsity.select_columns(
                [c for c in sparsity.columns if c[0] in IRREGULAR_DATASETS])
            out["sparsity_regular"] = sparsity.select_columns(
                [c for c in sparsity.columns if c[0] not in IRREGULAR_DATASETS])

    gate = frame.filter(_isna(s) for s in frame.columns["sparsity"])
    if not gate.empty:
        gating = seed_averaged(gate, "test_metric",
                               index=("vector_field_type", "vector_field"),
                               columns=("dataset_name",))
        if not gating.empty:
            gating = gating.select_rows(sorted(gating.index, reverse=True))
            gating = gating.relabel_index(lambda v: _GATING_RENAMES.get(v, v))
            gating.index_names = [r"\textbf{Vector field type}", r"\textbf{Gating}"]
            out["gating_irregular"], out["gating_regular"] = _split_datasets(gating)
    return out


# Medical-sota rows and their display names.  NCDE rows key on
# (model_string, interpolation); the rest on model_string.
_SOTA_ORDER = (
    ("gru", "GRU"),
    ("gru-dt", "GRU-dt"),
    ("gru-intensity", "GRU-intensity"),
    ("gru-dt-intensity", "GRU-dt-intensity"),
    ("gru-d", "GRU-D"),
    ("odernn", "ODE-RNN"),
    ("ncde-rectilinear", "NCDE (rectilinear)"),
    ("ncde-rectilinear-intensity", "NCDE (rectilinear-intensity)"),
)


def interpolation_eps_table(ledger: Ledger, run_name: Optional[str] = None,
                            latex: bool = False):
    """Matching-region sensitivity: test metric by (interpolation scheme,
    interpolation_eps) per dataset, over the runs that set a matching
    region."""
    frame = _as_frame(ledger, run_name)
    if (frame.empty or "interpolation_eps" not in frame
            or all(_isna(v) for v in frame.columns["interpolation_eps"])):
        return Table.blank()
    sub = frame.filter(not _isna(v) for v in frame.columns["interpolation_eps"])
    table = seed_averaged(sub, "test_metric", index=("interpolation", "interpolation_eps"),
                          columns=("dataset_name",))
    return table.to_latex() if latex else table


def medical_sota_table(ledger: Ledger, run_name: Optional[str] = None,
                       latex: bool = False):
    """Medical-SOTA model ranking: one row per baseline model (NCDE rows
    suffixed by interpolation scheme), one column per dataset, mean +- std
    of the test metric."""
    frame = _as_frame(ledger, run_name)
    if frame.empty:
        return Table.blank()
    key = [f"{m}-{i}" if isinstance(i, str) and str(m).startswith("ncde") else str(m)
           for m, i in zip(frame.columns["model"], frame.columns["interpolation"])]
    table = seed_averaged(frame.assign(_sota_key=key), "test_metric", index=("_sota_key",),
                          columns=("dataset_name",))
    if table.empty:
        return table
    # Known models in the paper's order, any other after them.
    names = dict(_SOTA_ORDER)
    present = [ix[0] for ix in table.index]
    known = [k for k, _ in _SOTA_ORDER if k in present]
    extra = [k for k in present if k not in names]
    table = table.select_rows([(k,) for k in known + extra])
    table = table.relabel_index(lambda v: names.get(v, v))
    table.index_names = [None]
    return table.to_latex() if latex else table


def write_analysis_tables(ledger: Ledger, out_dir: str,
                          run_name: Optional[str] = None) -> list:
    """Every table kind as .tex under ``out_dir`` (the JAX module's layout);
    returns the written paths.  Empty tables are skipped."""
    written = []

    def _save(table: Table, *parts):
        if table is None or table.empty:
            return
        path = os.path.join(out_dir, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(table.to_latex())
        written.append(path)

    frame = _as_frame(ledger, run_name)
    for name, table in sparsity_tables(frame, run_name).items():
        _save(table, "sparsity", f"{name}.tex")
    _save(medical_sota_table(frame, run_name), "medical-sota.tex")
    eps = interpolation_eps_table(frame, run_name)
    if not eps.empty:
        irr_eps, reg_eps = _split_datasets(eps)
        _save(reg_eps, "interpolation", "eps_frame_regular.tex")
        _save(irr_eps, "interpolation", "eps_frame_irregular.tex")
    metric_nfe = seed_averaged(frame, "test_metric", index=("dataset_name", "interpolation"),
                               columns=())
    if not metric_nfe.empty:
        columns, cells = [("Metric",)], [list(r) for r in metric_nfe.cells]
        if "nfe_per_epoch" in frame:
            # NFE/epoch in thousands, one decimal, mean $\pm$ std.
            kilo = frame.assign(nfe_per_epoch=[None if _isna(v) else float(v) / 1e3
                                               for v in frame.columns["nfe_per_epoch"]])
            nfe, rows, _ = _pivot(kilo, "nfe_per_epoch", ("dataset_name", "interpolation"),
                                  (), lambda v: _mean_std(v, 1))
            if rows:
                columns.append((r"NFEs per epoch $\times 10^3$",))
                for r, ix in zip(cells, metric_nfe.index):
                    r.append(nfe.get((ix, ("nfe_per_epoch",)), float("nan")))
        combined = Table(metric_nfe.index, columns, cells, metric_nfe.index_names, [None])
        irr = [ix for ix in combined.index if ix[0] in IRREGULAR_DATASETS]
        reg = [ix for ix in combined.index if ix[0] not in IRREGULAR_DATASETS]
        _save(combined.select_rows(reg), "interpolation", "metric_nfe_regular.tex")
        _save(combined.select_rows(irr), "interpolation", "metric_nfe_irregular.tex")
    return written
