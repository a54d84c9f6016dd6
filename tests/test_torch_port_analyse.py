"""The PyTorch port's analysis in numpy against the JAX package's in pandas
(present on this machine only): every ``.tex`` table that
``write_analysis_tables`` writes, byte for byte, and ``metric_table`` /
``nfe_table``'s LaTeX, on fixture ledgers with several seeds, NaN and
missing metrics, missing keys, runs with no parameter count, integer
and float sparsities, unknown models and a run that never completed; the
runs frame row by row; ``seed_averaged`` on other pivots; and the CLI's
``--analyse --tables-out``."""

import json
import math
import os

import numpy as np
import pytest

from online_neural_cdes_tpu.training import analyse as jax_analyse
from online_neural_cdes_tpu.training.ledger import Ledger as JaxLedger
from online_neural_cdes_tpu_torch import run as port_run
from online_neural_cdes_tpu_torch.training import analyse
from online_neural_cdes_tpu_torch.training.ledger import Ledger

DATASETS = {"Sepsis": "auc", "Mortality": "auc", "LOS": "rmse", "BeijingPM10": "rmse",
            "BeijingPM2pt5": "rmse", "SpeechCommands": "acc", "ToyBM": "auc"}
RUNS = ("medical-sota", "sparsity", "interpolation", None)


def _fixture(path, seed):
    """A ledger of the three suites' kinds of runs, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    entries = []

    def add(run, cfg, res, status="completed"):
        entries.append({"hash": str(len(entries)), "run_name": run, "status": status,
                        "config": cfg, "results": res, "info": {}})

    def metric_value(metric):
        v = float(rng.normal(0.8, 0.05) * (60 if metric == "rmse" else 1))
        return float("nan") if rng.random() < 0.08 else v

    for ds, metric in DATASETS.items():
        models = [("ncde", "rectilinear"), ("ncde", "rectilinear-intensity"), ("ncde", "linear"),
                  ("gru", None), ("gru-d", None), ("gru-dt", None), ("odernn", None),
                  ("mystery", None), (None, None)]
        for ms, interp in models:
            for s in (111, 222, 333):
                if rng.random() < 0.15:
                    continue
                cfg = {"dataset_name": ds, "seed": s,
                       "dataset": {"interpolation": interp, "evaluation_metric": metric},
                       "model": {"adjoint": False} if ms is None else
                       {"model_string": ms, "adjoint": False}}
                res = {f"test.{metric}": metric_value(metric), "num_params": 1000 + s,
                       "nfe_per_epoch": float(rng.integers(1000, 90000)) if ms == "ncde"
                       else None, "history": [{"loss": 1.0}], "test.loss": float(rng.random()),
                       "converged": bool(rng.random() < 0.5)}
                if rng.random() < 0.1:
                    res.pop(f"test.{metric}")
                add("medical-sota", cfg, res)
        for vf, sp in [("original", None), ("sparse", 0.5), ("sparse", 0.9), ("sparse", 0.75),
                       ("low-rank", 0.5), ("low-rank", 0.99), ("minimal", None), ("gru", None),
                       ("sparse", 0), ("low-rank", 0.95)]:
            for vft in ("matmul", "evaluate", "derivative") if sp is None else ("matmul",):
                for s in (0, 111):
                    if rng.random() < 0.1:
                        continue
                    cfg = {"dataset_name": ds, "seed": s,
                           "dataset": {"interpolation": "rectilinear",
                                       "evaluation_metric": metric},
                           "model": {"model_string": "ncde", "vector_field": vf,
                                     "vector_field_type": vft, "sparsity": sp}}
                    if vft == "matmul" and vf == "original" and rng.random() < 0.5:
                        del cfg["model"]["vector_field_type"]
                    res = {f"test.{metric}": metric_value(metric)}
                    if rng.random() < 0.9:
                        res["num_params"] = int(5000 * (1 - (sp or 0)) + s)
                    add("sparsity", cfg, res)
        for interp in ("linear", "rectilinear", "cubic", "linear_cubic_smoothing"):
            for eps in (None, 0.5, 1.0):
                for s in (111, 222):
                    cfg = {"dataset_name": ds, "seed": s,
                           "dataset": {"interpolation": interp, "evaluation_metric": metric},
                           "model": {"model_string": "ncde", "interpolation_eps": eps}}
                    add("interpolation", cfg, {f"test.{metric}": metric_value(metric),
                                               "nfe_per_epoch": float(rng.integers(100, 9000))})
    add("medical-sota", {"dataset_name": "Sepsis", "seed": 9, "dataset": {},
                         "model": {"model_string": "gru"}}, {}, status="running")
    with open(path, "w") as fh:
        for e in entries:
            fh.write(json.dumps(e) + "\n")


@pytest.fixture(scope="module", params=[0, 1, 2, 3])
def ledger_path(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ledger") / "ledger.jsonl")
    _fixture(path, request.param)
    return path


def _written(write, ledger, out_dir, run):
    return {os.path.relpath(p, out_dir): open(p).read() for p in write(ledger, out_dir, run)}


@pytest.mark.parametrize("run", RUNS)
def test_every_table_is_pandas_byte_for_byte(ledger_path, run, tmp_path):
    want = _written(jax_analyse.write_analysis_tables, JaxLedger(ledger_path),
                    str(tmp_path / "jax"), run)
    got = _written(analyse.write_analysis_tables, Ledger(ledger_path),
                   str(tmp_path / "port"), run)
    assert sorted(got) == sorted(want)
    assert len(got) >= 4
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("run", RUNS)
def test_metric_and_nfe_tables_are_pandas_byte_for_byte(ledger_path, run):
    for fn in ("metric_table", "nfe_table"):
        got = getattr(analyse, fn)(Ledger(ledger_path), run, latex=True)
        want = getattr(jax_analyse, fn)(JaxLedger(ledger_path), run, latex=True)
        assert got == want, fn


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b) or (a is None and b is None)


def test_runs_frame_rows_equal_the_dataframe(ledger_path):
    frame = analyse.runs_frame(Ledger(ledger_path))
    want = jax_analyse.runs_frame(JaxLedger(ledger_path))
    assert list(frame.columns) == list(want.columns)
    assert len(frame) == len(want)
    for got_row, want_row in zip(frame.to_rows(), want.to_dict("records")):
        for key, w in want_row.items():
            g = got_row[key]
            if isinstance(w, float) and math.isnan(w):
                assert g is None or (isinstance(g, float) and math.isnan(g)), key
            else:
                assert g == w, key


@pytest.mark.parametrize("value,index,columns", [
    ("test_metric", ("model",), ("dataset_name",)),
    ("test_metric", ("dataset_name",), ("model",)),
    ("test.loss", ("model", "interpolation"), ("dataset_name",)),
    ("nfe_per_epoch", ("interpolation",), ()),
    ("num_params", ("vector_field", "sparsity"), ("dataset_name",)),
])
def test_seed_averaged_pivots_equal_pandas(ledger_path, value, index, columns):
    got = analyse.seed_averaged(analyse.runs_frame(Ledger(ledger_path)), value, index, columns)
    want = jax_analyse.seed_averaged(jax_analyse.runs_frame(JaxLedger(ledger_path)), value,
                                     index, columns)
    assert got.empty == want.empty
    if not want.empty:
        assert got.to_latex() == want.to_latex()


def test_an_empty_ledger_writes_nothing(tmp_path):
    ledger = str(tmp_path / "empty.jsonl")
    open(ledger, "w").close()
    assert analyse.write_analysis_tables(Ledger(ledger), str(tmp_path / "out")) == []
    assert analyse.metric_table(Ledger(ledger)).empty


def test_the_cli_prints_and_writes_the_tables(ledger_path, tmp_path, capsys):
    out = str(tmp_path / "tables")
    assert port_run.main(["medical-sota", "--ledger", ledger_path, "--analyse",
                          "--tables-out", out]) is None
    printed = capsys.readouterr().out
    assert "Sepsis" in printed and "wrote " in printed
    want = _written(jax_analyse.write_analysis_tables, JaxLedger(ledger_path),
                    str(tmp_path / "jax"), "medical-sota")
    for name, text in want.items():
        with open(os.path.join(out, name)) as fh:
            assert fh.read() == text, name
    # --test-mode reads the prefixed run name, which this ledger lacks.
    port_run.main(["medical-sota", "--ledger", ledger_path, "--analyse", "--test-mode"])
    assert "(empty table)" in capsys.readouterr().out
