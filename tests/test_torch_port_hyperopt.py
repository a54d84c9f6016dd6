"""The PyTorch port's hyperparameter search on the CPU against the JAX
package's: the unit decoding, Sobol, random and TPE draws, the dunder
decoding and merge, ``run_hyperopt``'s trial sequence and records in every
search mode and wave size (the same fake objective under both), resume,
re-running only a missing record and a stale one (after the JAX package's
``tests/test_metrics_and_search.py``); then real toy searches whose
same-shape trials train as one wave, equal to the same search run trial by
trial, the failure sentinel with its traceback logged, the wave's catch
of ``WaveUnsupported`` alone, adjoint and dopri5 searches as waves, and a
``"hyperopt"`` suite through ``sweep.run`` and the CLI."""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import online_neural_cdes_tpu.training.hyperopt as jax_ho
from online_neural_cdes_tpu.training.ledger import Ledger as JaxLedger
from online_neural_cdes_tpu_torch import run as port_run
from online_neural_cdes_tpu_torch.data.builders import build_toy_bm
from online_neural_cdes_tpu_torch.training import hyperopt as ho
from online_neural_cdes_tpu_torch.training import sweep, wave
from online_neural_cdes_tpu_torch.training.config import DEFAULT_CONFIG_DIR
from online_neural_cdes_tpu_torch.training.ledger import Ledger

torch.set_num_threads(1)

SPACE = [
    {"name": "model__hidden_dim", "type": "range", "bounds": [32, 256]},
    {"name": "trainer__lr", "type": "range", "bounds": [1e-4, 1e-1], "log_scale": True},
    {"name": "model__kind", "type": "choice", "values": ["a", "b", "c"]},
    {"name": "model__hidden_hidden_dim", "type": "range", "bounds": [8, 64],
     "log_scale": True},
    {"name": "trainer__plateau_factor", "type": "range", "bounds": [0.1, 0.9]},
    {"name": "model__adjoint", "type": "fixed", "value": False},
]


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("processed"))
    build_toy_bm(root=root, num_paths=160, n_points=8, seed=0)
    return root


# ------------------------------------------------------------- the draws


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_draws_equal_jax(seed):
    for n in (1, 5, 8):
        assert ho.sobol_parameterizations(SPACE, n, seed) == \
            jax_ho.sobol_parameterizations(SPACE, n, seed)
    assert ho.sample_parameterization(SPACE, np.random.default_rng(seed)) == \
        jax_ho.sample_parameterization(SPACE, np.random.default_rng(seed))
    for u in (0.0, 0.123, 0.5, 0.999, 1.0):
        for p in SPACE:
            assert ho._decode_unit(p, u) == jax_ho._decode_unit(p, u)
    rng = np.random.default_rng(seed)
    obs, scores = rng.uniform(size=(12, 4)), rng.normal(size=12)
    for gamma in (0.25, 0.5):
        got = ho.tpe_suggest(obs, scores, np.random.default_rng((seed, 1)), gamma=gamma)
        want = jax_ho.tpe_suggest(obs, scores, np.random.default_rng((seed, 1)), gamma=gamma)
        np.testing.assert_array_equal(got, want)


def test_dunder_decoding_and_merge_equal_jax():
    point = {"model__hidden_dim": 64, "trainer__lr": 1e-3, "a__b__c": [1, 2], "flat": 3}
    assert ho.decode_dunder(point) == jax_ho.decode_dunder(point)
    base = {"model": {"hidden_dim": 8, "solver": "rk4"}, "trainer": {"lr": 1.0}, "x": 1}
    assert ho._merge(base, ho.decode_dunder(point)) == \
        jax_ho._merge(base, jax_ho.decode_dunder(point))
    assert base["model"]["hidden_dim"] == 8          # the merge copies


# ------------------------------------------- the search against the JAX one


def _objective(cfg, **kw):
    h = float(cfg["model"]["hidden_dim"])
    lr = float(cfg["trainer"]["lr"])
    return {"val.loss": ((h - 150.0) / 224.0) ** 2 + (np.log(lr / 3e-3) / np.log(100.0)) ** 2,
            "test.loss": h}


SEARCH = {
    "parameterization": SPACE[:2] + [SPACE[-1]],
    "evaluation_metric": "loss", "total_trials": 10, "seed": 0,
    "model": {}, "trainer": {},
}


def _records(ledger, run_name):
    return sorted(((e["config"]["trial"], e["results"]["score"], e["info"]["unit_row"],
                    e["info"]["point"])
                   for e in ledger.query(lambda e: e.get("run_name") == f"{run_name}::trials")),
                  key=lambda r: r[0])


@pytest.mark.parametrize("search,wave_size", [("tpe", 1), ("tpe", 3), ("sobol", 1),
                                              ("random", 4), ("tpe", 10)])
def test_search_sequence_equals_jax(search, wave_size, monkeypatch, tmp_path):
    """The same objective under both searches: equal records (trial,
    score, unit row, point), best score and best parameters.  Trials run
    one by one (``wave_vmap: False``)."""
    monkeypatch.setattr(ho, "run_experiment", _objective)
    monkeypatch.setattr(jax_ho, "run_experiment", _objective)
    cfg = {**SEARCH, "search": search, "wave_size": wave_size, "wave_vmap": False}
    got = ho.run_hyperopt(dict(cfg), ledger=Ledger(str(tmp_path / "p.jsonl")), run_name="h")
    want = jax_ho.run_hyperopt(dict(cfg), ledger=JaxLedger(str(tmp_path / "j.jsonl")),
                               run_name="h")
    assert _records(Ledger(str(tmp_path / "p.jsonl")), "h") == \
        _records(JaxLedger(str(tmp_path / "j.jsonl")), "h")
    assert got["best_score"] == want["best_score"]
    assert got["best_parameters"] == want["best_parameters"]
    assert got == want


def _counting_objective(calls):
    def run_experiment(cfg, **kw):
        calls["n"] += 1
        return {"val.loss": (float(cfg["model"]["hidden_dim"]) - 150.0) ** 2}

    return run_experiment


HIDDEN_ONLY = {"parameterization": [{"name": "model__hidden_dim", "type": "range",
                                     "bounds": [32, 256]}],
               "evaluation_metric": "loss", "seed": 0, "model": {}, "trainer": {}}


def test_search_resumes_from_its_records(monkeypatch, tmp_path):
    calls = {"n": 0}
    monkeypatch.setattr(ho, "run_experiment", _counting_objective(calls))
    ledger = Ledger(str(tmp_path / "ledger.jsonl"))
    first = ho.run_hyperopt({**HIDDEN_ONLY, "total_trials": 8}, ledger=ledger,
                            run_name="hyperopt")
    assert calls["n"] == 8
    second = ho.run_hyperopt({**HIDDEN_ONLY, "total_trials": 8}, ledger=ledger,
                             run_name="hyperopt")
    assert calls["n"] == 8
    assert second["best_score"] == first["best_score"]
    assert second["best_parameters"] == first["best_parameters"]


def _rewrite(path, fn):
    lines = [json.loads(line) for line in open(path)]
    with open(path, "w") as fh:
        for e in fn(lines):
            fh.write(json.dumps(e) + "\n")


def test_a_missing_record_reruns_alone(monkeypatch, tmp_path):
    calls = {"n": 0}
    monkeypatch.setattr(ho, "run_experiment", _counting_objective(calls))
    path = tmp_path / "ledger.jsonl"
    cfg = {**HIDDEN_ONLY, "total_trials": 6}
    first = ho.run_hyperopt(dict(cfg), ledger=Ledger(str(path)), run_name="hyperopt")
    _rewrite(path, lambda lines: [e for e in lines if e["config"].get("trial") != 2])
    second = ho.run_hyperopt(dict(cfg), ledger=Ledger(str(path)), run_name="hyperopt")
    assert calls["n"] == 6 + 1
    assert second["best_score"] == first["best_score"]


def test_a_stale_record_reruns(monkeypatch, tmp_path):
    """Trial 2's score tampered with: the startup rows replay, the TPE
    trial that conditioned on it (trial 5) runs again."""
    calls = {"n": 0}
    monkeypatch.setattr(ho, "run_experiment", _counting_objective(calls))
    path = tmp_path / "ledger.jsonl"
    cfg = {**HIDDEN_ONLY, "total_trials": 6}
    ho.run_hyperopt(dict(cfg), ledger=Ledger(str(path)), run_name="hyperopt")

    def tamper(lines):
        for e in lines:
            if e["config"].get("trial") == 2:
                e["results"]["score"] = 0.0
        return lines

    _rewrite(path, tamper)
    ho.run_hyperopt(dict(cfg), ledger=Ledger(str(path)), run_name="hyperopt")
    assert calls["n"] == 6 + 1


# ------------------------------------------------------ real toy searches


def _toy_search(**extra):
    return {
        "parameterization": [{"name": "trainer__lr", "type": "range",
                              "bounds": [1e-3, 1e-1], "log_scale": True}],
        "evaluation_metric": "loss", "total_trials": 4, "seed": 0,
        "dataset_name": "ToyBM",
        "dataset": {"data_loc": "Toy/BM", "problem": "online", "use_static": True,
                    "interpolation": "rectilinear", "batch_size": 128},
        "model": {"model_string": "ncde", "hidden_dim": 6, "hidden_hidden_dim": 8,
                  "num_layers": 1, "adjoint": False, "solver": "rk4"},
        "trainer": {"loss_str": "bce", "metrics": ["loss"], "val_metric_to_monitor": "loss",
                    "max_epochs": 2},
        **extra,
    }


def _count_waves(monkeypatch):
    calls = []
    real = wave.run_trials_vmapped

    def counting(cfgs, **kw):
        calls.append(len(cfgs))
        return real(cfgs, **kw)

    monkeypatch.setattr(wave, "run_trials_vmapped", counting)
    return calls


def test_a_wave_of_trials_equals_the_trials_one_by_one(toy_dataset, monkeypatch, tmp_path):
    """Four lr candidates as one wave of four lanes: each trial's score and
    the best parameters are those of the same search run trial by trial
    (``wave_vmap: False``), within f32's slice tolerance."""
    calls = _count_waves(monkeypatch)
    kw = dict(data_root=toy_dataset, run_name="h", device="cpu")
    waved = ho.run_hyperopt(_toy_search(wave_size=4), ledger=Ledger(str(tmp_path / "w.jsonl")),
                            **kw)
    assert calls == [4]
    serial = ho.run_hyperopt(_toy_search(wave_size=4, wave_vmap=False),
                             ledger=Ledger(str(tmp_path / "s.jsonl")), **kw)
    assert calls == [4]
    assert waved["best_parameters"] == serial["best_parameters"]
    got, want = (_records(Ledger(str(tmp_path / f)), "h") for f in ("w.jsonl", "s.jsonl"))
    assert [r[0] for r in got] == [0, 1, 2, 3] and [r[3] for r in got] == [r[3] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-5)
    assert all(np.isfinite(r[1]) and r[1] != ho.FAILURE_SENTINEL for r in got)


def test_a_failed_trial_scores_the_sentinel_and_logs_its_traceback(toy_dataset, monkeypatch,
                                                                   caplog):
    def broken(cfg, **kw):
        raise RuntimeError("trial crashed")

    monkeypatch.setattr(ho, "run_experiment", broken)
    with caplog.at_level(logging.WARNING, logger=ho.__name__):
        res = ho.run_hyperopt(_toy_search(total_trials=2), data_root=toy_dataset,
                              device="cpu")
    assert res["best_score"] == ho.FAILURE_SENTINEL
    assert res["error"] == "trial crashed"
    failed = [r for r in caplog.records if "hyperopt trial failed" in r.getMessage()]
    assert len(failed) == 2 and all(r.exc_info for r in failed)


def test_the_wave_catches_wave_unsupported_alone(toy_dataset, monkeypatch):
    """A wave its model refuses (``WaveUnsupported``, as ``check_waveable``
    raises for ``scipy_solver``) has its trials run one by one; any other
    error of a wave propagates."""
    calls = _count_waves(monkeypatch)

    def refuse(model, compute_dtype=None):
        raise wave.WaveUnsupported("refused for the test")

    search = _toy_search(wave_size=2, total_trials=2)
    with monkeypatch.context() as patched:
        patched.setattr(wave, "check_waveable", refuse)
        res = ho.run_hyperopt(search, data_root=toy_dataset, device="cpu")
    assert calls == [2] and np.isfinite(res["best_score"]) and "error" not in res

    def broken(cfgs, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(wave, "run_trials_vmapped", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ho.run_hyperopt(_toy_search(wave_size=2, total_trials=2), data_root=toy_dataset,
                        device="cpu")


@pytest.mark.parametrize("model", [{"adjoint": True}, {"solver": "dopri5"}],
                         ids=["adjoint", "dopri5"])
def test_a_search_waves_adjoint_and_adaptive_trials(model, toy_dataset, monkeypatch, tmp_path):
    """Candidates of an adjoint model, or of a dopri5 one (each lane its
    own accepted steps), train as one wave: one ``run_trials_vmapped``
    call, each trial's score that of the search run trial by trial."""
    calls = _count_waves(monkeypatch)
    search = _toy_search(wave_size=2, total_trials=2)
    search["model"].update(model)
    if "solver" in model:
        search["dataset"]["interpolation"] = "hermite"
    kw = dict(data_root=toy_dataset, run_name="h", device="cpu")
    ho.run_hyperopt(search, ledger=Ledger(str(tmp_path / "w.jsonl")), **kw)
    assert calls == [2]
    ho.run_hyperopt({**search, "wave_vmap": False}, ledger=Ledger(str(tmp_path / "s.jsonl")),
                    **kw)
    assert calls == [2]
    got, want = (_records(Ledger(str(tmp_path / f)), "h") for f in ("w.jsonl", "s.jsonl"))
    assert [r[3] for r in got] == [r[3] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-5)


def test_mesh_names_item_18():
    """Item 18's mesh is ported (tests/test_torch_port_parallel.py); a
    search refuses anything but a parallel.mesh.Mesh before its first
    trial, rather than scoring every trial as failed."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ho.run_hyperopt(_toy_search(), mesh=object())


# ------------------------------------------------------- suites and CLI


def test_a_hyperopt_suite_runs_through_the_sweep_and_the_cli(toy_dataset, tmp_path,
                                                             monkeypatch):
    """A ``"hyperopt"`` suite: each config a search (its trials one wave),
    the best parameters stored in the ledger, a "load" suite taking them,
    and nothing left to run the second time."""
    config_dir = str(tmp_path / "configurations")
    os.makedirs(config_dir)
    shutil.copy(os.path.join(DEFAULT_CONFIG_DIR, "dataset.json5"), config_dir)
    base = {"dataset_name": ["ToyBM"],
            "dataset": {"interpolation": ["rectilinear"], "batch_size": [128]},
            "model": {"model_string": ["ncde"], "hidden_dim": [6], "hidden_hidden_dim": [8],
                      "num_layers": [1], "adjoint": [False], "solver": ["rk4"]},
            "trainer": {"max_epochs": [1]}}
    suites = {"hyperopt": {**base, "hyperparameters": ["hyperopt"], "seed": [9999],
                           "total_trials": [3], "wave_size": [3], "parameterization": [[
                               {"name": "trainer__lr", "type": "range",
                                "bounds": [1e-3, 1e-1], "log_scale": True}]]},
              "final": {**base, "hyperparameters": ["load"], "seed": [0, 1]}}
    with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
        json.dump(suites, fh)
    calls = _count_waves(monkeypatch)
    ledger_path = str(tmp_path / "ledger.jsonl")
    args = ["--config-dir", config_dir, "--data-root", toy_dataset, "--ledger", ledger_path,
            "--device", "cpu"]
    completed = port_run.main(["hyperopt"] + args)
    assert len(completed) == 1 and calls == [3]
    entry, = Ledger(ledger_path).query(lambda e: e.get("run_name") == "hyperopt"
                                       and e.get("status") == "completed")
    lr = entry["info"]["best_parameters"]["trainer"]["lr"]
    assert 1e-3 <= lr <= 1e-1 and "best_parameters" not in entry["results"]
    assert port_run.main(["hyperopt"] + args) == []
    final = port_run.main(["final"] + args)
    assert calls == [3, 2]
    assert [cfg["trainer"]["lr"] for cfg, _ in final] == [lr, lr]
    isolated = sweep.run("hyperopt", ledger_path=str(tmp_path / "iso.jsonl"),
                         data_root=toy_dataset, config_dir=config_dir, isolate=True,
                         device="cpu")
    assert isolated[0][1]["best_score"] == pytest.approx(entry["results"]["best_score"],
                                                         rel=1e-5)
