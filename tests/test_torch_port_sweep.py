"""The PyTorch port's sweep runner, CLI and ``predictor_from_bundle`` on
the CPU (``device="cpu"`` / ``--device cpu``): the toy suite end to end
with the result keys of the JAX package's sweep smoke test and its dedup,
a seed group of an adjoint model (which cannot wave) run one config
after another (each equal to its solo run), crash isolation, the watchdog
and plain-JSON results of an isolated child, the refusals naming their
ROADMAP items, and ``predictor_from_bundle``
against the JAX package's at f64 over an NCDE and a GRU-D bundle."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu import serving as jax_serving
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.training import harness as jax_harness
from online_neural_cdes_tpu_torch import linear_interpolation_coeffs, params_from_jax
from online_neural_cdes_tpu_torch import run as port_run
from online_neural_cdes_tpu_torch.data.builders import build_toy_bm
from online_neural_cdes_tpu_torch.serving import predictor_from_bundle
from online_neural_cdes_tpu_torch.training import harness, sweep
from online_neural_cdes_tpu_torch.training.config import DEFAULT_CONFIG_DIR
from online_neural_cdes_tpu_torch.training.ledger import Ledger

torch.set_num_threads(1)

TOY_MODEL = {"model_string": ["ncde"], "hidden_dim": [8], "hidden_hidden_dim": [16],
             "num_layers": [2], "adjoint": [True], "solver": ["rk4"]}
TOY_DATASET = {"interpolation": ["rectilinear"], "batch_size": [128]}


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("processed"))
    build_toy_bm(root=root, num_paths=160, n_points=8, seed=0)
    return root


def _write_config_dir(tmp_path, suites: dict) -> str:
    """A config dir with the port's dataset.json5 and custom suites (plain
    JSON is JSON5)."""
    config_dir = str(tmp_path / "configurations")
    os.makedirs(config_dir, exist_ok=True)
    shutil.copy(os.path.join(DEFAULT_CONFIG_DIR, "dataset.json5"),
                os.path.join(config_dir, "dataset.json5"))
    with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
        json.dump(suites, fh)
    return config_dir


def _suite(seeds=(0,), **trainer):
    return {"hyperparameters": ["set"], "seed": list(seeds), "dataset_name": ["ToyBM"],
            "dataset": TOY_DATASET, "model": TOY_MODEL,
            "trainer": {"max_epochs": [1], **{k: [v] for k, v in trainer.items()}}}


# ------------------------------------------------------------ the suite


def test_toy_suite_end_to_end_and_dedup(toy_dataset, tmp_path, capsys):
    """The package's toy suite through ``sweep.run``, then the CLI against
    the same ledger (nothing left to run), then the CLI on a new ledger."""
    ledger_path = str(tmp_path / "ledger.jsonl")
    completed = sweep.run("toy", ledger_path=ledger_path, data_root=toy_dataset,
                          device="cpu")
    assert len(completed) == 1
    cfg, results = completed[0]
    assert results["epochs_run"] == 3
    for key in ("test.loss", "test.auc", "num_params", "time_per_epoch", "nfe_per_epoch"):
        assert key in results, (key, sorted(results))
    assert np.isfinite(results["test.loss"])
    assert results["nfe_per_epoch"] > 0
    assert sweep.run("toy", ledger_path=ledger_path, data_root=toy_dataset,
                     device="cpu") == []

    args = ["toy", "--data-root", toy_dataset, "--device", "cpu"]
    assert port_run.main(args + ["--ledger", ledger_path]) == []
    assert "completed 0 configs" in capsys.readouterr().out
    fresh = port_run.main(args + ["--ledger", str(tmp_path / "cli.jsonl")])
    assert "completed 1 configs" in capsys.readouterr().out
    assert fresh[0][1]["test.loss"] == results["test.loss"]
    entry, = Ledger(ledger_path).query(lambda e: e["status"] == "completed")
    assert entry["results"]["test.loss"] == results["test.loss"]
    assert "best_params" not in entry["results"]


def test_seed_group_runs_each_config_as_its_solo_run(toy_dataset, tmp_path):
    config_dir = _write_config_dir(tmp_path, {"toy3": _suite(seeds=(0, 1, 2))})
    ledger_path = str(tmp_path / "ledger.jsonl")
    completed = sweep.run("toy3", ledger_path=ledger_path, data_root=toy_dataset,
                          config_dir=config_dir, device="cpu")
    assert sorted(cfg["seed"] for cfg, _ in completed) == [0, 1, 2]
    assert len(Ledger(ledger_path).query(lambda e: e["status"] == "completed")) == 3
    assert sweep.run("toy3", ledger_path=ledger_path, data_root=toy_dataset,
                     config_dir=config_dir, device="cpu") == []
    solo = sweep.run("toy3", ledger_path=str(tmp_path / "solo.jsonl"), data_root=toy_dataset,
                     config_dir=config_dir, co_schedule=False, num_shards=3, shard_index=0,
                     device="cpu")
    assert len(solo) == 1 and solo[0][0]["seed"] == 0
    seed0 = next(r for cfg, r in completed if cfg["seed"] == 0)
    for key in ("test.loss", "test.auc", "history", "best_epoch"):
        assert solo[0][1][key] == seed0[key], key
    assert len({r["test.loss"] for _, r in completed}) == 3


# ------------------------------------------------------------ isolation


def test_isolated_crash_is_recorded_and_the_suite_goes_on(toy_dataset, tmp_path):
    """A config whose dataset is missing kills its child: a ``failed``
    sentinel (retried next sweep), and the next config completes with
    plain JSON numbers and no weights."""
    broken = _suite()
    broken["dataset_name"] = ["Mortality"]   # no MIMIC npz under the toy root
    config_dir = _write_config_dir(tmp_path, {"mixed": {
        "hyperparameters": ["set"], "seed": [0],
        "multi-config": {"broken": {k: v for k, v in broken.items()
                                    if k not in ("hyperparameters", "seed")},
                         "ok": {k: v for k, v in _suite().items()
                                if k not in ("hyperparameters", "seed")}}}})
    ledger_path = str(tmp_path / "ledger.jsonl")
    completed = sweep.run("mixed", ledger_path=ledger_path, data_root=toy_dataset,
                          config_dir=config_dir, isolate=True, device="cpu")
    assert len(completed) == 1 and completed[0][0]["dataset_name"] == "ToyBM"
    results = completed[0][1]
    assert "best_params" not in results
    for key in ("test.loss", "test.auc", "time_per_epoch", "num_params"):
        assert type(results[key]) in (int, float), (key, results[key])
    assert all(type(h["loss"]) is float for h in results["history"])
    ledger = Ledger(ledger_path)
    failed, = ledger.query(lambda e: e.get("status") == "failed")
    assert failed["config"]["dataset_name"] == "Mortality" and "exit code" in failed["error"]
    assert not ledger.check_if_run(failed["config"], run_name="mixed")


def test_watchdog_kills_a_hung_child(toy_dataset, tmp_path):
    endless = _suite(max_epochs=100000, early_stop_patience=100000, plateau_patience=100000)
    config_dir = _write_config_dir(tmp_path, {"hang": endless})
    ledger_path = str(tmp_path / "ledger.jsonl")
    assert sweep.run("hang", ledger_path=ledger_path, data_root=toy_dataset,
                     config_dir=config_dir, config_timeout_s=6.0, device="cpu") == []
    failed, = Ledger(ledger_path).query(lambda e: e.get("status") == "failed")
    assert "config_timeout_s" in failed["error"]


# ------------------------------------------------------------- refusals


def test_refusals_name_their_roadmap_items(tmp_path):
    """Items 18a and 18b are ported (tests/test_torch_port_parallel.py runs
    --data-parallel, tests/test_torch_port_sequence.py the pipelined
    solve); what stays refused: a mesh that is not one.  The pipeline's
    entry points are the real ones: a sequence mesh asks for a process
    group as every mesh does, and refuses nothing by item."""
    from online_neural_cdes_tpu_torch import parallel
    from online_neural_cdes_tpu_torch.parallel import sequence

    ledger_path = str(tmp_path / "ledger.jsonl")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        sweep.run("toy", ledger_path=ledger_path, mesh=object(), device="cpu")
    for name in ("make_sequence_mesh", "ncde_apply_pipelined", "pipelined_cde_solve"):
        assert getattr(parallel, name) is getattr(sequence, name)
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        parallel.make_sequence_mesh(2, devices="cpu")


# ------------------------------------------------ predictor_from_bundle


def _requests(seed, n=5, channels=3):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        length = int(rng.integers(4, 14))
        s = rng.normal(size=(length, channels)).astype(np.float32)
        s[rng.random(size=s.shape) < 0.25] = np.nan
        s[0] = rng.normal(size=channels)
        s[:, 0] = np.arange(length)
        reqs.append(s)
    return reqs


def _bundles(model_string, **kw):
    kw = dict(input_dim=3, output_dim=2, hidden_dim=5, hidden_hidden_dim=6, num_layers=2,
              adjoint=False, **kw)
    jb = jax_harness.setup_model(model_string, **kw)
    tb = harness.setup_model(model_string, device="cpu", dtype=torch.float64, **kw)
    jp = jax.tree.map(lambda a: a.astype(jnp.float64), jb.init(jax.random.PRNGKey(5)))
    params = params_from_jax(jax.tree.map(np.asarray, jp),
                             tb.make_model(torch.Generator())).state_dict()
    return jb, jp, tb, params


SERVE = dict(batch_buckets=(4,), length_multiple=8)


def test_predictor_from_bundle_matches_jax_for_an_ncde():
    jb, jp, tb, params = _bundles("ncde", static_dim=2, interpolation="rectilinear",
                                  return_sequences=True)
    reqs = _requests(9)
    static = np.random.default_rng(9).normal(size=(len(reqs), 2)).astype(np.float32)
    jpred = jax_serving.predictor_from_bundle(
        jb, jp, coeff_fn=lambda x: jax_interp.linear_interpolation_coeffs(
            x.astype(jnp.float64), rectilinear=0), **SERVE)
    pred = predictor_from_bundle(
        tb, params, coeff_fn=lambda x: linear_interpolation_coeffs(x, rectilinear=0), **SERVE)
    assert pred.pad_forward_fill and pred.accept_static
    want = jpred.predict(reqs, static=static)
    got = pred.predict(reqs, static=static)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10)

    # The predictor serves the params it was given: neither an in-place
    # update of the bundle's model nor one of ``params`` reaches it.
    with torch.no_grad():
        for p in list(tb.model.parameters()) + list(params.values()):
            p.add_(0.05)
    for g, again in zip(got, pred.predict(reqs, static=static)):
        np.testing.assert_array_equal(again, g)


def test_predictor_from_bundle_matches_jax_for_gru_d():
    jb, jp, tb, params = _bundles("gru-d", return_sequences=True)
    reqs = _requests(11)
    jpred = jax_serving.predictor_from_bundle(jb, jp, **SERVE)
    pred = predictor_from_bundle(tb, params, **SERVE)
    assert not pred.pad_forward_fill and not pred.accept_static
    for g, w in zip(pred.predict(reqs), jpred.predict(reqs)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10)
    with pytest.raises(ValueError, match="static"):
        pred.predict(reqs, static=np.zeros((len(reqs), 2), np.float32))


def test_predictor_from_bundle_refuses_a_recurrent_one_shot_bundle():
    jb, jp, tb, params = _bundles("gru-d", return_sequences=False)
    with pytest.raises(ValueError, match="one-shot") as want:
        jax_serving.predictor_from_bundle(jb, jp)
    with pytest.raises(ValueError, match="one-shot") as got:
        predictor_from_bundle(tb, params)
    assert str(got.value) == str(want.value)
