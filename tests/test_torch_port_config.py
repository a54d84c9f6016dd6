"""Parity of the PyTorch port's configuration suites and run ledger
against the JAX package, on the CPU: the port's JSON5 reader against
``json5`` (the configuration files and edge cases; what lies outside the
subset raises), the port's copies of the configuration files, every
suite's expanded config list and run name with and without test mode
(``"load"`` suites against hyperopt results written by the JAX ledger),
``nested_parameter_grid``, ``parse_dataset_json``, ``update_hyperparams``,
and ``config_hash`` and the ledger file read across the two packages."""

import json
import os

import json5
import pytest

from online_neural_cdes_tpu.training import config as jax_config
from online_neural_cdes_tpu.training import ledger as jax_ledger
from online_neural_cdes_tpu_torch.training import config, ledger

FILES = ("configurations.json5", "dataset.json5")
SUITES = sorted(jax_config.load_json(os.path.join(jax_config.DEFAULT_CONFIG_DIR, FILES[0])))
DATASETS = sorted(jax_config.load_json(os.path.join(jax_config.DEFAULT_CONFIG_DIR, FILES[1])))


# ----------------------------------------------------------- JSON5 reader


@pytest.mark.parametrize("name", FILES)
def test_reader_matches_json5_on_the_configuration_files(name):
    path = os.path.join(config.DEFAULT_CONFIG_DIR, name)
    with open(path) as fh:
        text = fh.read()
    assert text.count("//") > 5 and ",\n" in text   # comments and trailing commas
    assert config.loads_json5(text) == json5.loads(text)
    assert config.load_json(path) == json5.loads(text)


@pytest.mark.parametrize("text", [
    '{"url": "http://host//path", "a": [1, 2,], }',
    '{"s": ",]", "t": ",}", "u": "a,// b"}',
    '{"esc": "quote \\" // not a comment", "b": "\\\\"} // trailing',
    '// head\n{\n  "a": {"b": [1, [2, 3,],],}, // after a value\n  "c": 5e-4,\n}\n// tail',
    '{"t": true, "f": false, "n": null, "x": -1.5E+3, "k": 20, "e": 1e-4}',
    '[{"a": 1,},\n // between\n {"b": 2},\n]',
])
def test_reader_matches_json5_on_edge_cases(text):
    assert config.loads_json5(text) == json5.loads(text)


@pytest.mark.parametrize("text", [
    "{'a': 1}",                # single quotes
    '{a: 1}',                  # unquoted key
    '{"a": 1 /* block */}',    # block comment
    '{"a": Infinity}',
    '{"a": -Infinity}',
    '{"a": NaN}',
    '{"a": 0x10}',             # hex
    '{"a": .5}',
    '{"a": +1}',
])
def test_reader_refuses_json5_outside_the_subset(text):
    """Valid JSON5 that the configuration files do not use raises; it is
    never read as something else."""
    json5.loads(text)
    with pytest.raises(ValueError):
        config.loads_json5(text)


def test_reader_refuses_an_unterminated_string():
    with pytest.raises(ValueError, match="unterminated"):
        config.loads_json5('{"a": "open}')


@pytest.mark.parametrize("name", FILES)
def test_port_copies_parse_equal_to_the_jax_files(name):
    with open(os.path.join(jax_config.DEFAULT_CONFIG_DIR, name)) as fh:
        want = json5.load(fh)
    assert config.load_json(os.path.join(config.DEFAULT_CONFIG_DIR, name)) == want
    assert os.path.dirname(config.DEFAULT_CONFIG_DIR) != os.path.dirname(
        jax_config.DEFAULT_CONFIG_DIR)


def test_load_json_caches_by_mtime_and_returns_copies(tmp_path):
    path = tmp_path / "c.json5"
    path.write_text('{"a": [1,],}')
    first = config.load_json(str(path))
    first["a"].append(2)
    assert config.load_json(str(path)) == {"a": [1]}
    path.write_text('{"a": [3],}')
    os.utime(path, (1, 1))
    assert config.load_json(str(path)) == {"a": [3]}


# ------------------------------------------------------------------ suites


def _hyperopt_ledger(path):
    """Completed hyperopt results, written by the JAX ledger, for every
    config the search suite runs; each with best parameters of its own."""
    search, _ = jax_config.parse_configuration_json("hyperopt")
    book = jax_ledger.Ledger(str(path))
    for i, cfg in enumerate(search):
        book.save_result(cfg, {"best_score": 0.1 * i}, run_name="hyperopt",
                         info={"best_parameters": {
                             "model": {"hidden_dim": 32 + i, "num_layers": 1 + i % 4},
                             "trainer": {"lr": 1e-3 * (1 + i)}}})
    return path


@pytest.fixture(scope="module")
def hyperopt_ledger(tmp_path_factory):
    return _hyperopt_ledger(tmp_path_factory.mktemp("ledger") / "ledger.jsonl")


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("suite", SUITES)
def test_suites_expand_as_in_jax(suite, test_mode, hyperopt_ledger):
    want, want_name = jax_config.parse_configuration_json(
        suite, test_mode=test_mode, ledger=jax_ledger.Ledger(str(hyperopt_ledger)))
    got, got_name = config.parse_configuration_json(
        suite, test_mode=test_mode, ledger=ledger.Ledger(str(hyperopt_ledger)))
    assert got_name == want_name
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert [ledger.config_hash(c) for c in got] == [jax_ledger.config_hash(c) for c in want]
    if want[0]["hyperparameters"] == "load":
        assert all(32 <= c["model"]["hidden_dim"] for c in got)   # injected


def test_nested_parameter_grid_matches_jax():
    grid = {"a": [1, 2], "model": {"h": [3, 4], "deep": {"x": [5, None]}}, "s": ["u"]}
    assert config.nested_parameter_grid(grid) == jax_config.nested_parameter_grid(grid)
    assert len(config.nested_parameter_grid(grid)) == 8


@pytest.mark.parametrize("name", DATASETS)
def test_parse_dataset_json_matches_jax(name):
    assert config.parse_dataset_json(name) == jax_config.parse_dataset_json(name)


def test_update_hyperparams_matches_jax(tmp_path):
    path = _hyperopt_ledger(tmp_path / "ledger.jsonl")
    base, _ = jax_config.parse_configuration_json("interpolation")
    want = jax_config.update_hyperparams(json.loads(json.dumps(base)),
                                         ledger=jax_ledger.Ledger(str(path)))
    got = config.update_hyperparams(json.loads(json.dumps(base)),
                                    ledger=ledger.Ledger(str(path)))
    assert got == want
    # No stored search for a config: both refuse it.
    empty = ledger.Ledger(str(tmp_path / "empty.jsonl"))
    with pytest.raises(FileNotFoundError, match="Cannot find hyperopt"):
        config.update_hyperparams(json.loads(json.dumps(base)), ledger=empty)
    with pytest.raises(FileNotFoundError, match="Cannot find hyperopt"):
        jax_config.update_hyperparams(json.loads(json.dumps(base)),
                                      ledger=jax_ledger.Ledger(str(tmp_path / "empty.jsonl")))


def test_unknown_suite_raises():
    with pytest.raises(ValueError, match="No configuration suite"):
        config.parse_configuration_json("no-such-suite")


# ------------------------------------------------------------------ ledger


def test_config_hash_matches_jax_over_every_suite(hyperopt_ledger):
    n = 0
    for suite in SUITES:
        for test_mode in (False, True):
            configs, _ = jax_config.parse_configuration_json(
                suite, test_mode=test_mode, ledger=jax_ledger.Ledger(str(hyperopt_ledger)))
            for cfg in configs:
                assert ledger.config_hash(cfg) == jax_ledger.config_hash(cfg)
                n += 1
    assert n > 500


@pytest.mark.parametrize("writer,reader", [(jax_ledger, ledger), (ledger, jax_ledger)])
def test_a_ledger_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "ledger.jsonl")
    cfg_a = {"model": {"h": 1}, "seed": 0, "trainer": {"lr": 5e-4}}
    cfg_b = {"model": {"h": 2}, "seed": 0}
    cfg_c = {"model": {"h": 3}, "seed": 1}
    w = writer.Ledger(path)
    w.mark_running(cfg_a, "run")
    w.save_result(cfg_a, {"test.auc": 0.9, "best_params": "dropped"}, "run",
                  info={"note": 1})
    w.mark_running(cfg_b, "run")
    w.mark_failed(cfg_c, "run", error="child died")
    w.save_result(cfg_b, {"test.auc": 0.7}, "other")

    r = reader.Ledger(path)
    assert r.check_if_run(cfg_a, "run")
    assert not r.check_if_run(cfg_b, "run")       # running, not completed
    assert not r.check_if_run(cfg_c, "run")       # failed, retried next sweep
    assert r.check_if_run(cfg_b, "other")
    failed = r.query(lambda e: e.get("status") == "failed")
    assert [e["error"] for e in failed] == ["child died"]
    done = r.query(lambda e: e.get("status") == "completed" and e["run_name"] == "run")
    assert done[0]["results"] == {"test.auc": 0.9} and done[0]["info"] == {"note": 1}
    assert r.purge_incomplete_runs("run") == 2      # cfg_b running, cfg_c failed
    again = writer.Ledger(path)
    assert again.check_if_run(cfg_a, "run") and again.check_if_run(cfg_b, "other")
    assert not again.query(lambda e: e.get("status") in ("running", "failed"))
