"""Configuration suites: the JSON5 sweep suites, nested grid expansion,
the per-dataset option merge, stored hyperopt results, test-mode shrinkage.

PyTorch port's counterpart of the JAX package's ``training/config.py``,
with the same functions and the same results.  The suites and the dataset
registry are the port's own copies (``configurations/*.json5``), read by a
small reader of the JSON5 the two files use (``load_json``): the machines
the port runs on need not have the ``json5`` package.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
from typing import List, Optional

__all__ = [
    "load_json",
    "nested_parameter_grid",
    "parse_dataset_json",
    "parse_configuration_json",
    "set_test_mode",
    "update_hyperparams",
]

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG_DIR = os.path.join(_HERE, "configurations")


def _json5_to_json(text: str) -> str:
    """The JSON5 subset of the suites as JSON: ``//`` line comments are
    dropped, and so is a comma whose next token is ``}`` or ``]``; strings
    (double-quoted, with their escapes) pass through untouched.  Single
    quotes and block comments raise ``ValueError``; anything else outside
    JSON (unquoted keys, ``Infinity``, hex numbers) is left for
    ``json.loads`` to refuse."""
    out = []
    i, n = 0, len(text)

    def skip_blank(j):
        """Index of the next character that is neither white space nor
        inside a ``//`` comment."""
        while j < n:
            if text[j] in " \t\r\n":
                j += 1
            elif text.startswith("//", j):
                end = text.find("\n", j)
                j = n if end < 0 else end
            else:
                return j
        return j

    while i < n:
        ch = text[i]
        if ch == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            if j >= n:
                raise ValueError(f"unterminated string at offset {i}")
            out.append(text[i:j + 1])
            i = j + 1
        elif text.startswith("//", i):
            i = skip_blank(i)
        elif text.startswith("/*", i):
            raise ValueError(f"block comments are outside the JSON5 subset read here "
                             f"(offset {i})")
        elif ch == "'":
            raise ValueError(f"single-quoted strings are outside the JSON5 subset read "
                             f"here (offset {i})")
        elif ch == ",":
            j = skip_blank(i + 1)
            if j >= n or text[j] not in "}]":
                out.append(ch)
            i += 1
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _refuse_constant(name):
    raise ValueError(f"{name} is outside the JSON5 subset read here")


def loads_json5(text: str):
    """Parse the JSON5 subset of the configuration files (see
    :func:`_json5_to_json`); input outside it raises ``ValueError``."""
    return json.loads(_json5_to_json(text), parse_constant=_refuse_constant)


def load_json(path: str) -> dict:
    """The parsed file, cached by absolute path and mtime (the suites and
    the dataset registry are static); each call returns its own copy."""
    path = os.path.abspath(path)
    return copy.deepcopy(_load_json_cached(path, os.path.getmtime(path)))


def _load_json_cached(path: str, _mtime: float) -> dict:
    key = (path, _mtime)
    if key not in _JSON_CACHE:
        with open(path) as f:
            _JSON_CACHE[key] = loads_json5(f.read())
    return _JSON_CACHE[key]


_JSON_CACHE: dict = {}


def _flatten(d: dict, prefix: str = "") -> dict:
    """Nested dict-of-lists -> {dunder_path: list_of_values}."""
    out = {}
    for key, value in d.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, prefix=f"{path}__"))
        else:
            if not isinstance(value, list):
                raise ValueError(
                    f"Grid leaves must be lists; {path} is {type(value).__name__}")
            out[path] = value
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        parts = path.split("__")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def nested_parameter_grid(grid: dict) -> List[dict]:
    """Every combination of a nested dict whose leaves are lists of
    options (scikit-learn's ``ParameterGrid`` over nested dicts)."""
    flat = _flatten(grid)
    keys = list(flat.keys())
    return [_unflatten(dict(zip(keys, combo)))
            for combo in itertools.product(*(flat[k] for k in keys))]


def _update_nested(config: dict, updater: dict) -> dict:
    """Leaf-wise merge: ``updater``'s values win, but sibling keys in
    nested dicts survive (a suite-level ``trainer: {max_epochs: [10]}``
    must not replace a sub-config's ``trainer: {lr: [5e-4]}``)."""
    for key, value in updater.items():
        if isinstance(value, dict) and isinstance(config.get(key), dict):
            _update_nested(config[key], value)
        else:
            config[key] = value
    return config


def parse_dataset_json(dataset_name: str, config_dir: str = DEFAULT_CONFIG_DIR) -> dict:
    """A dataset registry entry as {dataset, model, trainer} config
    updates."""
    cfg = load_json(os.path.join(config_dir, "dataset.json5"))[dataset_name]
    return {
        "dataset": {
            k: cfg[k]
            for k in ("data_loc", "problem", "use_static", "evaluation_metric", "minimize")
        },
        "model": {"return_sequences": cfg["problem"] == "online"},
        "trainer": {
            "loss_str": cfg["loss_str"],
            "metrics": cfg["metrics"],
            "val_metric_to_monitor": cfg["evaluation_metric"],
        },
        "output_dim": cfg.get("output_dim", 1),
        "label_dtype": cfg.get("label_dtype"),
    }


def set_test_mode(cfg: dict, run_name: Optional[str] = None):
    """Shrink a suite for smoke runs: test-mode data, 10 epochs, 2 trials,
    and a ``test_`` run name."""
    cfg = copy.deepcopy(cfg)
    cfg["test_mode"] = [True]
    if "total_trials" in cfg:
        cfg["total_trials"] = [2]
    cfg.setdefault("trainer", {})
    cfg["trainer"]["max_epochs"] = [10]
    if run_name is not None:
        run_name = f"test_{run_name}"
    return cfg, run_name


def update_hyperparams(configs: List[dict], ledger=None, run_name: str = "hyperopt"):
    """Merge the stored hyperopt best parameters into each config whose
    ``hyperparameters`` mode is ``"load"``, from the ledger's completed
    ``run_name`` entries (the last match wins); a config with none raises
    ``FileNotFoundError``."""
    if ledger is None:
        return configs
    hyperopt_runs = ledger.query(lambda e: e.get("run_name") == run_name
                                 and e.get("status") == "completed"
                                 and "best_parameters" in e.get("info", {}))
    for cfg in configs:
        if cfg.get("hyperparameters") in ("hyperopt", "set"):
            continue
        interpolation = cfg["dataset"].get("interpolation")
        if interpolation in (
            "linear_cubic_smoothing", "linear_quintic_smoothing",
            "linear_forward_fill", "cubic_forward_fill",
        ):
            interpolation = "linear"
        elif interpolation == "hermite":
            # Hermite is the causal cubic; it takes the cubic search's result.
            interpolation = "cubic"
        matches = [
            h for h in hyperopt_runs
            if h["config"]["dataset"].get("interpolation") == interpolation
            and h["config"]["dataset_name"] == cfg["dataset_name"]
            and h["config"]["model"]["model_string"] == cfg["model"]["model_string"]
            and h["config"]["model"].get("adjoint") == cfg["model"].get("adjoint")
        ]
        if not matches:
            raise FileNotFoundError(f"Cannot find hyperopt for config\n{cfg}")
        _update_nested(cfg, matches[-1]["info"]["best_parameters"])
    return configs


def parse_configuration_json(
    run_name: str,
    config_dir: str = DEFAULT_CONFIG_DIR,
    test_mode: bool = False,
    ledger=None,
    hyperopt_run_name: str = "hyperopt",
):
    """A suite name -> (its fully expanded config list, the run name it is
    recorded under)."""
    suites = load_json(os.path.join(config_dir, "configurations.json5"))
    if run_name not in suites:
        raise ValueError(
            f"No configuration suite named {run_name!r}; available: "
            f"{sorted(suites)}"
        )
    cfg = copy.deepcopy(suites[run_name])

    db_name = run_name
    if test_mode:
        cfg, db_name = set_test_mode(cfg, run_name)

    if cfg.get("hyperparameters") not in (["hyperopt"], ["load"], ["set"]):
        raise ValueError(f"suite {run_name!r}: hyperparameters must be one of "
                         f'["hyperopt"], ["load"], ["set"], got {cfg.get("hyperparameters")!r}')

    multi = cfg.pop("multi-config", None)
    if multi:
        configs = []
        for sub in multi.values():
            merged = copy.deepcopy(sub)
            _update_nested(merged, copy.deepcopy(cfg))
            configs.extend(nested_parameter_grid(merged))
    else:
        configs = nested_parameter_grid(cfg)

    for cfg_i in configs:
        _update_nested(cfg_i, parse_dataset_json(cfg_i["dataset_name"], config_dir))
        if cfg_i.get("hyperparameters") == "hyperopt":
            cfg_i["evaluation_metric"] = cfg_i["dataset"]["evaluation_metric"]
            cfg_i["minimize"] = cfg_i["dataset"]["minimize"]

    configs = update_hyperparams(configs, ledger=ledger, run_name=hyperopt_run_name)
    return configs, db_name
