"""Configuration suites: the JSON5 sweep suites, nested grid expansion,
the per-dataset option merge, stored hyperopt results, test-mode shrinkage.

PyTorch port's counterpart of the JAX package's ``training/config.py``,
with the same functions and the same results.  The suites and the dataset
registry are the port's own copies (``configurations/*.json5``), read by
the port's own JSON5 reader (``loads_json5``, ``load_json``): the machines
the port runs on need not have the ``json5`` package.
"""

from __future__ import annotations

import copy
import itertools
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


# White space of the JSON5 grammar (ECMAScript's WhiteSpace and
# LineTerminator): the JSON set, vertical tab, form feed, NBSP, BOM, the
# line and paragraph separators and every other Unicode space separator.
_SPACE = frozenset(" \t\n\r\v\f\u00a0\ufeff\u1680\u2000\u2001\u2002\u2003\u2004"
                   "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
_ESCAPES = {"b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t", "v": "\v", "0": "\0"}
_LINE_ENDS = ("\r\n", "\n", "\r", "\u2028", "\u2029")


class _Json5Reader:
    """A recursive-descent reader of JSON5 (https://spec.json5.org), the
    grammar ``json5.loads`` reads: ``//`` and ``/* */`` comments, trailing
    commas, unquoted (identifier) keys, single- and double-quoted strings
    with JSON5's escapes and line continuations, and numbers with a leading
    ``+``, a leading or trailing ``.``, hexadecimal ``0x``, ``Infinity`` and
    ``NaN``.  Integers and hexadecimals read as ``int``, the rest as
    ``float``; a repeated key keeps its last value.  Anything else raises
    ``ValueError`` with its offset."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def fail(self, what: str):
        raise ValueError(f"{what} at offset {self.i} of the JSON5 text")

    def blank(self):
        text, n = self.text, len(self.text)
        while self.i < n:
            if text[self.i] in _SPACE:
                self.i += 1
            elif text.startswith("//", self.i):
                ends = [j for j in (text.find(e, self.i) for e in _LINE_ENDS) if j >= 0]
                self.i = min(ends) if ends else n
            elif text.startswith("/*", self.i):
                end = text.find("*/", self.i + 2)
                if end < 0:
                    self.fail("unterminated block comment")
                self.i = end + 2
            else:
                return

    def peek(self) -> str:
        return self.text[self.i] if self.i < len(self.text) else ""

    def value(self):
        self.blank()
        ch = self.peek()
        if ch == "{":
            return self.obj()
        if ch == "[":
            return self.array()
        if ch in "\"'":
            return self.string()
        for word, val in (("null", None), ("true", True), ("false", False)):
            if self.text.startswith(word, self.i) and not self._ident_char(self.i + len(word)):
                self.i += len(word)
                return val
        if ch and (ch in "+-.0123456789" or self.text.startswith(("Infinity", "NaN"), self.i)):
            return self.number()
        self.fail("unexpected character" if ch else "unexpected end")

    def _ident_char(self, j: int) -> bool:
        return j < len(self.text) and (self.text[j].isalnum() or self.text[j] in "_$")

    def obj(self) -> dict:
        out = {}
        self.i += 1
        while True:
            self.blank()
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.string() if self.peek() in "\"'" else self.identifier()
            self.blank()
            if self.peek() != ":":
                self.fail("expected ':'")
            self.i += 1
            out[key] = self.value()
            self.blank()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                self.fail("expected ',' or '}'")

    def array(self) -> list:
        out = []
        self.i += 1
        while True:
            self.blank()
            if self.peek() == "]":
                self.i += 1
                return out
            out.append(self.value())
            self.blank()
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                self.fail("expected ',' or ']'")

    def identifier(self) -> str:
        """An ECMAScript IdentifierName, ``\\uXXXX`` escapes included."""
        chars = []
        while self.i < len(self.text):
            ch = self.text[self.i]
            if ch == "\\":
                if not self.text.startswith("\\u", self.i):
                    self.fail("bad escape in a key")
                chars.append(self._hex(self.i + 2, 4))
                self.i += 6
            elif ch in "_$" or ch.isalpha() or (chars and (ch.isalnum()
                                                            or ch in "\u200c\u200d")):
                chars.append(ch)
                self.i += 1
            else:
                break
        if not chars or chars[0].isdigit():
            self.fail("expected a key")
        return "".join(chars)

    def _hex(self, j: int, width: int) -> str:
        digits = self.text[j:j + width]
        if len(digits) != width or any(c not in "0123456789abcdefABCDEF" for c in digits):
            self.i = j
            self.fail("bad hexadecimal escape")
        return chr(int(digits, 16))

    def string(self) -> str:
        quote = self.text[self.i]
        self.i += 1
        chars = []
        while True:
            if self.i >= len(self.text):
                self.fail("unterminated string")
            ch = self.text[self.i]
            if ch == quote:
                self.i += 1
                return "".join(chars)
            if ch in "\n\r":
                self.fail("unterminated string")
            if ch != "\\":
                chars.append(ch)
                self.i += 1
                continue
            nxt = self.text[self.i + 1:self.i + 2]
            line_end = next((e for e in _LINE_ENDS if self.text.startswith(e, self.i + 1)),
                            None)
            if line_end is not None:                  # a line continuation
                self.i += 1 + len(line_end)
            elif nxt == "x":
                chars.append(self._hex(self.i + 2, 2))
                self.i += 4
            elif nxt == "u":
                chars.append(self._hex(self.i + 2, 4))
                self.i += 6
            elif nxt in _ESCAPES and not (nxt == "0" and self.text[self.i + 2:self.i + 3]
                                          .isdigit()):
                chars.append(_ESCAPES[nxt])
                self.i += 2
            elif nxt == "" or nxt.isdigit():
                self.fail("bad escape")
            else:
                chars.append(nxt)
                self.i += 2

    def number(self):
        text, start = self.text, self.i
        sign = 1
        if text[self.i] in "+-":
            sign = -1 if text[self.i] == "-" else 1
            self.i += 1
        for word, val in (("Infinity", float("inf")), ("NaN", float("nan"))):
            if text.startswith(word, self.i):
                self.i += len(word)
                return sign * val
        if text.startswith(("0x", "0X"), self.i):
            j = self.i + 2
            while j < len(text) and text[j] in "0123456789abcdefABCDEF":
                j += 1
            if j == self.i + 2:
                self.fail("bad hexadecimal number")
            value = int(text[self.i + 2:j], 16)
            self.i = j
            return sign * value
        j = self.i
        while j < len(text) and text[j].isdigit():
            j += 1
        int_digits = text[self.i:j]
        if len(int_digits) > 1 and int_digits[0] == "0":
            self.fail("a leading zero")
        is_float = False
        if j < len(text) and text[j] == ".":
            is_float = True
            j += 1
            frac_start = j
            while j < len(text) and text[j].isdigit():
                j += 1
            if not int_digits and j == frac_start:
                self.fail("bad number")
        elif not int_digits:
            self.fail("bad number")
        if j < len(text) and text[j] in "eE":
            is_float = True
            j += 1
            if j < len(text) and text[j] in "+-":
                j += 1
            exp_start = j
            while j < len(text) and text[j].isdigit():
                j += 1
            if j == exp_start:
                self.i = j
                self.fail("bad exponent")
        literal = text[start:j]
        self.i = j
        return float(literal) if is_float else int(literal)


def loads_json5(text: str):
    """Parse JSON5 text (the grammar of ``json5.loads``, see
    :class:`_Json5Reader`); anything that is not JSON5 raises
    ``ValueError``."""
    reader = _Json5Reader(text)
    value = reader.value()
    reader.blank()
    if reader.i != len(text):
        reader.fail("extra data")
    return value


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
