"""Sweep orchestration: expand a config suite, dedup against the ledger,
run every remaining experiment.

PyTorch port's counterpart of the JAX package's ``training/sweep.py``:

- the ledger makes a suite re-entrant: completed configs are skipped,
  half-finished ones purged and retried;
- ``shard_index`` / ``num_shards`` split the config list across hosts
  sharing one ledger file;
- ``isolate`` / ``config_timeout_s`` run each config in a spawned child
  process with a wall-clock budget: a crash or a hang records a ``failed``
  sentinel in the ledger and the suite goes on.  The child gets the
  device in its payload, initialises CUDA afresh and loads the kernels
  the parent already built (``build/torch_kernels/``).

Configs that differ only in their seed (a final config's seeds) are one
wave group of the JAX sweep, trained as one vmapped program.  Here every
config runs on its own, one after another, with the results the JAX wave
contract holds each lane to (its sequential run); stacked K-replica waves
are ROADMAP item 17b, and ``co_schedule`` / ``max_wave_size`` keep their
names for them.  Hyperopt suites are item 17b too and raise.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import List, Optional

from online_neural_cdes_tpu_torch.training.config import (
    DEFAULT_CONFIG_DIR, parse_configuration_json,
)
from online_neural_cdes_tpu_torch.training.experiment import run_experiment
from online_neural_cdes_tpu_torch.training.ledger import Ledger
from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = ["run"]

logger = logging.getLogger(__name__)


def _subprocess_worker(payload_path: str, result_path: str):
    """Child entry for isolation mode: run one config on the payload's
    device and write its results as JSON.  It runs in a SPAWNED
    interpreter, so a segfault, an out-of-memory kill or a hang dies here,
    not in the sweep; an exception gives a nonzero exit code and the
    parent records the failure."""
    with open(payload_path) as fh:
        payload = json.load(fh)
    results = run_experiment(payload["cfg"], data_root=payload["data_root"],
                             verbose=payload["verbose"], device=payload["device"])
    tmp = result_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump([_jsonable_results(results)], fh)
    os.replace(tmp, result_path)


def _jsonable_results(results: dict) -> dict:
    """Results crossing the process boundary: without the in-memory
    ``best_params`` (the ledger drops them too; weights persist through
    ``trainer.checkpoint_dir``), numpy and torch scalars as plain Python
    numbers."""
    import numpy as np

    def conv(v):
        if hasattr(v, "dtype") and hasattr(v, "shape"):  # numpy array or tensor
            a = np.asarray(v.cpu() if hasattr(v, "cpu") else v)
            return a.item() if a.ndim == 0 else a.tolist()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v

    return conv({k: v for k, v in results.items() if k != "best_params"})


def _run_isolated(cfg: dict, data_root: str, verbose: bool, timeout_s: Optional[float],
                  device: str) -> List[dict]:
    """Run one config in a spawned child with a wall-clock budget.  Raises
    TimeoutError when the budget runs out (the child is killed) and
    RuntimeError when the child dies; the caller records either as a
    ledger failure and goes on."""
    import multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="oncde_sweep_") as tmpdir:
        payload_path = os.path.join(tmpdir, "payload.json")
        result_path = os.path.join(tmpdir, "results.json")
        with open(payload_path, "w") as fh:
            json.dump({"cfg": cfg, "data_root": data_root, "verbose": verbose,
                       "device": device}, fh, default=str)
        # spawn, not fork: a forked child of a process holding a CUDA
        # context cannot use the card.
        proc = mp.get_context("spawn").Process(
            target=_subprocess_worker, args=(payload_path, result_path))
        proc.start()
        proc.join(timeout_s)
        if proc.is_alive():
            proc.terminate()
            proc.join(5.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
            raise TimeoutError(f"config exceeded config_timeout_s={timeout_s}")
        if proc.exitcode != 0 or not os.path.exists(result_path):
            raise RuntimeError(f"config subprocess died (exit code {proc.exitcode})")
        with open(result_path) as fh:
            return json.load(fh)


def run(
    run_name: str,
    ledger_path: str = "results/ledger.jsonl",
    data_root: str = "data/processed",
    config_dir: Optional[str] = None,
    test_mode: bool = False,
    shard_index: int = 0,
    num_shards: int = 1,
    mesh=None,
    verbose: bool = False,
    co_schedule: bool = True,
    isolate: bool = False,
    config_timeout_s: Optional[float] = None,
    max_wave_size: int = 4,
    device=None,
) -> list:
    """Run a configuration suite on ``device`` (the CUDA card unless
    ``"cpu"`` is asked for); returns [(config, results), ...] of the
    configs this call completed.

    ``isolate`` / ``config_timeout_s`` (which implies ``isolate``): each
    config in a spawned child with a wall-clock budget; its results come
    back as plain JSON numbers without ``best_params``.  ``co_schedule``
    and ``max_wave_size`` are kept for the JAX package's signature and
    change nothing: configs run one after another in this port, and the
    stacked K-replica waves they select are ROADMAP item 17b.  ``mesh=`` is
    item 18 and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "sweep.run(mesh=...) is not ported yet (ROADMAP item 18: parallel/ "
            "as torch.distributed data parallel)")
    if config_timeout_s is not None:
        isolate = True
    device = resolve_device(device)

    ledger = Ledger(ledger_path)
    configs, db_name = parse_configuration_json(
        run_name,
        config_dir=config_dir or DEFAULT_CONFIG_DIR,
        test_mode=test_mode,
        ledger=ledger,
    )
    if configs and configs[0].get("hyperparameters") == "hyperopt":
        raise NotImplementedError(
            f"suite {run_name!r} is a hyperparameter search: hyperopt is not ported "
            "yet (ROADMAP item 17b); run it with the JAX package's "
            "run CLI, whose ledger this port reads")
    ledger.purge_incomplete_runs(run_name=db_name)

    # This host's still-to-run slice, in suite order.
    todo: List[int] = []
    for i, cfg in enumerate(configs):
        if i % num_shards != shard_index:
            continue
        if ledger.check_if_run(cfg, run_name=db_name):
            logger.info("skipping completed config %d/%d", i + 1, len(configs))
            continue
        todo.append(i)
    if co_schedule and len(todo) > 1:
        logger.info(
            "co_schedule (max_wave_size=%d): %d configs run one after another; "
            "stacked K-replica waves of same-shape configs are ROADMAP item 17b",
            max_wave_size, len(todo))

    completed = []
    for i in todo:
        cfg = configs[i]
        ledger.mark_running(cfg, run_name=db_name)
        logger.info("running config %d/%d", i + 1, len(configs))
        if isolate:
            try:
                (results,) = _run_isolated(cfg, data_root, verbose, config_timeout_s,
                                           str(device))
            except (TimeoutError, RuntimeError) as exc:
                logger.error("config %d/%d failed: %s", i + 1, len(configs), exc)
                ledger.mark_failed(cfg, run_name=db_name, error=str(exc))
                continue
        else:
            results = run_experiment(cfg, data_root=data_root, verbose=verbose,
                                     device=device)
        ledger.save_result(cfg, results, run_name=db_name)
        completed.append((cfg, results))
    return completed
