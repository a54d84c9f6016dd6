"""Sweep orchestration: expand a config suite, dedup against the ledger,
run every remaining experiment.

PyTorch port's counterpart of the JAX package's ``training/sweep.py``:

- the ledger makes a suite re-entrant: completed configs are skipped,
  half-finished ones purged and retried;
- ``shard_index`` / ``num_shards`` split the config list across hosts
  sharing one ledger file;
- ``co_schedule`` (default): configs that differ only in their seed (a
  final config's seeds) or in the waveable trainer scalars train as one
  wave (``training/wave.py``), at most ``max_wave_size`` configs a wave;
  every member is marked running before its wave and saved on its own
  after it, so dedup and resume behave as on the serial path.  A group
  whose model cannot wave (``WaveUnsupported``: ``scipy_solver``, a
  bfloat16 adaptive step, ROADMAP item 17d) runs its members
  one after another;
- a ``"hyperopt"`` suite runs each config as one search
  (``training/hyperopt.py``), which waves its same-shape candidates;
- ``isolate`` / ``config_timeout_s`` run each unit (a config, a wave or a
  search) in a spawned child process with a wall-clock budget: a crash or
  a hang records a ``failed`` sentinel in the ledger for each of its
  configs and the suite goes on.  The child gets the device in its
  payload, initialises CUDA afresh and loads the kernels the parent
  already built (``build/torch_kernels/``);
- ``mesh`` (``parallel/mesh.py``): every rank of the mesh calls ``run``;
  the first rank reads the ledger and plans the suite, the plan is
  broadcast, each config trains data-parallel over the mesh, one after
  another (a wave is one device's program), and only the first rank
  writes the ledger.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import List, Optional

from online_neural_cdes_tpu_torch.parallel.mesh import check_mesh
from online_neural_cdes_tpu_torch.training.config import (
    DEFAULT_CONFIG_DIR, parse_configuration_json,
)
from online_neural_cdes_tpu_torch.training.experiment import run_experiment
from online_neural_cdes_tpu_torch.training.ledger import Ledger
from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = ["run"]

logger = logging.getLogger(__name__)


class _LedgerReader(Ledger):
    """The ledger as a mesh's other ranks see it: it reads, and leaves the
    writes to the mesh's first rank."""

    def _append(self, entry: dict):
        pass

    def purge_incomplete_runs(self, run_name: Optional[str] = None) -> int:
        return 0


def _run_unit(kind: str, cfgs: List[dict], data_root: str, verbose: bool, device,
              ledger=None, run_name: Optional[str] = None, mesh=None) -> List[dict]:
    """One unit of a suite: a config (``"single"``), a wave of configs
    (``"wave"``) or a search (``"hyperopt"``); one results dict per
    config.  A wave whose model cannot wave (``WaveUnsupported``) runs its
    configs one after another; any other error propagates."""
    if kind == "wave":
        from online_neural_cdes_tpu_torch.training.wave import (
            WaveUnsupported, run_trials_vmapped,
        )

        try:
            return run_trials_vmapped(cfgs, data_root=data_root, verbose=verbose,
                                      device=device)
        except WaveUnsupported as exc:
            logger.warning("wave group rejected (%s); running its members one after "
                           "another", exc)
            return [run_experiment(cfg, data_root=data_root, verbose=verbose, device=device)
                    for cfg in cfgs]
    if kind == "hyperopt":
        from online_neural_cdes_tpu_torch.training.hyperopt import run_hyperopt

        return [run_hyperopt(cfgs[0], data_root=data_root, mesh=mesh, verbose=verbose,
                             ledger=ledger, run_name=run_name, device=device)]
    return [run_experiment(cfgs[0], data_root=data_root, mesh=mesh, verbose=verbose,
                           device=device)]


def _subprocess_worker(payload_path: str, result_path: str):
    """Child entry for isolation mode: run one unit on the payload's device
    and write its results as JSON.  It runs in a SPAWNED interpreter, so a
    segfault, an out-of-memory kill or a hang dies here, not in the sweep;
    an exception gives a nonzero exit code and the parent records the
    failure."""
    with open(payload_path) as fh:
        payload = json.load(fh)
    ledger = Ledger(payload["ledger_path"]) if payload["kind"] == "hyperopt" else None
    results = _run_unit(payload["kind"], payload["cfgs"], payload["data_root"],
                        payload["verbose"], payload["device"], ledger=ledger,
                        run_name=payload["run_db_name"])
    tmp = result_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump([_jsonable_results(r) for r in results], fh)
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


def _run_isolated(kind: str, cfgs: List[dict], data_root: str, verbose: bool,
                  timeout_s: Optional[float], device: str, ledger_path: str,
                  run_db_name: str) -> List[dict]:
    """Run one unit in a spawned child with a wall-clock budget.  Raises
    TimeoutError when the budget runs out (the child is killed) and
    RuntimeError when the child dies; the caller records either as a
    ledger failure of each of the unit's configs and goes on."""
    import multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="oncde_sweep_") as tmpdir:
        payload_path = os.path.join(tmpdir, "payload.json")
        result_path = os.path.join(tmpdir, "results.json")
        with open(payload_path, "w") as fh:
            json.dump({"kind": kind, "cfgs": cfgs, "data_root": data_root,
                       "verbose": verbose, "device": device, "ledger_path": ledger_path,
                       "run_db_name": run_db_name}, fh, default=str)
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
            raise TimeoutError(f"config unit exceeded config_timeout_s={timeout_s}")
        if proc.exitcode != 0 or not os.path.exists(result_path):
            raise RuntimeError(f"config unit subprocess died (exit code {proc.exitcode})")
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

    ``co_schedule``: same-shape configs (identical except ``seed`` and the
    waveable trainer scalars, ``wave.config_wave_groups``) train as waves
    of at most ``max_wave_size`` lanes.  ``isolate`` / ``config_timeout_s``
    (which implies ``isolate``): each unit in a spawned child with a
    wall-clock budget; its results come back as plain JSON numbers without
    ``best_params``.  ``mesh``: every rank of the mesh calls ``run`` with
    the same arguments (the module docstring); isolation cannot cross the
    process group and is refused with it."""
    if config_timeout_s is not None:
        isolate = True
    if mesh is not None:
        check_mesh(mesh)
        if isolate:
            raise ValueError(
                "isolate/config_timeout_s runs configs in subprocesses, which cannot "
                "share an in-process mesh; use num_shards for multi-host parallelism or "
                "drop isolation")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"sweep.run(device={device!r}): this rank's mesh device is "
                             f"{mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    writer = mesh is None or mesh.coords == {axis: 0 for axis in mesh.axis_names}

    ledger = Ledger(ledger_path) if writer else _LedgerReader(ledger_path)
    plan = None
    if writer:
        configs, db_name = parse_configuration_json(
            run_name,
            config_dir=config_dir or DEFAULT_CONFIG_DIR,
            test_mode=test_mode,
            ledger=ledger,
        )
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
        plan = (configs, db_name, todo)
    if mesh is not None:
        # The first rank's plan on every rank: the ledger changes while the
        # first rank writes it, and every rank must train the same configs.
        import torch.distributed as dist

        box = [plan]
        dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group)
        plan = box[0]
    configs, db_name, todo = plan
    hyperopt_suite = bool(configs and configs[0].get("hyperparameters") == "hyperopt")

    # Units: waves of co-trainable configs, or single configs.  A hyperopt
    # config is a whole search (which waves its own candidates), so it is
    # always a unit of its own.  Over a mesh each config trains sharded,
    # one after another: a wave is one device's program.
    if mesh is not None and co_schedule:
        logger.info("mesh given: running configs one after another over the mesh "
                    "(a wave trains on one device)")
        co_schedule = False
    if co_schedule and not hyperopt_suite and len(todo) > 1:
        from online_neural_cdes_tpu_torch.training.wave import config_wave_groups

        cap = max(1, int(max_wave_size))
        groups = [[todo[j] for j in g[k:k + cap]]
                  for g in config_wave_groups([configs[i] for i in todo])
                  for k in range(0, len(g), cap)]
    else:
        groups = [[i] for i in todo]

    completed = []
    for idxs in groups:
        group_cfgs = [configs[i] for i in idxs]
        for i in idxs:
            ledger.mark_running(configs[i], run_name=db_name)
        if len(idxs) > 1:
            kind = "wave"
            logger.info("training %d same-shape configs as one wave: %s", len(idxs),
                        [i + 1 for i in idxs])
        else:
            kind = "hyperopt" if hyperopt_suite else "single"
            logger.info("running config %d/%d", idxs[0] + 1, len(configs))
        if isolate:
            try:
                results_list = _run_isolated(kind, group_cfgs, data_root, verbose,
                                             config_timeout_s, str(device), ledger_path,
                                             db_name)
            except (TimeoutError, RuntimeError) as exc:
                for i in idxs:
                    logger.error("config %d/%d failed: %s", i + 1, len(configs), exc)
                    ledger.mark_failed(configs[i], run_name=db_name, error=str(exc))
                continue
        else:
            results_list = _run_unit(kind, group_cfgs, data_root, verbose, device,
                                     ledger=ledger, run_name=db_name, mesh=mesh)
        for cfg, results in zip(group_cfgs, results_list):
            info = {}
            if "best_parameters" in results:
                info["best_parameters"] = results.pop("best_parameters")
            ledger.save_result(cfg, results, run_name=db_name, info=info)
            completed.append((cfg, results))
    return completed

