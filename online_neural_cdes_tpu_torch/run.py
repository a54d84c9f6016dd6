"""Command-line sweep runner.

PyTorch port's counterpart of the JAX package's ``run.py``: a suite runs
re-entrantly against the local ledger, on the CUDA card unless ``--device
cpu`` is asked for; ``--shard`` / ``--num-shards`` split its configs
across hosts.

    python -m online_neural_cdes_tpu_torch.data.builders toy --root data/processed
    python -m online_neural_cdes_tpu_torch.run toy --device cpu --data-root data/processed
    python -m online_neural_cdes_tpu_torch.run medical-sota --data-root data/processed
    python -m online_neural_cdes_tpu_torch.run medical-sota --analyse --tables-out results/tables

A suite's same-shape configs (a final config's seeds) train as waves
(``training/wave.py``); a ``"hyperopt"`` suite runs its searches
(``training/hyperopt.py``).  ``--analyse`` prints the seed-averaged metric
and NFE tables of the ledger instead of running, and ``--tables-out DIR``
writes the paper's ``.tex`` tables (``training/analyse.py``).
``--data-parallel N`` trains each config over N processes, one a device,
joined by ``torch.distributed`` (``parallel/mesh.py``): the command starts
the N workers itself (``torch.multiprocessing``, spawned), worker ``r`` on
``cuda:r`` over NCCL, or with ``--device cpu`` on the CPU over gloo.
Only worker 0 writes the ledger and the checkpoints; a failed worker fails
the command.  Called inside a process group of N ranks that the caller
built, ``main`` runs this rank's part in it instead of starting workers,
over that group's backend (a gloo group may hold several ranks of one
card: rank ``r`` takes ``cuda:r % cards``).

    python -m online_neural_cdes_tpu_torch.run toy --data-parallel 2 --device cpu \
        --data-root data/processed
"""

from __future__ import annotations

import argparse
import logging
import socket


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_name", help="suite name from configurations.json5")
    ap.add_argument("--data-root", default="data/processed")
    ap.add_argument("--ledger", default="results/ledger.jsonl")
    ap.add_argument("--config-dir", default=None)
    ap.add_argument("--test-mode", action="store_true")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--data-parallel", type=int, default=0, metavar="N",
                    help="train each config data-parallel over N worker processes, "
                         "one a device (0: one process, no process group)")
    ap.add_argument("--analyse", action="store_true",
                    help="print seed-averaged tables instead of running")
    ap.add_argument("--tables-out", default=None, metavar="DIR",
                    help="with --analyse: also write the full reference table set "
                         "(sparsity/gating/medical-sota/interpolation .tex) under DIR")
    ap.add_argument("--device", default=None,
                    help="where to train: the CUDA card by default, or 'cpu'")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.analyse:
        from online_neural_cdes_tpu_torch.training.analyse import (
            metric_table, nfe_table, write_analysis_tables,
        )
        from online_neural_cdes_tpu_torch.training.ledger import Ledger

        # A test-mode sweep records under the prefixed run name.
        name = f"test_{args.run_name}" if args.test_mode else args.run_name
        ledger = Ledger(args.ledger)
        print(metric_table(ledger, name))
        print(nfe_table(ledger, name))
        if args.tables_out:
            for path in write_analysis_tables(ledger, args.tables_out, name):
                print(f"wrote {path}")
        return None
    logging.basicConfig(level=logging.INFO)
    if args.data_parallel > 0:
        import torch.distributed as dist

        if not dist.is_initialized():
            return _spawn_workers(args)
        if dist.get_world_size() != args.data_parallel:
            raise ValueError(f"--data-parallel {args.data_parallel} inside a process group "
                             f"of {dist.get_world_size()} ranks")
    return _run_suite(args)


def _run_suite(args):
    """The suite on this process: over a mesh of ``--data-parallel`` ranks
    of the current process group, or alone."""
    from online_neural_cdes_tpu_torch.training.sweep import run

    mesh = None
    if args.data_parallel > 0:
        from online_neural_cdes_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.data_parallel, devices=_worker_devices(args))
    completed = run(
        args.run_name,
        ledger_path=args.ledger,
        data_root=args.data_root,
        config_dir=args.config_dir,
        test_mode=args.test_mode,
        shard_index=args.shard,
        num_shards=args.num_shards,
        mesh=mesh,
        verbose=args.verbose,
        device=None if mesh is not None else args.device,
    )
    if mesh is None or mesh.coords["data"] == 0:
        print(f"completed {len(completed)} configs")
    return completed


def _backend(args) -> str:
    """The process group's own backend when the caller built one, else gloo
    on the CPU and NCCL between cards."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    return "gloo" if args.device == "cpu" else "nccl"


def _worker_devices(args):
    """Every rank's device: the CPU with ``--device cpu``, else ``cuda:r``
    (``cuda:r % cards`` in a gloo group the caller built)."""
    import torch

    n = args.data_parallel
    if args.device == "cpu":
        return ["cpu"] * n
    if not torch.cuda.is_available():
        raise RuntimeError("--data-parallel needs CUDA cards, or --device cpu")
    cards = torch.cuda.device_count()
    if _backend(args) == "nccl" and n > cards:
        raise ValueError(f"--data-parallel {n} over NCCL needs {n} cards, {cards} visible "
                         "(NCCL refuses two ranks on one card)")
    return [f"cuda:{r % cards}" for r in range(n)]


def _worker(rank: int, args, address: str):
    """One worker: joins the process group, takes its device and runs its
    part of the suite."""
    import torch
    import torch.distributed as dist

    device = _worker_devices(args)[rank]
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(args), init_method=address,
                            world_size=args.data_parallel, rank=rank)
    try:
        _run_suite(args)
    finally:
        dist.destroy_process_group()


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _spawn_workers(args):
    """Start ``--data-parallel`` workers and wait for them all; any worker's
    failure raises (the others are stopped), so the command exits nonzero."""
    import torch.multiprocessing as tmp

    _worker_devices(args)   # refuse a layout the backend cannot take, before starting
    tmp.spawn(_worker, args=(args, _free_address()), nprocs=args.data_parallel, join=True)
    print(f"{args.data_parallel} workers finished")
    return None


if __name__ == "__main__":
    main()
