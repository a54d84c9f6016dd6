"""Command-line sweep runner.

PyTorch port's counterpart of the JAX package's ``run.py``: a suite runs
re-entrantly against the local ledger, on the CUDA card unless ``--device
cpu`` is asked for; ``--shard`` / ``--num-shards`` split its configs
across hosts.

    python -m online_neural_cdes_tpu_torch.data.builders toy --root data/processed
    python -m online_neural_cdes_tpu_torch.run toy --device cpu --data-root data/processed
    python -m online_neural_cdes_tpu_torch.run medical-sota --data-root data/processed

``--analyse`` and ``--tables-out`` are ROADMAP item 17b and
``--data-parallel`` item 18: they raise.
"""

from __future__ import annotations

import argparse
import logging


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
                    help="train each config over N cards (ROADMAP item 18; "
                         "only 0, one card, runs)")
    ap.add_argument("--analyse", action="store_true",
                    help="print seed-averaged tables instead of running "
                         "(ROADMAP item 17b)")
    ap.add_argument("--tables-out", default=None, metavar="DIR",
                    help="with --analyse: write the reference's .tex tables "
                         "under DIR (ROADMAP item 17b)")
    ap.add_argument("--device", default=None,
                    help="where to train: the CUDA card by default, or 'cpu'")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.analyse or args.tables_out is not None:
        raise NotImplementedError(
            "--analyse / --tables-out are not ported yet (ROADMAP item 17b: "
            "training/analyse.py in numpy); the JAX package's "
            "run --analyse reads the same ledger")
    if args.data_parallel > 0:
        raise NotImplementedError(
            f"--data-parallel {args.data_parallel} is not ported yet (ROADMAP item "
            "18: parallel/ as torch.distributed data parallel)")

    logging.basicConfig(level=logging.INFO)

    from online_neural_cdes_tpu_torch.training.sweep import run

    completed = run(
        args.run_name,
        ledger_path=args.ledger,
        data_root=args.data_root,
        config_dir=args.config_dir,
        test_mode=args.test_mode,
        shard_index=args.shard,
        num_shards=args.num_shards,
        verbose=args.verbose,
        device=args.device,
    )
    print(f"completed {len(completed)} configs")
    return completed


if __name__ == "__main__":
    main()
