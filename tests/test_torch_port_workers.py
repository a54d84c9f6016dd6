"""Worker functions that tests/test_torch_port_parallel.py spawns as ranks
of a gloo group.  They import torch and the port only, so a spawned rank
starts in seconds (the test module imports JAX).  No tests here."""

import os

import torch
import torch.distributed as dist

from online_neural_cdes_tpu_torch.parallel import mesh as pm


def hyperopt_rank(rank, address, log_dir):
    """One rank of a search over a two-rank mesh whose trials fail on rank
    1 alone, while rank 0 waits in the trial's all-reduce; each rank logs
    the trials it enters."""
    from online_neural_cdes_tpu_torch.training import hyperopt

    dist.init_process_group("gloo", init_method=address, world_size=2, rank=rank)
    try:
        def trial(cfg, **kw):
            with open(os.path.join(log_dir, f"rank{rank}"), "a") as fh:
                fh.write("trial\n")
            if rank == 1:
                raise OSError("planted failure on rank 1")
            dist.all_reduce(torch.ones(1))
            return {"val.loss": 1.0}

        hyperopt.run_experiment = trial
        hyperopt.run_hyperopt(
            {"parameterization": [{"name": "trainer__lr", "type": "range",
                                   "bounds": [1e-3, 1e-1]}],
             "total_trials": 4, "search": "sobol"},
            mesh=pm.make_mesh(2, devices="cpu"), device="cpu")
    finally:
        dist.destroy_process_group()
