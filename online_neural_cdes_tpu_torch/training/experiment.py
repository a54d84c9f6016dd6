"""Single-experiment entry point: config -> load data -> model -> train.

PyTorch port's counterpart of the JAX package's ``training/experiment.py``:
one function over a nested config dict, shared by the sweep runner and the
tests.  ``device`` is where the model trains (the CUDA card unless
``"cpu"`` is asked for); with ``mesh=`` (data parallelism) it is this
rank's mesh device.
"""

from __future__ import annotations

import os

from online_neural_cdes_tpu_torch.data.loader import load_numpy_data
from online_neural_cdes_tpu_torch.training.harness import setup_model, train

__all__ = ["run_experiment", "load_and_setup", "npz_path_for"]

DEFAULT_DATA_ROOT = os.environ.get("ONCDE_DATA_ROOT", "data/processed")


def npz_path_for(data_loc: str, data_root: str = DEFAULT_DATA_ROOT,
                 test_mode: bool = False) -> str:
    name = "improved-neural-cdes_data{}.npz".format("_test" if test_mode else "")
    return os.path.join(data_root, data_loc, name)


def load_and_setup(config: dict, data_root: str = DEFAULT_DATA_ROOT, device=None):
    """The config -> (bundle, [train, val, test]) half of
    :func:`run_experiment`, so a served model is rebuilt by the code path
    that trained it."""
    ds = dict(config.get("dataset", {}))
    model_cfg = dict(config.get("model", {}))
    test_mode = bool(config.get("test_mode", False))

    interpolation = ds.get("interpolation")
    path = npz_path_for(ds["data_loc"], data_root, test_mode)
    splits = load_numpy_data(
        path,
        interpolation,
        use_static=ds.get("use_static", True),
        problem=ds.get("problem"),
        output_dim=config.get("output_dim", 1),
        label_dtype=config.get("label_dtype"),
        device=device,
    )
    train_data = splits[0]

    model_string = model_cfg.pop("model_string", "ncde")
    bundle = setup_model(
        model_string,
        input_dim=train_data.input_dim,
        output_dim=train_data.output_dim,
        static_dim=train_data.static_dim,
        interpolation=train_data.model_interpolation or "linear",
        return_sequences=train_data.return_sequences,
        train_data=train_data,
        device=device,
        **{k: v for k, v in model_cfg.items() if k in (
            "hidden_dim", "hidden_hidden_dim", "num_layers", "vector_field",
            "vector_field_type", "interpolation_eps", "sparsity", "adjoint",
            "adjoint_method", "solver",
        )},
    )
    return bundle, splits


def run_experiment(config: dict, data_root: str = DEFAULT_DATA_ROOT,
                   mesh=None, verbose: bool = False, device=None) -> dict:
    """Train one config; the layout is the JAX package's:

    {
      "dataset_name": str, "seed": int, "test_mode": bool,
      "dataset": {"data_loc", "problem", "use_static", "interpolation",
                   "batch_size", ...},
      "model":   {"model_string", "hidden_dim", "hidden_hidden_dim",
                   "num_layers", "vector_field", "vector_field_type",
                   "interpolation_eps", "sparsity", "adjoint", "solver",
                   "return_sequences"},
      "trainer": {"loss_str", "metrics", "val_metric_to_monitor", "lr",
                   "max_epochs", "compute_dtype", ...},
    }
    """
    ds = dict(config.get("dataset", {}))
    trainer_cfg = dict(config.get("trainer", {}))
    if mesh is not None and device is None:
        device = mesh.device

    bundle, (train_data, val_data, test_data) = load_and_setup(config, data_root, device)

    return train(
        bundle,
        train_data,
        val_data,
        test_data,
        loss_str=trainer_cfg.get("loss_str", "bce"),
        metrics=tuple(trainer_cfg.get("metrics", ("loss",))),
        val_metric_to_monitor=trainer_cfg.get("val_metric_to_monitor", "loss"),
        minimize=ds.get("minimize"),
        lr=trainer_cfg.get("lr", 5e-3),
        final_lr_multiplier=trainer_cfg.get("final_lr_multiplier", 10.0),
        max_epochs=trainer_cfg.get("max_epochs", 1000),
        batch_size=ds.get("batch_size", 1024),
        plateau_patience=trainer_cfg.get("plateau_patience", 15),
        plateau_factor=trainer_cfg.get("plateau_factor", 0.1),
        early_stop_patience=trainer_cfg.get("early_stop_patience", 60),
        seed=config.get("seed", 0),
        mesh=mesh,
        verbose=verbose,
        checkpoint_dir=trainer_cfg.get("checkpoint_dir"),
        checkpoint_every=trainer_cfg.get("checkpoint_every", 0),
        resume=trainer_cfg.get("resume", False),
        prefetch=trainer_cfg.get("prefetch") or 0,
        profile_dir=trainer_cfg.get("profile_dir"),
        compute_dtype=trainer_cfg.get("compute_dtype"),
        epoch_fused=trainer_cfg.get("epoch_fused", False),
        accum_steps=trainer_cfg.get("accum_steps"),
    )
