from online_neural_cdes_tpu_torch.training import (  # noqa: F401
    config,
    experiment,
    harness,
    ledger,
    loop,
    metrics,
    sweep,
)
