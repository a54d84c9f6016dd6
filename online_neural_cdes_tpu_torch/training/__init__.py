from online_neural_cdes_tpu_torch.training import (  # noqa: F401
    analyse,
    config,
    experiment,
    harness,
    hyperopt,
    ledger,
    loop,
    metrics,
    sweep,
    wave,
)
