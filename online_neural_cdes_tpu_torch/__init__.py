"""online_neural_cdes_tpu_torch -- the PyTorch/CUDA port of
``online_neural_cdes_tpu``.

The port mirrors the JAX package's module paths and public names and runs
on an NVIDIA Hopper card: plain tensor code is PyTorch, and the TPU's
Pallas kernels become hand-written CUDA kernels (``csrc/``), built at
first use.  It imports neither JAX nor the JAX package.

Ported so far: serving and training of an NCDE with a
fixed-grid solver under every interpolation scheme of the JAX package
(linear, rectilinear, natural cubic, Hermite, smoothed linear) -- the
coefficient builders and splines, the fused vector field with its forward
and backward Hopper kernels, the fixed-grid piece scan and its interval
adjoint, ``NeuralCDE``, ``Predictor``, ``OnlineNCDEStepper``, the
NaN-masked losses and the Adam train steps (``training``), and the
Brownian-motion toy (``data.toy``, ``experiments.sim_bm_toy``) -- and the
whole-interval RK4 kernels (``ops.kernels.fused_rk4_interval`` and its
K-replica form) with their interval-chain experiments
(``experiments.pair_probe``, ``experiments.interleave_experiment``); and
the adaptive Runge-Kutta solvers (``ops.solvers.odeint``,
``ops.cdeint.odeint_adjoint``, the generic ``cdeint`` path), so a
``NeuralCDE(solver="dopri5")`` serves and trains too; and the model zoo:
every vector field kind and type (``models.vector_fields``), the stacked
and attention NCDEs, ODE-RNN, GRU-D and the GRU/RNN baselines
(``models``), so every model of the JAX harness's registry builds, trains
and serves; and the rest of the solvers (the Adams methods,
``scipy_solver``, ``odeint_event`` / ``combine_event_functions``, bf16
states), the log-ODE transform (``ops.logsig``,
``data.loader.apply_logsig_transform``) and the rank and threshold
metrics without scikit-learn (``training.metrics``); and checkpoints
and profiling (``utils.checkpoint``, ``utils.profiling``), the data
pipeline's preprocessing, loading, batching and prefetching
(``data.common``, ``data.native``, ``data.loader``, ``data.prefetch``)
and the MIMIC-IV task preparation (``data.mimic``); and the training
harness's core: the configuration suites, the run ledger, ``setup_model``
and ``train``, the experiment and sweep runners and their command line
(``training.config``, ``.ledger``, ``.harness``, ``.experiment``,
``.sweep``, ``run``), the toy dataset builder (``data.builders``) and
``serving.predictor_from_bundle``; waves, hyperopt and analysis
(``training.wave``, ``.hyperopt``, ``.analyse``); and the raw-archive
builders (``data.ts_format``, ``.download``, ``.audio``, ``.mimic_raw``,
``.builders``) and data parallelism with seed ensembles over
``torch.distributed`` (``parallel.mesh``, ``parallel.ensemble``, ``mesh=``
on the steps, ``train``, the sweep, ``Predictor`` and the stepper); and
the exported serving artifact (``serving_export``: a predictor's bucket
grid or a stepper written with ``torch.export``, served with no model
code) and the checkpoint-to-artifact command line (``deploy``).
``ROADMAP.md`` lists what comes next.

The names below are imported at first use, so a process that serves an
exported artifact imports the op library and the servers, never a model
class.
"""

__version__ = "0.1.0"

import importlib

_EXPORTS = {
    "online_neural_cdes_tpu_torch.ops.cdeint": ("cdeint",),
    "online_neural_cdes_tpu_torch.ops.interpolation": (
        "CubicSpline", "LinearInterpolation", "NaturalCubicSpline",
        "SmoothLinearInterpolation", "TupleControl",
        "hermite_cubic_coefficients_with_backward_differences",
        "linear_interpolation_coeffs", "natural_cubic_coeffs",
        "natural_cubic_spline_coeffs", "prepare_rectilinear_interpolation"),
    "online_neural_cdes_tpu_torch.models": (
        "GRUD", "ODERNN", "RNN", "AttentionNeuralCDE", "NeuralCDE", "StackedNeuralCDE",
        "VectorField", "prepare_gru_variant_data", "sparsemax"),
    "online_neural_cdes_tpu_torch.ops.solvers": (
        "combine_event_functions", "odeint", "odeint_event"),
    "online_neural_cdes_tpu_torch.serving": ("OnlineNCDEStepper", "Predictor"),
    "online_neural_cdes_tpu_torch.utils.convert": ("params_from_jax",),
}
_HOME = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = sorted(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_HOME[name]), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME))
