"""online_neural_cdes_tpu_torch -- the PyTorch/CUDA port of
``online_neural_cdes_tpu``.

The port mirrors the JAX package's module paths and public names and runs
on an NVIDIA Hopper card: plain tensor code is PyTorch, and the TPU's
Pallas kernels become hand-written CUDA kernels (``csrc/``), built at
first use.  It imports neither JAX nor the JAX package.

Three slices are ported: serving and training of an NCDE with a
fixed-grid solver under every interpolation scheme of the JAX package
(linear, rectilinear, natural cubic, Hermite, smoothed linear) -- the
coefficient builders and splines, the fused vector field with its forward
and backward Hopper kernels, the fixed-grid piece scan and its interval
adjoint, ``NeuralCDE``, ``Predictor``, ``OnlineNCDEStepper``, the
NaN-masked losses and the Adam train steps (``training``), and the
Brownian-motion toy (``data.toy``, ``experiments.sim_bm_toy``) -- and the
whole-interval RK4 kernels (``ops.kernels.fused_rk4_interval`` and its
K-replica form) with their interval-chain experiments
(``experiments.pair_probe``, ``experiments.interleave_experiment``).
``ROADMAP.md`` lists what comes next.
"""

__version__ = "0.1.0"

from online_neural_cdes_tpu_torch.ops.cdeint import cdeint  # noqa: F401
from online_neural_cdes_tpu_torch.ops.interpolation import (  # noqa: F401
    CubicSpline,
    LinearInterpolation,
    NaturalCubicSpline,
    SmoothLinearInterpolation,
    TupleControl,
    hermite_cubic_coefficients_with_backward_differences,
    linear_interpolation_coeffs,
    natural_cubic_coeffs,
    natural_cubic_spline_coeffs,
    prepare_rectilinear_interpolation,
)
from online_neural_cdes_tpu_torch.models import NeuralCDE, VectorField  # noqa: F401
from online_neural_cdes_tpu_torch.serving import (  # noqa: F401
    OnlineNCDEStepper,
    Predictor,
)
from online_neural_cdes_tpu_torch.utils.convert import params_from_jax  # noqa: F401
