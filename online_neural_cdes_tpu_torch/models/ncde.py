"""The Neural CDE model.

PyTorch counterpart of the JAX package's ``models/ncde.py`` for the fixed
solvers and every spline of its registry (linear, rectilinear, natural
cubic, Hermite, and linear with cubic or quintic smoothing).
``NeuralCDE`` is an ``nn.Module``: the constructor takes the JAX
dataclass's fields and makes the parameters (``field``, ``initial``,
``final``, under the JAX pytree's names) from a ``torch.Generator``;
``forward(inputs)`` is the JAX ``apply(params, inputs)``.  ``inputs`` is
the coefficient array, or a ``(static, coeffs)`` pair when ``static_dim``
is set.

The model runs on ``device`` (the CUDA card unless ``device="cpu"`` is
asked for; with neither it raises).  The field goes through the fused
trunk -> head -> contraction op for every H and B: on the card that is the
hand-written kernel ``csrc/fused_field.cu``.  A forward that needs
gradients (grad mode on, parameters or inputs requiring grad) goes through
``cdeint``'s interval adjoint (``adjoint=True``, the default) or autograd
through the scan; every reverse stage then runs the field's backward
kernel ``csrc/fused_field_bwd.cu`` on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
from online_neural_cdes_tpu_torch.ops import solvers as _solvers
from online_neural_cdes_tpu_torch.ops.cdeint import cdeint
from online_neural_cdes_tpu_torch.ops import interpolation as interp
from online_neural_cdes_tpu_torch.ops.kernels import (
    fused_matmul_field,
    pack_fused_params,
)
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.params import linear_apply, linear_init

__all__ = ["NeuralCDE", "SPLINES"]

SPLINES = (
    "cubic",
    "hermite",
    "linear",
    "rectilinear",
    "linear_cubic_smoothing",
    "linear_quintic_smoothing",
)


def make_spline(interpolation: str, coeffs: torch.Tensor, eps: Optional[float] = None):
    """Spline registry; ``coeffs`` must come from the matching builder in
    ``ops.interpolation``; ``eps`` is the smoothing splines' matching
    width."""
    if interpolation in ("linear", "rectilinear"):
        return interp.LinearInterpolation.create(coeffs)
    if interpolation in ("cubic", "hermite"):
        return interp.CubicSpline.create(coeffs)
    if interpolation == "linear_cubic_smoothing":
        return interp.SmoothLinearInterpolation.create(
            coeffs, gradient_matching_eps=eps, match_second_derivatives=False)
    if interpolation == "linear_quintic_smoothing":
        return interp.SmoothLinearInterpolation.create(
            coeffs, gradient_matching_eps=eps, match_second_derivatives=True)
    raise ValueError(f"Unrecognised interpolation scheme {interpolation}")


class NeuralCDE(nn.Module):
    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        output_dim: int,
        static_dim: Optional[int] = None,
        hidden_hidden_dim: int = 15,
        num_layers: int = 3,
        use_initial: bool = True,
        interpolation: str = "linear",
        interpolation_eps: Optional[float] = None,
        sparsity: Optional[float] = None,
        vector_field: str = "original",
        vector_field_type: str = "matmul",
        adjoint: bool = True,
        adjoint_method: Optional[str] = None,
        solver: str = "rk4",
        return_sequences: bool = False,
        apply_final_linear: bool = True,
        return_filtered_rectilinear: bool = True,
        rectilinear_time_channel: int = 0,
        fused: bool = True,
        solver_unroll: int = 1,
        *,
        device=None,
        dtype=torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if interpolation not in SPLINES:
            raise ValueError(
                f"unknown interpolation {interpolation!r}; one of {sorted(SPLINES)}"
            )
        valid = (tuple(_solvers.FIXED_METHODS) + tuple(_solvers.ADAPTIVE_METHODS)
                 + ("explicit_adams", "implicit_adams", "scipy_solver"))
        if solver not in valid:
            raise ValueError(f"unknown solver {solver!r}; one of {sorted(valid)}")
        if solver not in _solvers.FIXED_METHODS:
            raise NotImplementedError(
                f"solver={solver!r} is not ported yet (ROADMAP item 12: the "
                "adaptive and multistep solvers)"
            )
        if adjoint_method is not None and adjoint_method not in _solvers.FIXED_METHODS:
            raise ValueError(
                f"adjoint_method {adjoint_method!r} must be one of "
                f"{_solvers.FIXED_METHODS}"
            )
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.static_dim = static_dim
        self.hidden_hidden_dim = hidden_hidden_dim
        self.num_layers = num_layers
        self.use_initial = use_initial
        self.interpolation = interpolation
        self.interpolation_eps = interpolation_eps
        self.sparsity = sparsity
        self.vector_field = vector_field
        self.vector_field_type = vector_field_type
        self.adjoint = adjoint
        self.adjoint_method = adjoint_method
        self.solver = solver
        self.return_sequences = return_sequences
        self.apply_final_linear = apply_final_linear
        self.return_filtered_rectilinear = return_filtered_rectilinear
        self.rectilinear_time_channel = rectilinear_time_channel
        self.fused = fused
        self.solver_unroll = solver_unroll

        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.field = VectorField(
            input_dim=input_dim, hidden_dim=hidden_dim,
            hidden_hidden_dim=hidden_hidden_dim, num_layers=num_layers,
            sparsity=sparsity, vector_field_type=vector_field_type,
            kind=vector_field, generator=generator, dtype=dtype, device=device,
        )
        if self.initial_dim > 0:
            self.initial = nn.ParameterDict(
                linear_init(generator, self.initial_dim, hidden_dim, dtype, device)
            )
        if apply_final_linear:
            self.final = nn.ParameterDict(
                linear_init(generator, hidden_dim, output_dim, dtype, device)
            )

    @property
    def device(self) -> torch.device:
        return self.field.out["w"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.field.out["w"].dtype

    @property
    def initial_dim(self) -> int:
        dim = 0
        if self.use_initial:
            dim += self.input_dim
        if self.static_dim is not None:
            dim += self.static_dim
        return dim

    @property
    def solver_settings(self) -> dict:
        """rk4 preset: one step per knot interval (substeps=1 on the piece
        scan).  The adaptive presets come with their solvers."""
        return dict(atol=1e-5, rtol=1e-3,
                    options={"substeps": 1, "unroll": self.solver_unroll})

    # -- forward pieces ---------------------------------------------------

    def _setup_h0(self, inputs):
        """h0 from the initial observation and/or static features."""
        if self.static_dim is None:
            coeffs, static = inputs, None
        else:
            if not (isinstance(inputs, (tuple, list)) and len(inputs) == 2):
                raise ValueError(
                    "Inputs must be a 2-tuple of (static_data, temporal_data)"
                )
            static, coeffs = inputs
        spline = make_spline(self.interpolation, coeffs, self.interpolation_eps)
        x0 = spline.evaluate(spline.interval[0])
        if static is None:
            if self.use_initial:
                h0 = linear_apply(self.initial, x0)
            else:
                h0 = torch.zeros(coeffs.shape[:-2] + (self.hidden_dim,),
                                 dtype=coeffs.dtype, device=coeffs.device)
        else:
            if self.use_initial:
                h0 = linear_apply(self.initial, torch.cat([static, x0], -1))
            else:
                h0 = linear_apply(self.initial, static)
        return spline, h0

    def _make_outputs(self, hidden):
        """Final linear + every-other filtering for rectilinear sequences."""
        def final(h):
            return linear_apply(self.final, h) if self.apply_final_linear else h

        if self.return_sequences:
            outputs = final(hidden)
            if self.interpolation == "rectilinear" and self.return_filtered_rectilinear:
                outputs = outputs[..., ::2, :]
        else:
            outputs = final(hidden[..., -1, :])
        return outputs

    def packed_field(self) -> dict:
        """The field's parameters packed for the fused op
        (``pack_fused_params``).  A rectilinear model adds its time
        channel's head columns as contiguous ``head_w_time`` (HH, H) and
        ``head_b_time`` (H,): the time-advance intervals contract against
        that channel only.  Packed once per forward, outside the scan."""
        H = self.hidden_dim
        packed = pack_fused_params(self.field.params, H, self.input_dim)
        if self.interpolation == "rectilinear":
            k = self.rectilinear_time_channel
            packed["head_w_time"] = packed["head_w"][:, k * H:(k + 1) * H].contiguous()
            packed["head_b_time"] = packed["head_b"][k * H:(k + 1) * H].contiguous()
        return packed

    def make_solve_func(self, h0: torch.Tensor):
        """The field handed to the solver: ``(func, even_func, field_args,
        vf_type)``.  Every state goes through the fused op, whatever H, its
        batch and its leading dims (an unbatched series, extra batch dims).
        ``fused`` is kept as a field of the JAX model; the port has only the
        fused op, which computes what the JAX unfused field does."""
        del h0
        H, I = self.hidden_dim, self.input_dim

        def func(t, z, dx, fp):
            return fused_matmul_field(fp["trunk"], fp["head_w"], fp["head_b"],
                                      z, dx, H, I)

        even_func = None
        if self.interpolation == "rectilinear":
            k = self.rectilinear_time_channel

            def even_func(t, z, dx, fp):
                return fused_matmul_field(
                    fp["trunk"], fp["head_w_time"], fp["head_b_time"], z,
                    dx[..., k:k + 1].contiguous(), H, 1,
                )

        return func, even_func, self.packed_field(), "matmul_fused"

    def forward(self, inputs, return_stats: bool = False):
        spline, h0 = self._setup_h0(inputs)
        times = spline.grid_points if self.return_sequences else spline.interval
        func, even_func, field_args, vf_type = self.make_solve_func(h0)
        adjoint_options = (
            {"method": self.adjoint_method}
            if self.adjoint_method is not None else None
        )
        result = cdeint(
            spline, func, h0, times, field_args,
            adjoint=self.adjoint, vector_field_type=vf_type,
            method=self.solver, return_stats=return_stats,
            even_func=even_func, adjoint_options=adjoint_options,
            **self.solver_settings,
        )
        if return_stats:
            hidden, stats = result
            return self._make_outputs(hidden), stats
        return self._make_outputs(result)
