"""Fixed-grid Runge-Kutta steppers.

PyTorch counterpart of the fixed-grid part of the JAX package's
``ops/solvers.py``: ``FIXED_METHODS``, ``FIXED_NFE_PER_STEP`` and
``tree_fixed_step`` (Euler, midpoint, and the RK4 3/8 rule the reference
uses for ``method='rk4'``).  The state is one tensor, or a tuple of tensors
(the adjoint's augmented state); a field may return ``None`` for a leaf
whose derivative is zero.  Time arithmetic stays in the times' own type (a
Python float or a tensor); the state update casts the step size to each
leaf's dtype, the mixed-precision convention of the JAX package, so every
leaf keeps its own dtype.  The adaptive solvers, ``odeint`` and ``odeint_event`` come
with a later slice (ROADMAP item 12).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["FIXED_METHODS", "FIXED_NFE_PER_STEP", "ADAPTIVE_METHODS",
           "tree_fixed_step"]

FIXED_METHODS = ("euler", "midpoint", "rk4")
FIXED_NFE_PER_STEP = {"euler": 1, "midpoint": 2, "rk4": 4}
# Names of the JAX package's adaptive solvers: accepted by the model's
# validation, refused when solved (not ported yet).
ADAPTIVE_METHODS = ("dopri5", "bosh3", "fehlberg2", "adaptive_heun",
                    "dopri8", "dop853")


_HOST_ROUND = {torch.float64: float, torch.float32: np.float32,
               torch.float16: np.float16}


def _step_size(dt, y: torch.Tensor):
    """``dt`` cast to the state dtype: a tensor stays on the device, a
    Python float is rounded through the dtype and stays a host scalar (no
    device scalar is made per stage)."""
    if isinstance(dt, torch.Tensor):
        return dt.to(y.dtype)
    round_to = _HOST_ROUND.get(y.dtype)
    if round_to is None:
        return torch.tensor(dt, dtype=y.dtype).item()
    return float(round_to(dt))


def _axpy_leaf(y: torch.Tensor, h, ks, cs) -> torch.Tensor:
    acc = y
    for k, c in zip(ks, cs):
        if k is None:
            continue
        if isinstance(h, torch.Tensor):
            acc = acc + h * c * k
        else:
            # alpha rounded through the leaf's dtype: the CPU's add rounds it
            # to a bf16 state's dtype, the card's keeps it in f32, so a bf16
            # state would step differently on the two (no change in f32/f64).
            acc = torch.add(acc, k, alpha=_step_size(h * c, y))
    return acc


def _axpy(y, dt, *ks_and_coeffs):
    """y + dt * sum(c_i * k_i), dt cast to each leaf's dtype; one fused
    multiply-add per term when dt is a host scalar.  ``y`` is a tensor or a
    tuple; each k_i has y's structure, or is a longer tuple whose extra
    leaves are ignored; a ``None`` leaf of k_i adds nothing."""
    ks, cs = ks_and_coeffs[0::2], ks_and_coeffs[1::2]
    if isinstance(y, torch.Tensor):
        return _axpy_leaf(y, _step_size(dt, y), ks, cs)
    return tuple(_axpy_leaf(yl, _step_size(dt, yl), [k[i] for k in ks], cs)
                 for i, yl in enumerate(y))


def tree_fixed_step(method: str, live: Optional[int] = None):
    """Returns step(f, t0, dt, y) -> y1 with f(t, y).

    ``live``: for a tuple state, f reads only ``y[:live]``; the stages
    then carry only those leaves (the rest are dead until the final
    update, as XLA drops them from the JAX package's stepper), while the
    returned state updates every leaf."""

    def head(y):
        return y if live is None or isinstance(y, torch.Tensor) else tuple(y[:live])

    if method == "euler":

        def step(f, t0, dt, y):
            return _axpy(y, dt, f(t0, head(y)), 1.0)

    elif method == "midpoint":

        def step(f, t0, dt, y):
            x = head(y)
            k1 = f(t0, x)
            k2 = f(t0 + 0.5 * dt, _axpy(x, dt, k1, 0.5))
            return _axpy(y, dt, k2, 1.0)

    elif method == "rk4":

        def step(f, t0, dt, y):
            third = 1.0 / 3.0
            x = head(y)
            k1 = f(t0, x)
            k2 = f(t0 + dt * third, _axpy(x, dt, k1, third))
            k3 = f(t0 + 2.0 * dt * third, _axpy(x, dt, k1, -third, k2, 1.0))
            k4 = f(t0 + dt, _axpy(x, dt, k1, 1.0, k2, -1.0, k3, 1.0))
            return _axpy(y, dt, k1, 0.125, k2, 0.375, k3, 0.375, k4, 0.125)

    else:
        raise ValueError(f"No fixed-grid stepper {method!r}")

    return step
