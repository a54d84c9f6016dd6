"""ODE solvers: fixed-grid and adaptive Runge-Kutta, and ``odeint``.

PyTorch counterpart of the JAX package's ``ops/solvers.py``:

- the fixed-grid steppers (Euler, midpoint, and the RK4 3/8 rule the
  reference uses for ``method='rk4'``): ``tree_fixed_step`` for the piece
  scan of ``cdeint``, and the per-state steppers of ``odeint``'s fixed
  grid (``_fixed_grid_integrate``, ``_grid_constructor_integrate``);
- the adaptive Runge-Kutta solvers (``ADAPTIVE_METHODS``: dopri5, bosh3,
  fehlberg2, adaptive_heun, dopri8 / dop853) with the reference's
  ``min_step`` / ``max_step`` bounds, ``step_t`` / ``jump_t``
  discontinuities, per-leaf mixed error norms, the quartic dense output,
  and the differentiable solve (``options={"differentiable": True}``):
  the accepted-step grid found under no grad, then replayed with grad.

The JAX package runs the accept/reject controller on the device inside a
``lax.while_loop``.  Here it runs on the host: the stages, the error
estimate and the dense output are tensor code on the state's device, and
the controller reads one number per attempted step (the error ratio) and
one per solve for the initial step (its norms, stacked).  Every controller
quantity (``t0``, ``t1``, ``dt``, the ratio, the tolerances) is a numpy
scalar of the state's dtype, as the JAX package does its time arithmetic
in ``y0.dtype``.  A field receives its time as a 0-d tensor on the state's
device (made by a fill, so no host-to-device copy waits on the card).

``COUNTS`` holds what the adaptive solves did since ``reset_counts()``, by
kind of solve: the forward solves, ``odeint_adjoint``'s reverse solves and
the differentiable solve's replay (``counting_as``): solves, nfe, accepted
and rejected steps, host reads, and field evaluations made outside a
solve's own nfe.

A state is one tensor or a tuple of tensors (any nesting of tuples, lists
and dicts); its leaves step together and, as the JAX package's ravelled
state, share one dtype (float32, float64 or bfloat16).  A bf16 state's
controller scalars are rounded to bf16 after every operation, as the JAX
package does its controller arithmetic in the state's dtype; numpy has no
bf16, so they round through a CPU bf16 tensor (``_Bf16``).

Besides the Runge-Kutta methods: the Adams-Bashforth(-Moulton) multistep
methods (``explicit_adams`` / ``implicit_adams``, fixed grid, order
growing with the history to 12, the corrector's convergence test decided
on the device), ``scipy_solver`` (a host solve through
``scipy.integrate.solve_ivp``, one device read per right-hand side), and
``odeint_event`` / ``combine_event_functions`` (an adaptive solve until an
event function crosses zero, the crossing found by bisection on the dense
output on the device; ``differentiable=True`` gives the event time its
gradients by the implicit function theorem).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from online_neural_cdes_tpu_torch.utils.tree import flatten

__all__ = ["odeint", "odeint_event", "combine_event_functions", "FIXED_METHODS",
           "FIXED_NFE_PER_STEP", "ADAPTIVE_METHODS", "ADAMS_METHODS", "ButcherTableau",
           "tree_fixed_step", "COUNTS", "reset_counts", "counting_as"]

FIXED_METHODS = ("euler", "midpoint", "rk4")
FIXED_NFE_PER_STEP = {"euler": 1, "midpoint": 2, "rk4": 4}
ADAMS_METHODS = ("explicit_adams", "implicit_adams")


# ---------------------------------------------------------------------------
# Butcher tableaux
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    alpha: tuple            # (s-1,) nodes
    beta: tuple             # rows of the lower-triangular stage matrix
    c_sol: tuple            # (s,) solution weights
    c_error: tuple          # (s,) error weights (solution - embedded)
    order: int              # order used by the step-size controller
    mid: Optional[tuple] = None   # optional dense-output midpoint weights
    # DOP853-style blended error: when set, the ratio combines the 5th-order
    # (c_error) and 3rd-order (c_error_alt) estimates as in Hairer's DOP853.
    c_error_alt: Optional[tuple] = None


DOPRI5 = ButcherTableau(
    alpha=(1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    beta=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    c_sol=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    c_error=(
        35 / 384 - 5179 / 57600,
        0.0,
        500 / 1113 - 7571 / 16695,
        125 / 192 - 393 / 640,
        -2187 / 6784 + 92097 / 339200,
        11 / 84 - 187 / 2100,
        -1 / 40,
    ),
    order=5,
    mid=(
        6025192743 / 30085553152 / 2,
        0.0,
        51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2,
        187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2,
        11237099 / 235043384 / 2,
    ),
)

BOSH3 = ButcherTableau(
    alpha=(1 / 2, 3 / 4, 1.0),
    beta=((1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    c_sol=(2 / 9, 1 / 3, 4 / 9, 0.0),
    c_error=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    order=3,
)

FEHLBERG2 = ButcherTableau(
    alpha=(1 / 2, 1.0),
    beta=((1 / 2,), (1 / 256, 255 / 256)),
    c_sol=(1 / 512, 255 / 256, 1 / 512),
    c_error=(1 / 512 - 1 / 256, 0.0, 1 / 512),
    order=2,
)

ADAPTIVE_HEUN = ButcherTableau(
    alpha=(1.0,),
    beta=((1.0,),),
    c_sol=(1 / 2, 1 / 2),
    c_error=(-1 / 2, 1 / 2),
    order=2,
)


def _dop853_tableau() -> ButcherTableau:
    """Hairer's DOP853 (8th order, 12 stages + an FSAL-style 13th used by
    the blended 5th/3rd-order error estimator).  Coefficients are taken
    from scipy's published tables rather than retyped."""
    from scipy.integrate._ivp import dop853_coefficients as dc

    n = dc.N_STAGES  # 12
    alpha = tuple(map(float, dc.C[1:n])) + (1.0,)
    beta = tuple(tuple(map(float, dc.A[i][:i])) for i in range(1, n))
    # 13th stage at t1 with the solution weights: k[12] = f(t1, y1).
    beta = beta + (tuple(map(float, dc.B)),)
    c_sol = tuple(map(float, dc.B)) + (0.0,)
    return ButcherTableau(
        alpha=alpha,
        beta=beta,
        c_sol=c_sol,
        c_error=tuple(map(float, dc.E5)),
        c_error_alt=tuple(map(float, dc.E3)),
        order=8,
    )


DOP853 = _dop853_tableau()

ADAPTIVE_METHODS = {
    "dopri5": DOPRI5,
    "bosh3": BOSH3,
    "fehlberg2": FEHLBERG2,
    "adaptive_heun": ADAPTIVE_HEUN,
    "dopri8": DOP853,
    "dop853": DOP853,
}


# ---------------------------------------------------------------------------
# Counts of the adaptive, Adams, scipy and event solves
# ---------------------------------------------------------------------------

COUNTS: dict = {}
_KIND = ["forward"]
_COUNT_KEYS = ("solves", "nfe", "accepted", "rejected", "reads", "evals", "lane_solves",
               "attempts", "wasted", "lane_evals")


def reset_counts() -> None:
    COUNTS.clear()


@contextlib.contextmanager
def counting_as(kind: str):
    """Solves inside the block count under ``COUNTS[kind]``."""
    _KIND.append(kind)
    try:
        yield
    finally:
        _KIND.pop()


def _count(**amounts) -> None:
    entry = COUNTS.setdefault(_KIND[-1], dict.fromkeys(_COUNT_KEYS, 0))
    for key, value in amounts.items():
        entry[key] += int(value)


def _read(x: torch.Tensor) -> list:
    """One device-to-host read of the controller (counted)."""
    _count(reads=1)
    return x.reshape(-1).tolist()


# ---------------------------------------------------------------------------
# Fixed-grid steppers of the piece scan (tuple states, host step sizes)
# ---------------------------------------------------------------------------

@torch.compiler.assume_constant_result
def _to_bf16(x: float) -> float:
    """``x`` rounded to bf16, as a float; a tracer (an exported solve)
    takes the result as a constant."""
    return torch.tensor(x, dtype=torch.bfloat16).item()


class _Bf16(float):
    """A host scalar of a bf16 state: a float holding a bf16 value, every
    arithmetic result rounded to bf16 (through a CPU tensor: numpy has no
    bf16), as the JAX package's controller computes in the state's dtype."""

    def __new__(cls, x=0.0):
        return super().__new__(cls, _to_bf16(float(x)))

    def __add__(self, o):
        return _Bf16(float(self) + float(o))

    __radd__ = __add__

    def __sub__(self, o):
        return _Bf16(float(self) - float(o))

    def __rsub__(self, o):
        return _Bf16(float(o) - float(self))

    def __mul__(self, o):
        return _Bf16(float(self) * float(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _Bf16(float(self) / float(o))

    def __rtruediv__(self, o):
        return _Bf16(float(o) / float(self))

    def __pow__(self, o):
        return _Bf16(float(self) ** float(o))

    def __neg__(self):
        return _Bf16(-float(self))

    def __abs__(self):
        return _Bf16(abs(float(self)))


def _cast(x, S):
    """A host array in the scalar type ``S`` (a bf16 state's: an object
    array of ``_Bf16``)."""
    x = np.asarray(x)
    if S is _Bf16:
        return np.array([_Bf16(v) for v in x.reshape(-1).tolist()],
                        dtype=object).reshape(x.shape)
    return x.astype(S)


def _nextafter(x, toward):
    """The next value of x's type after x towards ``toward``."""
    if isinstance(x, _Bf16):
        nxt = torch.nextafter(torch.tensor(float(x), dtype=torch.bfloat16),
                              torch.tensor(float(toward), dtype=torch.bfloat16))
        return _Bf16(nxt.item())
    return np.nextafter(x, toward)


# Host scalars of a state's dtype.
_NUMPY = {torch.float64: np.float64, torch.float32: np.float32, torch.bfloat16: _Bf16}
_HOST_ROUND = {**_NUMPY, torch.bfloat16: _to_bf16, torch.float16: np.float16}


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


# ---------------------------------------------------------------------------
# Leaf-list arithmetic.  Inside odeint a state is a list of tensors (its
# leaves) and ``func(t, leaves) -> leaves``.  Host scalars multiply as
# Python floats holding the exact value of the state-dtype scalar.  The
# ``torch._foreach_*`` ops do each elementwise op on every leaf in one
# launch on the card (the adjoint's augmented state has a leaf per
# parameter tensor), with the same arithmetic as one op per leaf.
# ---------------------------------------------------------------------------

def _lincomb(cs, ks):
    """sum(c * k for c, k in zip(cs, ks) if c != 0) for each leaf, terms
    added left to right (the JAX step's association), or None when every
    coefficient is 0.  Each c is rounded to the leaves' dtype first, as a
    Python number meets an array in JAX (no change in f32 and f64)."""
    terms = [(c, k) for c, k in zip(cs, ks) if c != 0]
    if not terms:
        return None
    S = _NUMPY[terms[0][1][0].dtype]
    terms = [(float(S(c)), k) for c, k in terms]
    acc = torch._foreach_mul(terms[0][1], terms[0][0])
    for c, k in terms[1:]:
        acc = torch._foreach_add(acc, torch._foreach_mul(k, c))
    return acc


def _add_scaled(y, h, s):
    """y + h * s leaf by leaf (``s`` None: y)."""
    if s is None:
        return list(y)
    return torch._foreach_add(y, torch._foreach_mul(s, float(h)))


def _norms(xs, weights=None):
    """Per leaf ||x w|| (a list of 0-d tensors); leaves whose weight is 0
    give None."""
    weights = weights or [None] * len(xs)
    live = [i for i, w in enumerate(weights)
            if not (isinstance(w, (int, float)) and w == 0)]
    scaled = [xs[i] if weights[i] is None or isinstance(weights[i], (int, float))
              and weights[i] == 1 else xs[i] * weights[i] for i in live]
    out = [None] * len(xs)
    for i, n in zip(live, torch._foreach_norm(scaled) if scaled else []):
        out[i] = n
    return out


def _rms(norms, count: int) -> torch.Tensor:
    """sqrt(sum of the given leaves' sums of squares / count)."""
    return torch.sqrt(torch.stack(norms).square().sum() / count)


# ---------------------------------------------------------------------------
# Norms and step-size control (reference misc.py:18-89 semantics)
# ---------------------------------------------------------------------------

def _leaf_weight_counts(leaves, weights):
    """Per leaf: the number of entries with a nonzero weight."""
    counts = []
    for leaf, w in zip(leaves, weights):
        if w is None:
            counts.append(leaf.numel())
        elif isinstance(w, (int, float)):
            counts.append(leaf.numel() if w != 0 else 0)
        else:
            counts.append(int(_read((w != 0).sum())[0]) if w.is_cuda
                          else int((w != 0).sum()))
    return counts


def _weights_per_leaf(error_weights, leaves):
    """``error_weights`` (a flat tensor over the ravelled state, as the JAX
    package takes it, or a list with one entry per leaf: None, a number or
    a tensor) as one entry per leaf."""
    if error_weights is None:
        return [None] * len(leaves)
    if isinstance(error_weights, (list, tuple)):
        return list(error_weights)
    flat = torch.as_tensor(error_weights).to(leaves[0].device)
    out, pos = [], 0
    for leaf in leaves:
        out.append(flat[pos:pos + leaf.numel()].reshape(leaf.shape).to(leaf.dtype))
        pos += leaf.numel()
    return out


class _ErrorNorm:
    """The scaled error norm of a step: a weighted RMS over each block of
    leaves, max-combined across blocks (the reference's ``_mixed_norm``;
    one block for a tensor state or ``norm="rms"``, one per leaf
    otherwise); DOP853's blended 5th/3rd-order ratio within each block."""

    def __init__(self, leaves, weights, per_leaf: bool):
        self.weights = _weights_per_leaf(weights, leaves)
        counts = _leaf_weight_counts(leaves, self.weights)
        idx = list(range(len(leaves)))
        self.blocks = [[i] for i in idx] if per_leaf else [idx]
        self.counts = [max(sum(counts[i] for i in b), 1) for b in self.blocks]

    def ratio(self, r):
        """max over blocks of sqrt(sum((r w)^2) / count), a 0-d tensor (a
        block whose weights are all 0 gives 0)."""
        norms = _norms(r, self.weights)
        live = [i for i, n in enumerate(norms) if n is not None]
        if not live:
            return torch.zeros((), dtype=r[0].dtype, device=r[0].device)
        if len(self.blocks) == 1:
            return _rms([norms[i] for i in live], self.counts[0])
        # One block per leaf: ||r_i w_i|| / sqrt(count_i), for every leaf in
        # one launch.
        return _max_combine(torch._foreach_div([norms[i] for i in live],
                                               [math.sqrt(self.counts[i]) for i in live]))

    def ratio_lanes(self, r, k: int) -> torch.Tensor:
        """:meth:`ratio` of each of ``k`` lanes (``r``'s leaves (k, ...),
        the norm's shapes one lane's), with the same arithmetic: every
        lane's leaf norms in one ``_foreach_norm``; one block of several
        leaves sums its squares lane by lane."""
        if len(self.blocks) == 1 and len(r) > 1:
            return torch.stack([self.ratio([x[j] for x in r]) for j in range(k)])
        live = [i for i, w in enumerate(self.weights)
                if not (isinstance(w, (int, float)) and w == 0)]
        if not live:
            return torch.zeros(k, dtype=r[0].dtype, device=r[0].device)
        scaled = []
        for j in range(k):
            for i in live:
                w = self.weights[i]
                plain = w is None or (isinstance(w, (int, float)) and w == 1)
                scaled.append(r[i][j] if plain else r[i][j] * w)
        norms = torch.stack(torch._foreach_norm(scaled)).reshape(k, len(live))
        if len(self.blocks) == 1:
            return torch.sqrt(norms[:, 0].square() / self.counts[0])
        roots = torch.tensor([math.sqrt(self.counts[i]) for i in live], dtype=norms.dtype,
                             device=norms.device)
        return (norms / roots).amax(1)

    def blended(self, e5, e3, dt_abs):
        """DOP853's blended ratio in each block, max-combined."""
        n5, n3 = _norms(e5, self.weights), _norms(e3, self.weights)
        out = []
        for block, n in zip(self.blocks, self.counts):
            live = [i for i in block if n5[i] is not None]
            if not live:
                out.append(torch.zeros((), dtype=e5[0].dtype, device=e5[0].device))
                continue
            s5 = torch.stack([n5[i] for i in live]).square().sum()
            s3 = torch.stack([n3[i] for i in live]).square().sum()
            denom = s5 + 0.01 * s3
            val = dt_abs * s5 / torch.sqrt(torch.clamp(denom, min=1e-30) * float(n))
            out.append(torch.where(denom > 0.0, val, torch.zeros_like(val)))
        return _max_combine(out)


def _max_combine(norms):
    """The largest of the blocks' ratios (NaN if any is NaN)."""
    return norms[0] if len(norms) == 1 else torch.stack(norms).max()


def _optimal_step_size(last_step, error_ratio, safety, ifactor, dfactor, order):
    """Reference misc.py:80-89 on host scalars of the state's dtype."""
    S = type(last_step)
    if error_ratio == 0:
        return last_step * ifactor
    dfac = S(1) if error_ratio < 1 else dfactor
    factor = np.minimum(ifactor, np.maximum(
        safety / error_ratio ** S(1.0 / order), dfac))
    return S(last_step * factor)


def _select_initial_step(func, t0, y0, order, rtol, atol, f0):
    """Hairer, Norsett & Wanner heuristic (reference misc.py:32-71): the
    norms and h0 on the device, read once (d0, d1, d2 and h0 stacked)."""
    S = type(t0)
    scale = torch._foreach_add(torch._foreach_mul(torch._foreach_abs(y0), float(rtol)),
                               float(atol))
    n = sum(yl.numel() for yl in y0)

    def rms(xs):
        return _rms(_norms(torch._foreach_div(xs, scale)), n)

    d0, d1 = rms(y0), rms(f0)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.where(d1 == 0, torch.ones_like(d1), d1))
    y1 = [yl + h0 * fl for yl, fl in zip(y0, f0)]
    f1 = func(float(t0) + h0, y1)
    d2 = rms(torch._foreach_sub(f1, f0)) / h0
    return _initial_step_host(S, order, *_read(torch.stack([d0, d1, d2, h0])))


def _initial_step_host(S, order, d0, d1, d2, h0):
    """The heuristic's host part, from the norms read off the device."""
    d1_, d2_, h0_ = S(d1), S(d2), S(h0)
    with np.errstate(all="ignore"):
        if d1_ <= 1e-15 and d2_ <= 1e-15:
            h1 = np.maximum(S(1e-6), h0_ * S(1e-3))
        else:
            h1 = (S(0.01) / np.maximum(d1_, d2_)) ** S(1.0 / float(order + 1))
        return S(np.minimum(S(100.0) * h0_, h1))


# ---------------------------------------------------------------------------
# Runge-Kutta single step + 4th-order dense output (interp.py:1-48)
# ---------------------------------------------------------------------------

def _runge_kutta_step(func, y0, f0, t0, dt, tableau: ButcherTableau,
                      t1_eval=None, error=True):
    """One explicit RK step.  Returns (y1, f1, error, k_stages); ``error``
    False skips the error estimate (None).

    ``t1_eval``, when given, replaces the evaluation time of stages with
    alpha == 1 (the step's right endpoint) -- used to evaluate the *left*
    limit when the step lands on a declared discontinuity (the reference's
    Perturb.PREV, rk_common.py:41-86)."""
    S = type(dt)
    k = [f0]
    for alpha_i, beta_row in zip(tableau.alpha, tableau.beta):
        ti = t0 + dt * S(alpha_i)
        if alpha_i == 1.0 and t1_eval is not None:
            ti = t1_eval
        k.append(func(ti, _add_scaled(y0, dt, _lincomb(beta_row, k))))
    y1 = _add_scaled(y0, dt, _lincomb(tableau.c_sol, k))
    err = None
    if error:
        err = torch._foreach_mul(_lincomb(tableau.c_error, k), float(dt))
    return y1, k[-1], err, k


def _interp_fit(y0, y1, y_mid, f0, f1, dt):
    """Quartic fit matching y0, y1, y_mid, f0, f1 on one step; per leaf
    the five coefficients, highest power first."""
    S = type(dt)
    h, h2 = float(dt), float(S(2) * dt)
    out = []
    for y0l, y1l, yml, f0l, f1l in zip(y0, y1, y_mid, f0, f1):
        a = (f1l - f0l) * h2 - (y1l + y0l) * 8.0 + yml * 16.0
        b = (f0l * 5.0 - f1l * 3.0) * h + y0l * 18.0 + y1l * 14.0 - yml * 32.0
        c = (f1l - f0l * 4.0) * h - y0l * 11.0 - y1l * 5.0 + yml * 16.0
        d = f0l * h
        out.append((a, b, c, d, y0l))
    return out


def _interp_evaluate(coeffs, x):
    """The quartic dense output at x = (t - t0) / (t1 - t0) (a host scalar
    or a tensor), Horner's rule per leaf."""
    if not isinstance(x, torch.Tensor):
        x = float(x)
    out = []
    for leaf in coeffs:
        acc = leaf[0]
        for c in leaf[1:]:
            acc = acc * x + c
        out.append(acc)
    return out


def _fit_from_stages(y0, y1, k, dt, tableau: ButcherTableau):
    S = type(dt)
    if tableau.mid is not None:
        y_mid = _add_scaled(y0, dt, _lincomb(tableau.mid, k))
    else:
        # Cubic-Hermite midpoint: exact for methods of order <= 3.
        q = float(S(0.125) * dt)
        y_mid = [(a + b) * 0.5 + (k0 - kl) * q
                 for a, b, k0, kl in zip(y0, y1, k[0], k[-1])]
    return _interp_fit(y0, y1, y_mid, k[0], k[-1], dt)


# ---------------------------------------------------------------------------
# Fixed-grid solvers (reference solvers.py:77-119, fixed_grid.py, the RK4
# 3/8-rule of rk_common.py:106-114).  Time arithmetic stays in the times'
# dtype; state updates cast dt to the state dtype (rk_common.py:136-138).
# ---------------------------------------------------------------------------

def _euler_step(func, t0, dt, y0, S):
    h = float(S(dt))
    return [yl + fl * h for yl, fl in zip(y0, func(t0, y0))], 1


def _midpoint_step(func, t0, dt, y0, S):
    h = S(dt)
    y_mid = [yl + fl * float(S(0.5) * h) for yl, fl in zip(y0, func(t0, y0))]
    k2 = func(t0 + type(dt)(0.5) * dt, y_mid)
    return [yl + fl * float(h) for yl, fl in zip(y0, k2)], 2


def _rk4_38_step(func, t0, dt, y0, S, f0=None):
    """RK4 3/8-rule -- the variant the reference uses for method='rk4'
    (rk_common.py:106-114 ``rk4_alt_step_func``).  ``f0`` reuses a
    derivative already taken at (t0, y0) as k1 (the Adams bootstrap)."""
    T = type(dt)
    h = S(dt)
    third, hf = float(h / S(3.0)), float(h)
    k1 = func(t0, y0) if f0 is None else f0
    k2 = func(t0 + dt / T(3.0), [y + a * third for y, a in zip(y0, k1)])
    k3 = func(t0 + T(2.0) * dt / T(3.0),
              [y + (b - a / 3.0) * hf for y, a, b in zip(y0, k1, k2)])
    k4 = func(t0 + dt, [y + (a - b + c) * hf for y, a, b, c in zip(y0, k1, k2, k3)])
    return [y + ((a + (b + c) * 3.0 + d) * hf) * 0.125
            for y, a, b, c, d in zip(y0, k1, k2, k3, k4)], (4 if f0 is None else 3)


_FIXED_STEPS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "rk4": _rk4_38_step,
}


def _stats(nfe, accepted, rejected, **extra):
    out = {"nfe": torch.tensor(int(nfe), dtype=torch.int32),
           "accepted": torch.tensor(int(accepted), dtype=torch.int32),
           "rejected": torch.tensor(int(rejected), dtype=torch.int32)}
    out.update({k: torch.tensor(v) for k, v in extra.items()})
    return out


def _fixed_grid_integrate(func, y0, t, S, method, substeps=1, remat=False):
    """``substeps`` equal RK sub-steps per output interval of ``t`` (host
    times).  Returns (ys per leaf, stats) with ys[i] = y(t[i])."""
    step_fn = _FIXED_STEPS[method]
    T = type(t[0])

    def interval(t0, t1, *y):
        dt = (t1 - t0) / T(substeps)
        y = list(y)
        for i in range(substeps):
            y, _ = step_fn(func, t0 if i == 0 else t0 + T(i) * dt, dt, y, S)
        return tuple(y)

    if remat and torch.is_grad_enabled():
        run = lambda t0, t1, y: checkpoint(interval, t0, t1, *y, use_reentrant=False)
    else:
        run = lambda t0, t1, y: interval(t0, t1, *y)
    states = [list(y0)]
    for t0, t1 in zip(t[:-1], t[1:]):
        states.append(list(run(t0, t1, states[-1])))
    n_steps = (len(t) - 1) * substeps
    return _stack(states), _stats(n_steps * FIXED_NFE_PER_STEP[method], n_steps, 0)


def _grid_constructor_integrate(func, y0, t, S, method, grid, remat=False):
    """Fixed-grid integration over a custom grid spanning [t[0], t[-1]];
    the requested times are recovered by linear interpolation between grid
    states (the reference's default ``interp="linear"``)."""
    if not (np.isclose(grid[0], t[0]) and np.isclose(grid[-1], t[-1])):
        raise ValueError(
            "grid_constructor must return a grid spanning exactly "
            f"[t[0], t[-1]] = [{t[0]}, {t[-1]}]; got [{grid[0]}, {grid[-1]}]."
        )
    ys_grid, stats = _fixed_grid_integrate(func, y0, grid, S, method, 1, remat)
    # Grids may be decreasing (reverse-time integration).
    sgn = grid.dtype.type(1.0 if grid[-1] >= grid[0] else -1.0)
    keys = sgn * grid
    outs = []
    for tj in t.astype(grid.dtype):
        i = int(np.clip(np.searchsorted(keys, sgn * tj, side="right") - 1,
                        0, len(grid) - 2))
        t0_, t1_ = grid[i], grid[i + 1]
        denom = t1_ - t0_ if t1_ != t0_ else grid.dtype.type(1)
        w = S(np.clip((tj - t0_) / denom, 0.0, 1.0))
        outs.append([ys[i] * float(S(1) - w) + ys[i + 1] * float(w) for ys in ys_grid])
    return _stack(outs), stats


def _stack(states):
    """A list of states (leaf lists) -> per leaf, the states stacked."""
    return [torch.stack([s[i] for s in states]) for i in range(len(states[0]))]


# ---------------------------------------------------------------------------
# Adams-Bashforth(-Moulton) multistep (reference fixed_adams.py: fixed-grid
# predictor/corrector whose order GROWS with the history, after an RK4
# bootstrap, up to max_order=12; the corrector iterates functionally up to
# max_iters=4 with an L-inf error-ratio convergence test).  Coefficient
# tables come from exact Lagrange-basis integration over the uniform node
# stencil (Fraction arithmetic).
# ---------------------------------------------------------------------------

_ADAMS_MIN_ORDER = 4
_ADAMS_MAX_ORDER = 12
_ADAMS_MAX_ITERS = 4


def _lagrange_quadrature_row(nodes):
    """Exact ``b_j = integral_0^1 l_j(s) ds`` for the Lagrange basis on
    ``nodes``, via Fraction polynomial arithmetic (lowest degree first)."""
    from fractions import Fraction

    row = []
    for j, xj in enumerate(nodes):
        coeffs = [Fraction(1)]
        denom = Fraction(1)
        for m, xm in enumerate(nodes):
            if m == j:
                continue
            # multiply the running polynomial by (s - x_m)
            shifted = [Fraction(0)] + coeffs
            coeffs = [
                shifted[i] - Fraction(xm) * (coeffs[i] if i < len(coeffs) else 0)
                for i in range(len(shifted))
            ]
            denom *= Fraction(xj) - Fraction(xm)
        integral = sum(c / (i + 1) for i, c in enumerate(coeffs))
        row.append(float(integral / denom))
    return row


@functools.lru_cache(maxsize=4)
def _adams_coefficient_tables(max_order: int):
    """(bashforth, moulton) coefficient rows.  ``bashforth[k]`` multiplies
    the k most recent derivative values f_n, f_{n-1}, ... (nodes 0,-1,...);
    ``moulton[k]`` has its first entry on the implicit f_{n+1} (nodes
    1,0,-1,...); e.g. bashforth[4] = [55,-59,37,-9]/24, moulton[3] =
    [5,8,-1]/12."""
    bashforth = [np.zeros(0)]
    moulton = [np.zeros(0)]
    for k in range(1, max_order + 1):
        bashforth.append(np.asarray(_lagrange_quadrature_row([-m for m in range(k)])))
        moulton.append(np.asarray(_lagrange_quadrature_row([1 - m for m in range(k)])))
    return bashforth, moulton


def _adams_integrate(func, y0, t, S, substeps: int, correct: bool, rtol=1e-3, atol=1e-4,
                     max_order: int = _ADAMS_MAX_ORDER, max_iters: int = _ADAMS_MAX_ITERS,
                     lanes: int = 0):
    """``substeps`` uniform Adams steps per output interval of the uniform
    host times ``t``.  The first two steps are RK4 (3/8) bootstraps that
    reuse the step's f_n as k1; then the predictor (Adams-Bashforth of the
    history's order) and, with ``correct``, ``max_iters`` Adams-Moulton
    corrector evaluations whose update freezes once the batch-wide L-inf
    ratio of the last change falls below 1.  That test is a 0-d bool on
    the state's device (``torch.where``), never read by the host: a
    corrected step makes 1 + max_iters field calls and no host read, and
    its nfe counts them all, as the JAX package's fixed-length scan.
    ``lanes`` > 0: the leaves stack that many lanes (a wave's), each with
    its own convergence test."""
    max_order = int(max(max_order, _ADAMS_MIN_ORDER))
    hist_len = max_order - 1
    n_steps = (len(t) - 1) * substeps
    diffs = np.diff(t).astype(np.float64)
    if diffs.size > 1 and not np.allclose(diffs, diffs[0], rtol=1e-6, atol=0):
        raise ValueError(
            "explicit/implicit_adams requires uniformly spaced output times (got "
            f"spacings {diffs.min():g}..{diffs.max():g}); interpolate outputs onto a "
            "uniform grid or use an RK method.")
    T = type(t[0])
    h_t = (t[-1] - t[0]) / T(n_steps)
    h = S(h_t)
    bash_tab, moul_tab = _adams_coefficient_tables(max_order)
    rtol_f, atol_f = float(S(rtol)), float(S(atol))

    def dot(coeffs, fs):
        """sum_j c_j f_j with the coefficients in the state's dtype; a bf16
        history is summed in f32 and rounded once, as XLA's bf16 dot."""
        if S is not _Bf16:
            return _lincomb(coeffs, fs)
        wide = _lincomb([float(S(c)) for c in coeffs], [[l.float() for l in f] for f in fs])
        return [l.to(torch.bfloat16) for l in wide]

    y, hist, nfe, states = list(y0), [], 0, [list(y0)]
    for i in range(n_steps):
        tt = t[0] + T(i) * h_t
        f_n = func(tt, y)
        hist = [f_n] + hist[:hist_len - 1]
        nfe += 1
        if i < _ADAMS_MIN_ORDER - 2:
            y, extra = _rk4_38_step(func, tt, h_t, y, S, f0=f_n)
            nfe += extra
        else:
            order = min(i + 1, hist_len)
            dy = torch._foreach_mul(dot(bash_tab[order], hist[:order]), float(h))
            if correct:
                mrow = moul_tab[order + 1]
                hm0 = float(h * S(mrow[0]))
                delta = torch._foreach_mul(dot(mrow[1:], hist[:order]), float(h))
                done = torch.zeros((lanes,) if lanes else (), dtype=torch.bool,
                                   device=y[0].device)
                for _ in range(max_iters):
                    f_c = func(tt + h_t, torch._foreach_add(y, dy))
                    dy_new = torch._foreach_add(torch._foreach_mul(f_c, hm0), delta)
                    scale = torch._foreach_add(torch._foreach_mul(torch._foreach_maximum(
                        torch._foreach_abs(dy), torch._foreach_abs(dy_new)), rtol_f), atol_f)
                    err = torch._foreach_div(torch._foreach_abs(torch._foreach_sub(dy, dy_new)),
                                             scale)
                    if lanes:
                        ratio = torch.stack([e.reshape(lanes, -1).amax(1) for e in err]).amax(0)
                        dy = [torch.where(_per_lane(done, a), a, b) for a, b in zip(dy, dy_new)]
                    else:
                        ratio = torch.stack([e.max() for e in err]).max()
                        dy = [torch.where(done, a, b) for a, b in zip(dy, dy_new)]
                    done = done | (ratio < 1.0)
                nfe += max_iters
            y = torch._foreach_add(y, dy)
        states.append(list(y))
    _count(solves=max(lanes, 1), nfe=nfe * max(lanes, 1), accepted=n_steps * max(lanes, 1))
    return _stack(states[::substeps]), _stats(nfe, n_steps, 0)


# ---------------------------------------------------------------------------
# SciPy host solve (reference scipy_wrapper.py:9-56)
# ---------------------------------------------------------------------------

def _scipy_integrate(func, y0, t, rtol, atol, options):
    """``scipy.integrate.solve_ivp`` over the ravelled state in float64 on
    the host (``options["solver"]``, LSODA by default; ``max_step``, and
    ``min_step`` with LSODA only).  The field runs on the state's device:
    each right-hand side is one counted device read.  Not differentiable."""
    from scipy.integrate import solve_ivp

    shapes = [leaf.shape for leaf in y0]
    sizes = [leaf.numel() for leaf in y0]
    dtype, device = y0[0].dtype, y0[0].device
    nfe = [0]

    def rhs(tt, yy):
        nfe[0] += 1
        flat = torch.from_numpy(yy).to(device=device, dtype=dtype)
        leaves = [part.reshape(shape) for part, shape in zip(flat.split(sizes), shapes)]
        with torch.no_grad():
            out = torch.cat([leaf.reshape(-1) for leaf in func(tt, leaves)])
        return np.asarray(_read(out.double()), np.float64)

    solver = options.get("solver", "LSODA")
    kwargs = {}
    if "max_step" in options:
        kwargs["max_step"] = float(options["max_step"])
    if "min_step" in options:
        # Of scipy's methods only LSODA takes min_step; another would raise
        # a TypeError deep inside scipy.
        if solver != "LSODA":
            raise ValueError(
                f"scipy solver {solver!r} does not support min_step (only LSODA does); "
                "drop the option or use solver='LSODA'")
        kwargs["min_step"] = float(options["min_step"])
    y_start = np.asarray(_read(torch.cat([leaf.reshape(-1) for leaf in y0]).double()),
                         np.float64)
    t_np = np.asarray(t, np.float64)
    sol = solve_ivp(rhs, t_span=(t_np[0], t_np[-1]), y0=y_start, t_eval=t_np,
                    method=solver, rtol=rtol, atol=atol, **kwargs)
    ys = torch.from_numpy(np.ascontiguousarray(sol.y.T)).to(device=device, dtype=dtype)
    out = [part.reshape((len(t_np),) + tuple(shape))
           for part, shape in zip(ys.split(sizes, dim=1), shapes)]
    _count(solves=1, nfe=nfe[0], accepted=len(sol.t))
    return out, _stats(nfe[0], len(sol.t), 0)


# ---------------------------------------------------------------------------
# Adaptive solver (reference rk_common.py:216-305 semantics incl. the
# min_step/max_step modification), the controller on the host
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RKState:
    y1: list
    f1: list
    t0: Any
    t1: Any
    dt: Any
    nfe: int
    accepted: int
    rejected: int
    # The last accepted step's (y0, y1, stages, dt), for its dense output,
    # and that output once fitted.
    last: Optional[tuple] = None
    fit: Optional[list] = None


def _special_grids(tableau: ButcherTableau, t, S, step_t, jump_t):
    """Sorted (special_t, jump_t) discontinuity grids (host arrays of the
    state's dtype)."""
    step_t = (_cast(np.zeros((0,)), S) if step_t is None
              else np.sort(_cast(_host(step_t), S)))
    if tableau.mid is None and tableau.order > 4:
        # High-order tableau without a matching dense output (DOP853): land
        # exactly on the requested times instead of interpolating with the
        # (order-3) Hermite fallback.
        step_t = np.sort(np.concatenate([step_t, _cast(t[1:], S)]))
    jump_t = (_cast(np.zeros((0,)), S) if jump_t is None
              else np.sort(_cast(_host(jump_t), S)))
    return np.sort(np.concatenate([step_t, jump_t])), jump_t


class _Controller:
    """The accept/reject controller with the reference's min/max-step
    semantics (``_adaptive_machinery``): ``start()`` then ``attempt(s)``
    per step; ``attempt`` reads the error ratio once."""

    def __init__(self, func, y0, t, tableau, rtol, atol, min_step, max_step,
                 first_step, safety, ifactor, dfactor, step_t=None, jump_t=None,
                 error_weights=None, error_blocks=False):
        S = _NUMPY[y0[0].dtype]
        self.S, self.func, self.y0, self.tableau = S, func, y0, tableau
        self.t = _cast(t, S)
        self.rtol, self.atol = S(rtol), S(atol)
        self.min_step, self.max_step = S(min_step), S(max_step)
        self.min_step_given = min_step > 0
        self.first_step = first_step
        self.safety, self.ifactor, self.dfactor = S(safety), S(ifactor), S(dfactor)
        self.n_stages = len(tableau.c_sol)
        self.special, self.jumps = _special_grids(tableau, self.t, S, step_t, jump_t)
        self.norm = _ErrorNorm(y0, error_weights, error_blocks)

    def start(self) -> _RKState:
        S, t0 = self.S, self.t[0]
        f0 = self.func(t0, self.y0)
        nfe = 1
        with torch.no_grad():
            if self.first_step is None:
                dt0 = _select_initial_step(self.func, t0, self.y0, self.tableau.order - 1,
                                           self.rtol, self.atol, f0)
                nfe += 1
            else:
                dt0 = S(self.first_step)
        if self.min_step_given:
            dt0 = np.maximum(dt0, self.min_step)
        dt0 = S(np.minimum(dt0, self.max_step))
        return _RKState(y1=list(self.y0), f1=f0, t0=t0, t1=t0, dt=dt0, nfe=nfe,
                        accepted=0, rejected=0)

    def clamp(self, t0, dt):
        """(dt, t1, t1_eval): the step clamped onto the next declared
        discontinuity, with its endpoint stages' time (the left limit when
        it lands on one)."""
        t1 = t0 + dt
        if self.special.shape[0] == 0:
            return dt, t1, None
        n = self.special.shape[0]
        nxt_i = int(np.searchsorted(self.special, t0, side="right"))
        nxt = self.special[min(nxt_i, n - 1)]
        if nxt_i < n and t0 < nxt < t1:
            t1 = nxt
        dt = self.S(t1 - t0)
        lands = bool((self.special == t1).any())
        return dt, t1, (_nextafter(t1, t0) if lands else t1)

    def jump_reseed(self, t1):
        """The time just past a declared jump that t1 lands on, else None."""
        if self.jumps.shape[0] and bool((self.jumps == t1).any()):
            return _nextafter(t1, t1 + self.S(1))
        return None

    def error_ratio(self, err, y0, y1, k, dt) -> torch.Tensor:
        tab = self.tableau
        scale = torch._foreach_add(torch._foreach_mul(torch._foreach_maximum(
            torch._foreach_abs(y0), torch._foreach_abs(y1)), float(self.rtol)),
            float(self.atol))
        if tab.c_error_alt is None:
            return self.norm.ratio(torch._foreach_div(err, scale))
        # DOP853 blended 5th/3rd-order error (Hairer; scipy semantics).
        err5 = torch._foreach_div(torch._foreach_div(err, float(dt)), scale)
        err3 = torch._foreach_div(_lincomb(tab.c_error_alt, k), scale)
        return self.norm.blended(err5, err3, float(abs(dt)))

    def judge(self, dt, ratio):
        """(accept, next step size) of an attempted step of size ``dt``
        whose error ratio the host read (host scalars)."""
        S = self.S
        accept = bool(ratio <= 1.0)
        if dt > self.max_step:
            accept = False
        if dt <= self.min_step:
            accept = True
        with np.errstate(all="ignore"):
            dt_next = _optimal_step_size(dt, ratio, self.safety, self.ifactor,
                                         self.dfactor, self.tableau.order)
            dt_next = S(np.minimum(np.maximum(dt_next, self.min_step), self.max_step))
        return accept, dt_next

    def attempt(self, s: _RKState):
        """One attempted step: (new state, the step's (t0, dt, t1, t1_eval,
        reseed time) if accepted else None)."""
        S = self.S
        t0 = s.t1
        dt, t1, t1_eval = self.clamp(t0, s.dt)
        y1, f1, err, k = _runge_kutta_step(self.func, s.y1, s.f1, t0, dt, self.tableau,
                                           t1_eval)
        ratio = S(_read(self.error_ratio(err, s.y1, y1, k, dt))[0])
        accept, dt_next = self.judge(dt, ratio)
        nfe = s.nfe + self.n_stages - 1
        if not accept:
            return dataclasses.replace(s, dt=dt_next, nfe=nfe, rejected=s.rejected + 1), None
        reseed = self.jump_reseed(t1)
        if reseed is not None:
            # An accepted step ending exactly on a declared jump must not
            # seed the next step's FSAL stage with the left-side derivative
            # (the reference's Perturb.NEXT, rk_common.py:295-297).
            f1 = self.func(reseed, y1)
            nfe += 1
        new = _RKState(y1=y1, f1=f1, t0=t0, t1=t1, dt=dt_next, nfe=nfe,
                       accepted=s.accepted + 1, rejected=s.rejected,
                       last=(s.y1, y1, k, dt))
        return new, (t0, dt, t1, t1_eval, reseed)

    def output(self, s: _RKState, t_out):
        """y(t_out) from the last accepted step's dense output."""
        if s.fit is None:
            s.fit = _fit_from_stages(*s.last[:3], s.last[3], self.tableau)
        with np.errstate(all="ignore"):
            x = self.S((t_out - s.t0) / (s.t1 - s.t0))
        return _interp_evaluate(s.fit, x)


def _nan_like(y):
    return [torch.full_like(l, float("nan")) for l in y]


def _adaptive_integrate(func, y0, t, tableau, max_num_steps, **kw):
    ctl = _Controller(func, y0, t, tableau, **kw)
    s = ctl.start()
    t = ctl.t
    outs = [list(y0)]
    for t_out in t[1:]:
        # s.dt > 0 fails when the controller collapses (a NaN state makes the
        # ratio NaN, which propagates into dt): exit instead of spinning.
        while t_out > s.t1 and s.accepted + s.rejected < max_num_steps and s.dt > 0:
            s, _ = ctl.attempt(s)
        if t_out <= t[0]:
            outs.append(list(y0))
        elif t_out > s.t1:
            # Budget exhausted (or controller collapsed) before t_out:
            # NaN-poison instead of extrapolating the dense output.
            outs.append(_nan_like(y0))
        else:
            outs.append(ctl.output(s, t_out))
    _count(solves=1, nfe=s.nfe, accepted=s.accepted, rejected=s.rejected)
    return _stack(outs), _stats(s.nfe, s.accepted, s.rejected)


def _adaptive_integrate_diff(func, y0, t, t_tensor, tableau, max_num_steps, max_steps,
                             needs_grad, **kw):
    """Reverse-differentiable adaptive solve (discretise-then-optimise).

    With no gradient needed, the plain solve.  Otherwise the controller
    first finds the accepted-step grid under no grad (at most
    ``max_steps`` steps), then the trajectory is replayed over that grid
    with grad, with the same stage arithmetic, so the replay's dense
    outputs are the values and autograd differentiates them; step sizes
    are constants, as in the adjoint.  Outputs the grid did not reach
    (budget exhausted, ``stats["grid_exhausted"]``) are NaN, and NaN
    cotangents are zeroed.  A ``t_tensor`` that requires grad gets its
    gradient through the dense-output evaluation."""
    if not needs_grad:
        ys, stats = _adaptive_integrate(func, y0, t, tableau, max_num_steps, **kw)
        stats["grid_exhausted"] = torch.tensor(False)
        return ys, stats
    ctl = _Controller(func, y0, t, tableau, **kw)
    t = ctl.t
    t_end = t[-1]
    steps = []
    with torch.no_grad():
        s = ctl.start()
        while (s.t1 < t_end and s.accepted + s.rejected < max_num_steps
               and len(steps) < max_steps and s.dt > 0):
            s, step = ctl.attempt(s)
            if step is not None:
                steps.append(step)
    _count(solves=1, nfe=s.nfe, accepted=s.accepted, rejected=s.rejected)
    exhausted = bool(s.t1 < t_end)
    ts_full = [t[0]] + [step[2] for step in steps]

    # Which recorded step each output falls in (its left end < t_out <= its
    # right end), as the recorded-output lookup of the JAX package.
    wanted = {}
    for j, t_out in enumerate(t[1:]):
        if t_out <= t[0] or (exhausted and t_out > s.t1) or not steps:
            continue
        i = min(max(bisect.bisect_left(ts_full, t_out) - 1, 0), len(steps) - 1)
        wanted.setdefault(i, []).append(j)

    outs = [None] * (len(t) - 1)
    with counting_as("replay"):
        f = func(ts_full[0], y0)
        y, evals = list(y0), 1
        for i, (a, dt, b, t1_eval, reseed) in enumerate(steps):
            y1, f1, _, k = _runge_kutta_step(func, y, f, a, dt, tableau, t1_eval,
                                             error=False)
            evals += len(tableau.c_sol) - 1
            if i in wanted:
                fit = _fit_from_stages(y, y1, k, dt, tableau)
                denom = b - a if b != a else ctl.S(1)
                for j in wanted[i]:
                    if t_tensor is not None and t_tensor.requires_grad:
                        x = (t_tensor[j + 1].to(y0[0].dtype) - float(a)) / float(denom)
                    else:
                        x = ctl.S((t[j + 1] - a) / denom)
                    outs[j] = _interp_evaluate(fit, x)
            if reseed is not None:
                f1 = func(reseed, y1)
                evals += 1
            y, f = y1, f1
        _count(evals=evals)
    for j, t_out in enumerate(t[1:]):
        if outs[j] is None:
            outs[j] = list(y0) if t_out <= t[0] else _nan_like(y0)
    ys = _stack([list(y0)] + outs)
    for leaf in ys:
        if leaf.requires_grad:
            # NaN rows of the cotangent (poisoned outputs) would corrupt every
            # gradient; zero them -- the loss is already NaN-loud.
            leaf.register_hook(lambda g: torch.where(torch.isnan(g), torch.zeros_like(g), g))
    stats = _stats(s.nfe, s.accepted, s.rejected, grid_exhausted=exhausted)
    return ys, stats


def _resolve_max_steps(max_steps_opt, t, min_step, step_t, jump_t):
    """Accepted-step budget of the differentiable adaptive solve.  With a
    bounded step (``min_step > 0``) the exact worst case is span/min_step
    plus one clamped landing per declared discontinuity; otherwise a
    length-based heuristic."""
    if max_steps_opt is not None:
        return int(max_steps_opt)
    n_special = 0
    for extra in (step_t, jump_t):
        if extra is not None:
            n_special += int(_host(extra).shape[0])
    if min_step > 0:
        span = float(t[-1] - t[0])
        return int(np.ceil(span / min_step + 1e-9)) + n_special + 4
    return 16 * int(t.shape[0]) + n_special + 64


def _substeps_from_options(options: dict, t) -> int:
    """Grid-from-step_size contract (reference solvers.py:77-88): an
    explicit ``substeps`` wins; otherwise ``ceil(max spacing of t /
    step_size)`` steps per output interval; else one."""
    substeps = int(options.pop("substeps", 0))
    step_size = options.pop("step_size", None)
    if substeps:
        return substeps
    if step_size is not None:
        spacing = float(np.max(np.diff(_host(t))))
        return max(1, int(np.ceil(spacing / float(step_size) - 1e-9)))
    return 1


def _host(x) -> np.ndarray:
    """Times or grids as a host array (one counted read for a device
    tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type != "cpu":
            _count(reads=1)
        if x.dtype == torch.bfloat16:
            return _cast(x.cpu().float().numpy(), _Bf16)
        return x.cpu().numpy()
    return np.asarray(x)


def _host_tensor(x: torch.Tensor) -> torch.Tensor:
    """A CPU copy of times (one counted read for a device tensor)."""
    if x.device.type != "cpu":
        _count(reads=1)
    return x.detach().cpu()


def _time_dtype(t_host: np.ndarray) -> torch.dtype:
    """The torch dtype of host times (an object array holds bf16 times)."""
    return torch.bfloat16 if t_host.dtype == object else torch.from_numpy(t_host[:0]).dtype


# ---------------------------------------------------------------------------
# K lanes: the adaptive and Adams solves of a ``torch.func.vmap`` (a
# training wave's K models).  The JAX package's vmapped ``lax.while_loop``
# gives every lane its own t, dt and accept/reject decisions and runs
# until every lane is done.  Here K host controllers run side by side:
# every attempt evaluates the stages of all K lanes at once (the field
# under ``torch.func.vmap``, so the fused field takes its kernels' multi
# entries), each lane at its own times, and reads the K error ratios in one
# device read; a lane that is done, or that is waiting for the others,
# rides the attempt masked (its step size 0, its state kept by a
# ``torch.where``), as the batched while-loop does.  Each lane's host
# arithmetic is its serial controller's (:meth:`_Controller.clamp`,
# :meth:`_Controller.judge`), so its accepted grid is its serial solve's.
# ---------------------------------------------------------------------------


def _batched(tensors) -> bool:
    """Whether any of ``tensors`` is a ``torch.func.vmap`` lane tensor."""
    return any(isinstance(x, torch.Tensor) and torch._C._functorch.is_batchedtensor(x)
               for x in tensors)


def _per_lane(col: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (K,) column shaped to broadcast against a (K, ...) leaf."""
    return col.reshape((-1,) + (1,) * (like.dim() - 1))


def _add_scaled_lanes(y, h, s):
    """y + h * s leaf by leaf, ``h`` a (K,) column (one multiply and one add,
    as :func:`_add_scaled`)."""
    if s is None:
        return list(y)
    return [yl + sl * _per_lane(h, sl) for yl, sl in zip(y, s)]


def _where_lanes(mask, a, b):
    """Lane by lane, ``a``'s leaves where ``mask`` (a (K,) bool tensor), else
    ``b``'s."""
    return [torch.where(_per_lane(mask, x), x, y) for x, y in zip(a, b)]


def _stage_times(tableau: ButcherTableau, t0, dt, t1_eval):
    """The stages' evaluation times of one step, as :func:`_runge_kutta_step`
    computes them on the host."""
    S = type(dt)
    out = []
    for alpha_i in tableau.alpha:
        ti = t0 + dt * S(alpha_i)
        if alpha_i == 1.0 and t1_eval is not None:
            ti = t1_eval
        out.append(ti)
    return out


def _runge_kutta_step_lanes(func_k, y0, f0, times, dt, tableau: ButcherTableau,
                            error=True):
    """:func:`_runge_kutta_step` for K lanes: ``times`` (stages - 1, K) the
    stages' times, ``dt`` the (K,) step sizes, both on the device."""
    k = [f0]
    for i, beta_row in enumerate(tableau.beta):
        k.append(func_k(times[i], _add_scaled_lanes(y0, dt, _lincomb(beta_row, k))))
    y1 = _add_scaled_lanes(y0, dt, _lincomb(tableau.c_sol, k))
    err = None
    if error:
        err = [e * _per_lane(dt, e) for e in _lincomb(tableau.c_error, k)]
    return y1, k[-1], err, k


def _fit_from_stages_lanes(y0, y1, k, cols, tableau: ButcherTableau):
    """:func:`_fit_from_stages` for K lanes; ``cols`` holds the (K,)
    columns ``dt``, ``2 dt`` and ``dt / 8`` (host products in the state's
    dtype, as the serial fit's)."""
    dt, h2, q = cols
    if tableau.mid is not None:
        y_mid = _add_scaled_lanes(y0, dt, _lincomb(tableau.mid, k))
    else:
        y_mid = [(a + b) * 0.5 + (k0 - kl) * _per_lane(q, a)
                 for a, b, k0, kl in zip(y0, y1, k[0], k[-1])]
    out = []
    for y0l, y1l, yml, f0l, f1l in zip(y0, y1, y_mid, k[0], k[-1]):
        h, h2l = _per_lane(dt, y0l), _per_lane(h2, y0l)
        a = (f1l - f0l) * h2l - (y1l + y0l) * 8.0 + yml * 16.0
        b = (f0l * 5.0 - f1l * 3.0) * h + y0l * 18.0 + y1l * 14.0 - yml * 32.0
        c = (f1l - f0l * 4.0) * h - y0l * 11.0 - y1l * 5.0 + yml * 16.0
        out.append((a, b, c, f0l * h, y0l))
    return out


def _interp_evaluate_lanes(coeffs, x):
    """:func:`_interp_evaluate` at a (K,) column of fractions."""
    out = []
    for leaf in coeffs:
        acc = leaf[0]
        xl = _per_lane(x, acc)
        for c in leaf[1:]:
            acc = acc * xl + c
        out.append(acc)
    return out


class _Lanes:
    """The host state of K lanes of one adaptive solve: each lane's times,
    step size and counts in host arrays (of the state's scalar type); the
    states and FSAL derivatives stacked on the device."""

    def __init__(self, k, t0, dt0, nfe, y, f):
        self.t0 = np.full(k, t0, dtype=object)
        self.t1 = np.full(k, t0, dtype=object)
        self.dt = np.asarray(dt0, dtype=object)
        self.nfe = np.full(k, nfe, np.int64)
        self.accepted = np.zeros(k, np.int64)
        self.rejected = np.zeros(k, np.int64)
        self.y, self.f = y, f


class _LaneController:
    """K lanes of a :class:`_Controller` (see the section's comment).
    ``func_k(t, y)`` evaluates the field for every lane: ``t`` a (K,)
    tensor of times, ``y`` a list of (K, ...) leaves."""

    def __init__(self, func_k, y0, k, t, tableau, **kw):
        self.ctl = _Controller(None, [leaf[0] for leaf in y0], t, tableau, **kw)
        if self.ctl.S is _Bf16:
            raise ValueError("a bfloat16 adaptive solve does not wave (ROADMAP item 17d)")
        self.func_k, self.y0, self.k = func_k, list(y0), k
        self.S, self.tableau = self.ctl.S, tableau
        self.device = y0[0].device
        self.attempts = 0
        self.wasted = 0

    def column(self, values) -> torch.Tensor:
        """Host values of the state's dtype as a device tensor (one copy)."""
        return torch.from_numpy(np.asarray(values, dtype=self.S)).to(self.device)

    def evals(self, n: int = 1) -> None:
        _count(lane_evals=n)

    def start(self) -> _Lanes:
        ctl, S, k = self.ctl, self.S, self.k
        t0 = ctl.t[0]
        f0 = self.func_k(self.column([t0] * k), self.y0)
        self.evals()
        nfe = 1
        with torch.no_grad():
            if ctl.first_step is None:
                dt0 = self.initial_steps(t0, f0)
                nfe += 1
            else:
                dt0 = [S(ctl.first_step)] * k
        out = []
        for d in dt0:
            if ctl.min_step_given:
                d = np.maximum(d, ctl.min_step)
            out.append(S(np.minimum(d, ctl.max_step)))
        return _Lanes(k, t0, out, nfe, list(self.y0), f0)

    def initial_steps(self, t0, f0):
        """:func:`_select_initial_step` for every lane: the lanes' norms
        and h0 on the device, read once."""
        ctl, k, y0 = self.ctl, self.k, self.y0
        scale = torch._foreach_add(torch._foreach_mul(torch._foreach_abs(y0), float(ctl.rtol)),
                                   float(ctl.atol))
        n = sum(leaf[0].numel() for leaf in y0)

        def rms(xs):
            q = torch._foreach_div(xs, scale)
            return torch.stack([_rms(_norms([leaf[j] for leaf in q]), n) for j in range(k)])

        d0, d1 = rms(y0), rms(f0)
        small = (d0 < 1e-5) | (d1 < 1e-5)
        h0 = torch.where(small, torch.full_like(d0, 1e-6),
                         0.01 * d0 / torch.where(d1 == 0, torch.ones_like(d1), d1))
        y1 = [yl + _per_lane(h0, fl) * fl for yl, fl in zip(y0, f0)]
        f1 = self.func_k(float(t0) + h0, y1)
        self.evals()
        d2 = rms(torch._foreach_sub(f1, f0)) / h0
        vals = np.asarray(_read(torch.stack([d0, d1, d2, h0]))).reshape(4, k)
        return [_initial_step_host(self.S, self.tableau.order - 1, *vals[:, j])
                for j in range(k)]

    def ratios(self, err, y0, y1, k, dts):
        """Every lane's error ratio, one device read."""
        ctl, tab = self.ctl, self.tableau
        scale = torch._foreach_add(torch._foreach_mul(torch._foreach_maximum(
            torch._foreach_abs(y0), torch._foreach_abs(y1)), float(ctl.rtol)), float(ctl.atol))
        lanes = range(self.k)
        if tab.c_error_alt is None:
            out = ctl.norm.ratio_lanes(torch._foreach_div(err, scale), self.k)
        else:
            dt_col = self.column(dts)
            err5 = torch._foreach_div([e / _per_lane(dt_col, e) for e in err], scale)
            err3 = torch._foreach_div(_lincomb(tab.c_error_alt, k), scale)
            out = torch.stack([ctl.norm.blended([x[j] for x in err5], [x[j] for x in err3],
                                                float(abs(dts[j]))) for j in lanes])
        return [self.S(v) for v in _read(out)]

    def attempt(self, st: _Lanes, active, fits: bool = False):
        """One attempt of the lanes in ``active`` (host bools); the others
        ride masked.  Updates ``st`` and returns each lane's accepted step
        ``(t0, dt, t1, t1_eval, reseed)`` or None, with the accepted steps'
        dense-output fits (stacked, every lane's) when ``fits``."""
        ctl, S, k = self.ctl, self.S, self.k
        rows, plans = [], []
        for j in range(k):
            if active[j]:
                dt, t1, t1_eval = ctl.clamp(st.t1[j], st.dt[j])
            else:
                dt, t1, t1_eval = S(0), st.t1[j], None
            plans.append((dt, t1, t1_eval))
            rows.append([dt, S(2) * dt, S(0.125) * dt]
                        + _stage_times(self.tableau, st.t1[j], dt, t1_eval))
        table = self.column(np.asarray(rows, dtype=object).T)    # a row per column
        y1, f1, err, stages = _runge_kutta_step_lanes(self.func_k, st.y, st.f, table[3:],
                                                      table[0], self.tableau)
        self.evals(len(self.tableau.alpha))
        ratios = self.ratios(err, st.y, y1, stages, [p[0] for p in plans])
        self.attempts += 1
        self.wasted += int(k - np.count_nonzero(active))
        steps = [None] * k
        accept = np.zeros(k, bool)
        reseeds = []
        for j in range(k):
            if not active[j]:
                continue
            dt, t1, t1_eval = plans[j]
            ok, dt_next = ctl.judge(dt, ratios[j])
            st.nfe[j] += ctl.n_stages - 1
            st.dt[j] = dt_next
            if not ok:
                st.rejected[j] += 1
                continue
            accept[j] = True
            reseed = ctl.jump_reseed(t1)
            if reseed is not None:
                reseeds.append((j, reseed))
                st.nfe[j] += 1
            steps[j] = (st.t1[j], dt, t1, t1_eval, reseed)
            st.t0[j], st.t1[j] = st.t1[j], t1
            st.accepted[j] += 1
        fit = None
        if accept.any():
            mask = torch.from_numpy(accept).to(self.device)
            if fits:
                fit = (mask, _fit_from_stages_lanes(st.y, y1, stages, table[:3], self.tableau))
            st.y = _where_lanes(mask, y1, st.y)
            st.f = _where_lanes(mask, f1, st.f)
        if reseeds:
            # An accepted step ending on a declared jump seeds the next
            # step's FSAL stage just past it (:meth:`_Controller.attempt`).
            col = self.column([dict(reseeds).get(j, st.t1[j]) for j in range(k)])
            fr = self.func_k(col, st.y)
            self.evals()
            mask = torch.zeros(k, dtype=torch.bool)
            mask[[j for j, _ in reseeds]] = True
            st.f = _where_lanes(mask.to(self.device), fr, st.f)
        return steps, fit

    def count(self, st: _Lanes) -> None:
        _count(solves=self.k, lane_solves=1, nfe=int(st.nfe.sum()),
               accepted=int(st.accepted.sum()), rejected=int(st.rejected.sum()),
               attempts=self.attempts, wasted=self.wasted)


def _lane_stats(st: _Lanes, **extra):
    out = {"nfe": torch.tensor(st.nfe, dtype=torch.int32),
           "accepted": torch.tensor(st.accepted, dtype=torch.int32),
           "rejected": torch.tensor(st.rejected, dtype=torch.int32)}
    out.update({key: torch.tensor(v) for key, v in extra.items()})
    return out


def _adaptive_integrate_lanes(func_k, y0, k, t, tableau, max_num_steps, **kw):
    """:func:`_adaptive_integrate` for K lanes: each lane's outputs from its
    own last accepted step's dense output, as its serial solve's.  Returns
    (per leaf (K, len(t), ...), per-lane stats)."""
    lc = _LaneController(func_k, y0, k, t, tableau, **kw)
    st = lc.start()
    t = lc.ctl.t
    n_out = len(t) - 1
    nxt = np.zeros(k, np.int64)             # each lane's next output
    outs = [None] * n_out
    fit = None                              # the lanes' last accepted fits

    def needs_step(j):
        t_out = t[1 + nxt[j]]
        return (t_out > st.t1[j] and st.accepted[j] + st.rejected[j] < max_num_steps
                and st.dt[j] > 0)

    while True:
        emits = {}
        for j in range(k):
            while nxt[j] < n_out and not needs_step(j):
                emits.setdefault(int(nxt[j]), []).append(j)
                nxt[j] += 1
        for i, lanes in emits.items():
            t_out = t[1 + i]
            if t_out <= t[0]:
                value = list(y0)
            else:
                dense = [j for j in lanes if t_out <= st.t1[j]]
                value = _nan_like(y0)
                if dense:
                    with np.errstate(all="ignore"):
                        xs = [lc.S((t_out - st.t0[j]) / (st.t1[j] - st.t0[j])) if j in dense
                              else lc.S(0) for j in range(k)]
                    picked = torch.zeros(k, dtype=torch.bool)
                    picked[dense] = True
                    value = _where_lanes(picked.to(lc.device),
                                         _interp_evaluate_lanes(fit, lc.column(xs)), value)
            if outs[i] is None:
                outs[i] = value
            else:
                mask = torch.zeros(k, dtype=torch.bool)
                mask[lanes] = True
                outs[i] = _where_lanes(mask.to(lc.device), value, outs[i])
        if (nxt >= n_out).all():
            break
        active = np.asarray([nxt[j] < n_out for j in range(k)])
        _, new = lc.attempt(st, active, fits=True)
        if new is not None:
            mask, coeffs = new
            fit = coeffs if fit is None else [
                tuple(torch.where(_per_lane(mask, a), a, b) for a, b in zip(na, oa))
                for na, oa in zip(coeffs, fit)]
    lc.count(st)
    ys = [torch.stack([o[i] for o in [list(y0)] + outs], dim=1) for i in range(len(y0))]
    return ys, _lane_stats(st)


def _adaptive_integrate_diff_lanes(func_k, y0, k, t, t_tensor, tableau, max_num_steps,
                                   max_steps, needs_grad, **kw):
    """:func:`_adaptive_integrate_diff` for K lanes: each lane's accepted
    grid found under no grad by the K-lane controller, then the lanes
    replayed together with grad over their grids padded to the longest (a
    padded step has dt = 0 and leaves its lane's state as it is), each
    lane's outputs from its own steps' dense outputs."""
    if not needs_grad:
        ys, stats = _adaptive_integrate_lanes(func_k, y0, k, t, tableau, max_num_steps, **kw)
        stats["grid_exhausted"] = torch.zeros(k, dtype=torch.bool)
        return ys, stats
    if t_tensor is not None and t_tensor.requires_grad:
        raise ValueError("output times that take gradients do not wave (ROADMAP item 17d)")
    lc = _LaneController(func_k, y0, k, t, tableau, **kw)
    S, t = lc.S, lc.ctl.t
    t_end = t[-1]
    steps = [[] for _ in range(k)]
    with torch.no_grad():
        st = lc.start()

        def going(j):
            return (st.t1[j] < t_end and st.accepted[j] + st.rejected[j] < max_num_steps
                    and len(steps[j]) < max_steps and st.dt[j] > 0)

        active = np.asarray([going(j) for j in range(k)])
        while active.any():
            accepted, _ = lc.attempt(st, active)
            for j, step in enumerate(accepted):
                if step is not None:
                    steps[j].append(step)
            active = np.asarray([going(j) for j in range(k)])
    lc.count(st)
    exhausted = [bool(st.t1[j] < t_end) for j in range(k)]

    # Which recorded step each output falls in, lane by lane.
    n_out = len(t) - 1
    where_out = np.full((k, n_out), -1, np.int64)
    xs = np.zeros((k, n_out), dtype=object)
    for j in range(k):
        ts_full = [t[0]] + [step[2] for step in steps[j]]
        for o, t_out in enumerate(t[1:]):
            if t_out <= t[0] or (exhausted[j] and t_out > st.t1[j]) or not steps[j]:
                continue
            i = min(max(bisect.bisect_left(ts_full, t_out) - 1, 0), len(steps[j]) - 1)
            a, _, b, _, _ = steps[j][i]
            denom = b - a if b != a else S(1)
            where_out[j, o] = i
            xs[j, o] = S((t_out - a) / denom)
    n_max = max(len(lane) for lane in steps)
    rows = np.zeros((n_max, 4 + len(tableau.alpha), k), dtype=object)
    live = np.zeros((n_max, k), bool)
    for j in range(k):
        t_last = t[0]
        for i in range(n_max):
            if i < len(steps[j]):
                a, dt, b, t1_eval, reseed = steps[j][i]
                live[i, j] = True
                rows[i, :, j] = ([dt, S(2) * dt, S(0.125) * dt,
                                  reseed if reseed is not None else b]
                                 + _stage_times(tableau, a, dt, t1_eval))
                t_last = b
            else:
                rows[i, :, j] = [S(0)] * 3 + [t_last] * (1 + len(tableau.alpha))
    outs = [list(y0) if t_out <= t[0] else _nan_like(y0) for t_out in t[1:]]
    with counting_as("replay"):
        if n_max:
            table = lc.column(rows.astype(S))
            live_dev = torch.from_numpy(live).to(lc.device)
            x_dev = lc.column(xs.T.astype(S))
        f = func_k(lc.column([t[0]] * k), y0)
        y, evals = list(y0), 1
        for i in range(n_max):
            row = table[i]
            y1, f1, _, stages = _runge_kutta_step_lanes(func_k, y, f, row[4:], row[0],
                                                        tableau, error=False)
            evals += len(tableau.alpha)
            wanted = sorted({o for j in range(k) for o in np.flatnonzero(where_out[j] == i)})
            if wanted:
                fit = _fit_from_stages_lanes(y, y1, stages, row[:3], tableau)
                for o in wanted:
                    mask = torch.from_numpy(where_out[:, o] == i).to(lc.device)
                    outs[o] = _where_lanes(mask, _interp_evaluate_lanes(fit, x_dev[o]),
                                           outs[o])
            reseeding = [j for j in range(k) if live[i, j] and steps[j][i][4] is not None]
            if reseeding:
                fr = func_k(row[3], y1)
                evals += 1
                mask = torch.zeros(k, dtype=torch.bool)
                mask[reseeding] = True
                f1 = _where_lanes(mask.to(lc.device), fr, f1)
            y = _where_lanes(live_dev[i], y1, y)
            f = _where_lanes(live_dev[i], f1, f)
        _count(evals=evals * k, lane_evals=evals)
    ys = [torch.stack([o[i] for o in [list(y0)] + outs], dim=1) for i in range(len(y0))]
    for leaf in ys:
        if leaf.requires_grad:
            leaf.register_hook(lambda g: torch.where(torch.isnan(g), torch.zeros_like(g), g))
    return ys, _lane_stats(st, grid_exhausted=exhausted)


def _adaptive_kwargs(options: dict, rtol, atol, per_leaf: bool) -> dict:
    """The adaptive controller's settings, popped from ``options``."""
    return dict(
        rtol=rtol, atol=atol,
        min_step=float(options.pop("min_step", 0.0)),
        max_step=float(options.pop("max_step", float("inf"))),
        first_step=options.pop("first_step", None),
        safety=float(options.pop("safety", 0.9)),
        ifactor=float(options.pop("ifactor", 10.0)),
        dfactor=float(options.pop("dfactor", 0.2)),
        step_t=options.pop("step_t", None),
        jump_t=options.pop("jump_t", None),
        error_weights=options.pop("error_weights", None),
        error_blocks=per_leaf,
    )


def odeint_lanes(func_k, y0, t_host, k: int, *, rtol, atol, method: str, options: dict,
                 per_leaf: bool, needs_grad: bool = False, t_tensor=None,
                 time_dtype=None):
    """``odeint``'s solve for K lanes of stacked leaves: ``func_k(t, y)``
    takes a (K,) tensor of times and a list of (K, ...) leaves.  Returns
    (per leaf (K, len(t), ...), per-lane stats).  The fixed and Adams
    methods step every lane on the shared grid; the adaptive ones run
    :class:`_LaneController` (differentiable when ``options`` asks for it
    and ``needs_grad``).  ``scipy_solver`` does not wave: the JAX package
    cannot trace its host callback either."""
    options = dict(options)
    S = _NUMPY[y0[0].dtype]
    device, dtype = y0[0].device, y0[0].dtype
    time_dtype = time_dtype or dtype

    def host_time_func(tt, yy):
        return func_k(torch.full((k,), float(tt), dtype=time_dtype, device=device), yy)

    def lane_major(ys):
        return [torch.movedim(leaf, 0, 1) for leaf in ys]

    def lane_stats(stats):
        return {key: v.expand(k) if v.dim() == 0 else v for key, v in stats.items()}

    if method in FIXED_METHODS:
        options.pop("remat", None)
        if options.pop("grid_constructor", None) is not None:
            raise ValueError("a grid_constructor solve does not wave (ROADMAP item 17d)")
        ys, stats = _fixed_grid_integrate(host_time_func, y0, t_host, S, method,
                                          _substeps_from_options(options, t_host))
        _count(lane_evals=int(stats["nfe"]))
        return lane_major(ys), lane_stats(stats)
    if method in ADAMS_METHODS:
        ys, stats = _adams_integrate(
            host_time_func, y0, t_host, S, _substeps_from_options(options, t_host),
            correct=method == "implicit_adams", rtol=float(rtol), atol=float(atol),
            max_order=int(options.pop("max_order", _ADAMS_MAX_ORDER)),
            max_iters=int(options.pop("max_iters", _ADAMS_MAX_ITERS)), lanes=k)
        _count(lane_evals=int(stats["nfe"]))
        return lane_major(ys), lane_stats(stats)
    if method == "scipy_solver":
        raise ValueError("scipy_solver does not wave: its solve is a host callback, which "
                         "the JAX package cannot trace under jax.vmap either")
    if method not in ADAPTIVE_METHODS:
        raise ValueError(f"Unknown method {method!r}")
    differentiable = bool(options.pop("differentiable", False))
    max_steps_opt = options.pop("max_steps", None)
    kwargs = _adaptive_kwargs(options, rtol, atol, per_leaf)
    max_num_steps = int(options.pop("max_num_steps", 2**31 - 1))
    tab = ADAPTIVE_METHODS[method]
    if differentiable:
        n_landings = len(t_host) - 1 if (tab.mid is None and tab.order > 4) else 0
        max_steps = _resolve_max_steps(
            max_steps_opt, t_host, kwargs["min_step"], kwargs["step_t"],
            kwargs["jump_t"]) + (0 if max_steps_opt is not None else n_landings)
        return _adaptive_integrate_diff_lanes(func_k, y0, k, t_host, t_tensor, tab,
                                              max_num_steps, max_steps, needs_grad, **kwargs)
    return _adaptive_integrate_lanes(func_k, y0, k, t_host, tab, max_num_steps, **kwargs)


class _LaneSolve(torch.autograd.Function):
    """``odeint``'s adaptive and Adams solves under ``torch.func.vmap``.
    Inputs ``(spec, *state leaves, *arg leaves)``; outputs the state's
    leaves at every output time and the stats.  Only its ``vmap`` rule
    runs: it stacks the lanes and solves them with :func:`odeint_lanes`
    on plain tensors, whose autograd graph (the replay's, or the solve's
    own for a plain adaptive solve, as serially) reaches the stacked
    weights; the wave's step differentiates it with plain autograd."""

    @staticmethod
    def forward(spec, *leaves):
        raise RuntimeError("the K-lane solve runs only under torch.func.vmap")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the K-lane solve is differentiated through its vmap rule's "
                           "graph")

    @staticmethod
    def vmap(info, in_dims, spec, *leaves):
        k = info.batch_size
        n_y = spec.n_y
        y = [leaf.movedim(d, 0) if d is not None
             else leaf.expand((k,) + tuple(leaf.shape)) for leaf, d in
             zip(leaves[:n_y], in_dims[1:1 + n_y])]
        args = [leaf if d is None else leaf.movedim(d, 0)
                for leaf, d in zip(leaves[n_y:], in_dims[1 + n_y:])]
        arg_dims = [None if d is None else 0 for d in in_dims[1 + n_y:]]
        needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (*y, *args))
        ys, stats = odeint_lanes(spec.func_k(k, args, arg_dims), y, spec.t_host, k,
                                 needs_grad=needs_grad, **spec.solve)
        spec.keys = sorted(stats)
        out = (*ys, *[stats[key] for key in spec.keys])
        return out, (0,) * len(out)


class _LaneSpec:
    """What :class:`_LaneSolve` needs besides tensors: the single-lane field
    ``flat(t, state leaves, arg leaves)`` and the solve's settings."""

    def __init__(self, flat, n_y, t_host, solve):
        self.flat, self.n_y, self.t_host, self.solve = flat, n_y, t_host, solve
        self.keys = None

    def func_k(self, k, args, arg_dims):
        """The K-lane field: the single-lane field under ``torch.func.vmap``
        over the lanes' times, states and arguments."""
        mapped = torch.func.vmap(self.flat, in_dims=(0, 0, arg_dims))

        def func_k(t, y):
            return mapped(t, list(y), list(args))

        return func_k


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def odeint(
    func: Callable[[Any, Any, Any], Any],
    y0,
    t,
    args: Any = None,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-9,
    method: str = "dopri5",
    options: Optional[dict] = None,
    return_stats: bool = False,
):
    """Integrate dy/dt = func(t, y, args) from t[0] through t, returning y at
    every requested time (ys[0] == y0), time-major.  API of the JAX
    package's ``odeint``: ``options`` understands ``step_size`` /
    ``substeps`` / ``remat`` / ``grid_constructor`` (fixed grid) and
    ``min_step`` / ``max_step`` / ``first_step`` / ``safety`` / ``ifactor``
    / ``dfactor`` / ``max_num_steps`` / ``step_t`` / ``jump_t`` /
    ``error_weights`` / ``differentiable`` / ``max_steps`` (adaptive),
    ``step_size`` / ``substeps`` / ``max_order`` / ``max_iters`` (the Adams
    methods, on uniformly spaced times) and ``solver`` / ``min_step`` /
    ``max_step`` (``scipy_solver``); a tuple state's error is normed per
    leaf and max-combined unless ``options={"norm": "rms"}``.  ``func`` gets its time as a 0-d tensor on
    the state's device (the state's dtype on the adaptive path, the times'
    on the fixed grid).  ``return_stats`` adds ``{"nfe", "accepted",
    "rejected"}`` (and ``"grid_exhausted"`` for a differentiable solve).
    """
    options = dict(options or {})
    leaves, rebuild = flatten(y0)
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    if dtype not in _NUMPY:
        raise ValueError(f"odeint takes float32, float64 and bfloat16 states, not {dtype}")
    S = _NUMPY[dtype]
    dtypes = [leaf.dtype for leaf in leaves]
    y = [leaf.to(dtype) for leaf in leaves]
    device = y[0].device
    t_tensor = t if isinstance(t, torch.Tensor) else None
    t_host = _host(t)
    per_leaf = not isinstance(y0, torch.Tensor)
    if options.pop("norm", None) == "rms":
        per_leaf = False

    def make_func(time_dtype):
        def flat_func(tt, yy):
            if not isinstance(tt, torch.Tensor):
                tt = torch.full((), float(tt), dtype=time_dtype, device=device)
            state = rebuild([l.to(d) for l, d in zip(yy, dtypes)])
            return [l.to(dtype) for l in flatten(func(tt, state, args))[0]]
        return flat_func

    if method not in FIXED_METHODS and _batched((*y, *flatten(args)[0], t_tensor)):
        ys, stats = _vmapped_solve(func, y, rebuild, dtypes, dtype, args, t_host, t_tensor,
                                   method, rtol, atol, options, per_leaf)
    elif method in FIXED_METHODS:
        remat = bool(options.pop("remat", False))
        grid_constructor = options.pop("grid_constructor", None)
        flat_func = make_func(_time_dtype(t_host))
        if grid_constructor is not None:
            if "step_size" in options or options.get("substeps"):
                raise ValueError(
                    "step_size and grid_constructor are mutually exclusive arguments.")
            grid = _host(grid_constructor(func, y0, t_tensor if t_tensor is not None
                                          else torch.from_numpy(t_host)))
            ys, stats = _grid_constructor_integrate(flat_func, y, t_host, S, method,
                                                    grid, remat)
        else:
            substeps = _substeps_from_options(options, t_host)
            ys, stats = _fixed_grid_integrate(flat_func, y, t_host, S, method, substeps,
                                              remat)
    elif method in ADAMS_METHODS:
        flat_func = make_func(_time_dtype(t_host))
        ys, stats = _adams_integrate(
            flat_func, y, t_host, S, _substeps_from_options(options, t_host),
            correct=method == "implicit_adams", rtol=float(rtol), atol=float(atol),
            max_order=int(options.pop("max_order", _ADAMS_MAX_ORDER)),
            max_iters=int(options.pop("max_iters", _ADAMS_MAX_ITERS)))
    elif method == "scipy_solver":
        ys, stats = _scipy_integrate(make_func(dtype), y, t_host, rtol, atol, options)
    elif method in ADAPTIVE_METHODS:
        flat_func = make_func(dtype)
        differentiable = bool(options.pop("differentiable", False))
        max_steps_opt = options.pop("max_steps", None)
        kwargs = _adaptive_kwargs(options, rtol, atol, per_leaf)
        max_num_steps = int(options.pop("max_num_steps", 2**31 - 1))
        tab = ADAPTIVE_METHODS[method]
        if differentiable:
            # DOP853 lands exactly on every output time, costing up to
            # len(t)-1 extra steps.
            n_landings = len(t_host) - 1 if (tab.mid is None and tab.order > 4) else 0
            max_steps = _resolve_max_steps(
                max_steps_opt, t_host, kwargs["min_step"], kwargs["step_t"],
                kwargs["jump_t"]) + (0 if max_steps_opt is not None else n_landings)
            arg_leaves = flatten(args)[0]
            needs_grad = torch.is_grad_enabled() and any(
                x.requires_grad for x in (*y, *arg_leaves,
                                          *([t_tensor] if t_tensor is not None else [])))
            ys, stats = _adaptive_integrate_diff(flat_func, y, t_host, t_tensor, tab,
                                                 max_num_steps, max_steps, needs_grad,
                                                 **kwargs)
        else:
            ys, stats = _adaptive_integrate(flat_func, y, t_host, tab, max_num_steps,
                                            **kwargs)
    else:
        raise ValueError(f"Unknown method {method!r}")

    ys = rebuild([l.to(d) for l, d in zip(ys, dtypes)])
    if return_stats:
        return ys, stats
    return ys


def _vmapped_solve(func, y, rebuild, dtypes, dtype, args, t_host, t_tensor, method, rtol,
                   atol, options, per_leaf):
    """``odeint``'s adaptive and Adams solves under ``torch.func.vmap``:
    through :class:`_LaneSolve`, whose vmap rule solves the K lanes
    together.  Returns what the serial branches return, each lane's."""
    if t_tensor is not None and _batched((t_tensor,)):
        raise ValueError("output times that differ between a wave's lanes do not wave "
                         "(ROADMAP item 17d)")
    arg_leaves, rebuild_args = flatten(args)

    def flat(tt, yy, aa):
        state = rebuild([l.to(d) for l, d in zip(yy, dtypes)])
        return [l.to(dtype) for l in flatten(func(tt, state, rebuild_args(list(aa))))[0]]

    time_dtype = dtype if method in ADAPTIVE_METHODS else _time_dtype(t_host)
    spec = _LaneSpec(flat, len(y), t_host, dict(
        rtol=rtol, atol=atol, method=method, options=options, per_leaf=per_leaf,
        t_tensor=t_tensor, time_dtype=time_dtype))
    out = _LaneSolve.apply(spec, *y, *arg_leaves)
    return list(out[:len(y)]), dict(zip(spec.keys, out[len(y):]))


# ---------------------------------------------------------------------------
# Event handling (reference event_handling.py:5-35, odeint.py:93-164)
# ---------------------------------------------------------------------------

def combine_event_functions(event_fn, t0, y0):
    """Fold a vector-valued event function into a scalar one whose first
    zero-crossing is the first crossing of any component (signs normalised
    at (t0, y0))."""
    signs0 = torch.sign(event_fn(t0, y0))

    def combined(t, y):
        return torch.min(signs0 * event_fn(t, y))

    return combined


def odeint_event(func, y0: torch.Tensor, t0, event_fn, args=None, *, rtol: float = 1e-7,
                 atol: float = 1e-9, method: str = "dopri5", options: Optional[dict] = None,
                 bisection_iters: int = 40, differentiable: bool = False):
    """Integrate dy/dt = func(t, y, args) from (t0, y0) until
    ``event_fn(t, y)`` crosses zero; returns ``(event_t, y_event)``, 0-d
    and y0-shaped tensors on y0's device.  The JAX package's
    ``odeint_event``: an adaptive solve (the host controller of
    ``odeint``, ``options`` ``min_step`` / ``max_step`` / ``safety`` /
    ``ifactor`` / ``dfactor`` / ``max_num_steps``) that reads the event's
    sign after each accepted step, then ``bisection_iters`` bisections of
    the crossing step's dense output, on the device with no host read.  A
    vector-valued ``event_fn`` is combined with
    :func:`combine_event_functions`.

    With ``differentiable=True`` the state is re-solved to the bisected
    time by RK4 with ``bisection_iters`` steps, differentiably, and the
    event time takes one Newton step of the event function there, so both
    carry gradients to y0 and ``args``."""
    options = dict(options or {})
    if method not in ADAPTIVE_METHODS:
        raise ValueError("odeint_event requires an adaptive method")
    # The event loop norms the error as one RMS block, DOP853's too.
    tableau = dataclasses.replace(ADAPTIVE_METHODS[method], c_error_alt=None)
    dtype, device = y0.dtype, y0.device
    S = _NUMPY[dtype]
    t0 = S(float(t0))

    def time(tt):
        return torch.full((), float(tt), dtype=dtype, device=device)

    def flat_func(tt, yy):
        if not isinstance(tt, torch.Tensor):
            tt = time(tt)
        return [func(tt, yy[0], args)]

    probe = event_fn(time(t0), y0)
    if probe.dim() > 0 and probe.numel() > 1:
        event_fn = combine_event_functions(event_fn, time(t0), y0)

    def sign(tt, y):
        return torch.sign(event_fn(time(tt), y))

    ctl = _Controller(flat_func, [y0], np.array([t0, t0]), tableau, rtol=rtol, atol=atol,
                      min_step=float(options.get("min_step", 0.0)),
                      max_step=float(options.get("max_step", float("inf"))),
                      first_step=None, safety=float(options.get("safety", 0.9)),
                      ifactor=float(options.get("ifactor", 10.0)),
                      dfactor=float(options.get("dfactor", 0.2)))
    max_num_steps = int(options.get("max_num_steps", 2**20))
    with torch.no_grad():
        sign0 = sign(t0, y0)
        s = ctl.start()
        crossed = False
        while not crossed and s.accepted + s.rejected < max_num_steps:
            s, step = ctl.attempt(s)
            if step is not None:
                crossed = _read(sign(s.t1, s.y1[0]) != sign0)[0]
        # Bisection on the crossing step's dense output, on the device.
        if s.last is None:
            fit = [[torch.zeros_like(y0)] * 4 + [y0]]
        else:
            fit = _fit_from_stages(*s.last[:3], s.last[3], tableau)
        span = float(s.t1 - s.t0)

        def dense(tt):
            x = ((tt - float(s.t0)) / span).to(dtype)
            return _interp_evaluate(fit, x)[0]

        lo, hi = time(s.t0), time(s.t1)
        for _ in range(bisection_iters):
            mid = 0.5 * (lo + hi)
            same = torch.sign(event_fn(mid, dense(mid))) == sign0
            lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
        event_t = 0.5 * (lo + hi)
        y_event = dense(event_t)
    _count(solves=1, nfe=s.nfe, accepted=s.accepted, rejected=s.rejected)
    if not differentiable:
        return event_t, y_event
    # The re-solve's grid needs the event time on the host: one read.
    t_star = S(_read(event_t)[0])
    ys, _ = _fixed_grid_integrate(flat_func, [y0], _cast([float(t0), float(t_star)], S), S,
                                  "rk4", substeps=int(bisection_iters))
    _count(evals=4 * int(bisection_iters) + 1)   # the re-solve and the Newton step's f
    y_event = ys[0][-1]
    # One Newton step of g from the gradient-stopped t*, under autograd:
    # d t_event / d theta = -(dg/dy . dy/dtheta) / (dg/dt + dg/dy . f).
    graph = y_event.requires_grad
    with torch.enable_grad():
        t_ = event_t.detach().requires_grad_()
        y_ = y_event if graph else y_event.detach().requires_grad_()
        g = event_fn(t_, y_)
        gt, gy = torch.autograd.grad(g, (t_, y_), create_graph=graph, allow_unused=True)
        gt = torch.zeros_like(g) if gt is None else gt
        gy = torch.zeros_like(y_) if gy is None else gy
        denom = gt + torch.sum(gy * func(t_.detach(), y_, args))
        event_t = t_.detach() - g / torch.where(denom == 0, torch.ones_like(denom), denom)
    return (event_t if graph else event_t.detach()), y_event
