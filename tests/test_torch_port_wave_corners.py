"""The corners of the wave (ROADMAP item 17d) on the CPU: solves under
``torch.func.vmap`` whose lanes each have their own output times, whose
output times take gradients, or whose grid comes from a
``grid_constructor``, and a bfloat16 K-lane controller, against the JAX
package's vmapped solves and against each lane's serial solve in the port.

Every method family (the fixed grid: euler, midpoint, rk4; Adams; the
adaptive Runge-Kutta methods, plain and differentiable) and
``odeint_adjoint`` take a batched ``t`` (K, T): each lane steps on its own
times, its controller clamping to its own outputs (DOP853's landings too).
Module tests run in float64: against ``jax.vmap`` of JAX's ``odeint`` /
``odeint_adjoint`` at rtol 1e-9 with equal nfe / accepted / rejected, and
each lane against the port's serial solve of its inputs at rtol 1e-9 with
equal counts.  The output times' gradients (the differentiable solve's
g . y'(t_out) through the replay's dense output, the adjoint's per-lane
``t_bar``) against ``jax.vmap(jax.grad(...))`` at rtol 1e-8 (the replay's
and the reverse solve's own round-off, as ``test_torch_port_wave_adjoint``
holds the other gradients).  A bf16 K-lane solve: each lane's accepted
steps, counts and outputs are its serial bf16 solve's, to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.ops import cdeint as jax_cdeint
from online_neural_cdes_tpu.ops import solvers as jax_solvers
from online_neural_cdes_tpu_torch.ops import cdeint as torch_cdeint
from online_neural_cdes_tpu_torch.ops import solvers

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11
GRAD_RTOL = 1e-8
K = 3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=err_msg)


def _jax_field(t, y, a):
    return jnp.tanh(y @ a) + 0.1 * jnp.sin(t)


def _torch_field(t, y, a):
    return torch.tanh(y @ a) + 0.1 * torch.sin(t)


def _lanes(seed=3):
    """K lanes of a field matrix and a start, and each lane's own uniform
    output times (different starts, ends and spacings)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, 4, 4)) * np.asarray([0.6, 1.1, 1.7])[:, None, None]
    y0 = rng.normal(size=(K, 3, 4))
    t = np.stack([np.linspace(0.0, 2.0, 6), np.linspace(0.1, 1.7, 6),
                  np.linspace(-0.3, 1.2, 6)])
    return A, y0, t


def _counts(stats):
    return {key: _np(stats[key]).tolist() for key in ("nfe", "accepted", "rejected")}


# ------------------------------------------------------ each lane's times


LANE_TIME_CASES = {
    "euler": ("euler", {"substeps": 3}),
    "midpoint": ("midpoint", {}),
    "rk4": ("rk4", {"substeps": 2}),
    "explicit_adams": ("explicit_adams", {}),
    "implicit_adams": ("implicit_adams", {"substeps": 2}),
    "dopri5": ("dopri5", {}),
    "bosh3-differentiable": ("bosh3", {"differentiable": True}),
    "dopri8": ("dopri8", {}),
    "dopri5-jumps": ("dopri5", {"jump_t": np.asarray([0.45, 1.05])}),
}


@pytest.mark.parametrize("case", sorted(LANE_TIME_CASES))
def test_each_lanes_output_times_match_jax_and_its_serial_solve(case):
    """``torch.func.vmap`` of ``odeint`` with ``t`` batched (K, T): the
    lanes' outputs and nfe / accepted / rejected against ``jax.vmap`` of
    JAX's ``odeint`` over the same (K, T) times, and each lane against the
    port's serial solve of its own inputs, with equal counts.  An adaptive
    solve runs one K-lane controller (``lane_solves``), each lane clamping
    to its own outputs and declared jumps."""
    method, opts = LANE_TIME_CASES[case]
    A, y0, t = _lanes()
    kw = dict(method=method, rtol=1e-6, atol=1e-8, return_stats=True)

    def jsolve(y, tt, a):
        return jax_solvers.odeint(_jax_field, y, tt, a, options=dict(opts), **kw)

    want, wstats = jax.vmap(jsolve)(jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))

    def tsolve(y, tt, a):
        return solvers.odeint(_torch_field, y, tt, a, options=dict(opts), **kw)

    solvers.reset_counts()
    got, gstats = torch.func.vmap(tsolve)(*(torch.from_numpy(x) for x in (y0, t, A)))
    if method in solvers.ADAPTIVE_METHODS:
        assert solvers.COUNTS["forward"]["lane_solves"] == 1
    close(got, want)
    assert _counts(gstats) == {k: np.asarray(wstats[k]).tolist() for k in _counts(gstats)}
    for j in range(K):
        serial, sstats = tsolve(*(torch.from_numpy(x[j]) for x in (y0, t, A)))
        close(got[j], serial, err_msg=str(j))
        assert {k: v[j] for k, v in _counts(gstats).items()} == _counts(sstats), j


@pytest.mark.parametrize("shared", [False, True], ids=["lane-times", "shared-times"])
@pytest.mark.parametrize("method", ["dopri5", "bosh3", "dopri8"])
def test_output_time_gradients_under_vmap_match_jax(method, shared):
    """A differentiable adaptive solve under ``torch.func.vmap`` whose
    output times take gradients: each lane's cotangent of its times is
    g . y'(t_out) from its own replayed dense output (the accepted grid held
    constant), as JAX's ``_adaptive_integrate_diff`` gives it, against
    ``jax.vmap(jax.grad(...))``; shared times take the lanes' sum.  The
    state's and the field's gradients too, and each lane against its serial
    solve's."""
    A, y0, t = _lanes()
    t = t[0] if shared else t
    w = np.random.default_rng(4).normal(size=(t.shape[-1], 3, 4))
    kw = dict(method=method, rtol=1e-6, atol=1e-8, options={"differentiable": True})

    def jloss(y, tt, a):
        return jnp.sum(jax_solvers.odeint(_jax_field, y, tt, a, **kw) * w)

    in_axes = (0, None if shared else 0, 0)
    wl, wg = jax.vmap(jax.value_and_grad(jloss, argnums=(0, 1, 2)), in_axes=in_axes)(
        jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))

    def tloss(y, tt, a):
        return torch.sum(solvers.odeint(_torch_field, y, tt, a, **kw) * torch.from_numpy(w))

    ty, tt, tA = (torch.from_numpy(x).requires_grad_() for x in (y0, t, A))
    losses = torch.func.vmap(tloss, in_dims=in_axes)(ty, tt, tA)
    gy, gt, gA = torch.autograd.grad(losses.sum(), (ty, tt, tA))
    close(losses, wl)
    close(gy, wg[0], rtol=GRAD_RTOL)
    close(gA, wg[2], rtol=GRAD_RTOL)
    want_t = np.asarray(wg[1]).sum(0) if shared else wg[1]
    close(gt, want_t, rtol=GRAD_RTOL, atol=1e-10)
    assert np.abs(want_t).max() > 1.0        # the times' gradient is not trivially 0
    if shared:
        return
    for j in range(K):
        sy, st, sA = (torch.from_numpy(x[j]).requires_grad_() for x in (y0, t, A))
        serial = torch.autograd.grad(tloss(sy, st, sA), (sy, st, sA))
        for g, s, name in zip((gy, gt, gA), serial, ("y0", "t", "A")):
            close(g[j], s, rtol=GRAD_RTOL, atol=1e-10, err_msg=f"{j} {name}")


@pytest.mark.parametrize("adjoint_options", [None, {"norm": "seminorm"},
                                             {"method": "rk4", "substeps": 4},
                                             {"method": "implicit_adams"}],
                         ids=["dopri5", "seminorm", "rk4", "implicit-adams"])
def test_lane_odeint_adjoint_with_each_lanes_times_matches_jax(adjoint_options):
    """``odeint_adjoint`` under ``torch.func.vmap`` with ``t`` batched: each
    lane reverses over its own intervals and gets its own ``t_bar`` (JAX's
    ``vt`` slot and g . f(t_i, y_i)), against ``jax.vmap`` of ``jax.grad``
    through JAX's ``odeint_adjoint`` and against each lane's serial
    adjoint."""
    A, y0, t = _lanes(7)
    w = np.random.default_rng(7).normal(size=(t.shape[-1], 3, 4))
    kw = dict(rtol=1e-7, atol=1e-9, adjoint_options=adjoint_options)

    def jloss(y, tt, a):
        return jnp.sum(jax_cdeint.odeint_adjoint(_jax_field, y, tt, a, **kw) * w)

    wl, wg = jax.vmap(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))

    def tloss(y, tt, a):
        return torch.sum(torch_cdeint.odeint_adjoint(_torch_field, y, tt, a, **kw)
                         * torch.from_numpy(w))

    ty, tt, tA = (torch.from_numpy(x).requires_grad_() for x in (y0, t, A))
    solvers.reset_counts()
    losses = torch.func.vmap(tloss)(ty, tt, tA)
    grads = torch.autograd.grad(losses.sum(), (ty, tt, tA))
    if (adjoint_options or {}).get("method") not in ("rk4", "implicit_adams"):
        assert solvers.COUNTS["reverse"]["lane_solves"] == t.shape[-1] - 1   # K-lane search
    close(losses, wl)
    for g, want, name in zip(grads, wg, ("y0", "t", "A")):
        close(g, want, rtol=GRAD_RTOL, atol=1e-10, err_msg=name)
    for j in range(K):
        sy, st, sA = (torch.from_numpy(x[j]).requires_grad_() for x in (y0, t, A))
        serial = torch.autograd.grad(tloss(sy, st, sA), (sy, st, sA))
        for g, s, name in zip(grads, serial, ("y0", "t", "A")):
            close(g[j], s, rtol=GRAD_RTOL, atol=1e-10, err_msg=f"{j} {name}")


# ------------------------------------------------------ grid_constructor


def _ramp(lib):
    def ctor(func, y0, tt):
        # Depends on the lane's state (its exponent is 1 + 0 |y0|): JAX
        # traces it per lane, and so must the port.
        return tt[0] + (tt[-1] - tt[0]) * lib.linspace(0.0, 1.0, 9, dtype=tt.dtype) ** (
            1.0 + 0.0 * lib.abs(y0).sum())
    return ctor


GRID_CASES = {
    "shared": (lambda f, y, tt: jnp.linspace(tt[0], tt[-1], 11),
               lambda f, y, tt: torch.linspace(tt[0], tt[-1], 11, dtype=tt.dtype), True),
    "lane-times": (lambda f, y, tt: jnp.linspace(tt[0], tt[-1], 11),
                   lambda f, y, tt: torch.linspace(tt[0], tt[-1], 11, dtype=tt.dtype), False),
    "lane-state": (_ramp(jnp), _ramp(torch), False),
}


@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_constructor_under_vmap_matches_jax_and_its_serial_solve(case, method):
    """A ``grid_constructor`` solve under ``torch.func.vmap``: the
    constructor is called as JAX's vmapped trace calls it (on the lanes'
    states and times), a grid of the shared times is every lane's, one of a
    lane's times or state its own (one static length); the lanes step on
    their grids and their outputs come from the same linear interpolation,
    against ``jax.vmap`` of JAX's ``odeint`` and each lane's serial solve."""
    jctor, tctor, shared = GRID_CASES[case]
    A, y0, t = _lanes(5)
    t = np.stack([t[0], t[0], t[0]]) if shared else t
    t = t + np.asarray([0.0, 0.05, 0.4, 0.75, 1.0, 0.0])[None] * 0.1    # outputs between knots
    in_axes = (0, None, 0) if shared else (0, 0, 0)
    tin = t[0] if shared else t

    want = jax.vmap(lambda y, tt, a: jax_solvers.odeint(
        _jax_field, y, tt, a, method=method, options={"grid_constructor": jctor}),
        in_axes=in_axes)(jnp.asarray(y0), jnp.asarray(tin), jnp.asarray(A))

    def tsolve(y, tt, a):
        return solvers.odeint(_torch_field, y, tt, a, method=method,
                              options={"grid_constructor": tctor}, return_stats=True)

    got, stats = torch.func.vmap(tsolve, in_dims=in_axes)(
        *(torch.from_numpy(x) for x in (y0, tin, A)))
    close(got, want)
    for j in range(K):
        serial, sstats = tsolve(*(torch.from_numpy(x[j]) for x in (y0, t, A)))
        close(got[j], serial, err_msg=str(j))
        assert {k: v[j] for k, v in _counts(stats).items()} == _counts(sstats)


def test_step_size_with_each_lanes_times_is_refused_as_jax_refuses_it():
    """A grid from ``step_size`` against batched times would give each lane
    its own number of steps: JAX refuses it under tracing, and so does the
    port, for ``odeint`` and ``odeint_adjoint``; ``substeps`` is taken."""
    A, y0, t = _lanes()
    with pytest.raises(ValueError, match="step_size cannot be resolved against traced"):
        jax.vmap(lambda y, tt, a: jax_solvers.odeint(
            _jax_field, y, tt, a, method="rk4", options={"step_size": 0.1}))(
            jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))
    args = [torch.from_numpy(x) for x in (y0, t, A)]
    for solve in (solvers.odeint, torch_cdeint.odeint_adjoint):
        with pytest.raises(ValueError, match="step_size cannot be resolved against traced"):
            torch.func.vmap(lambda y, tt, a, solve=solve: solve(
                _torch_field, y, tt, a, method="rk4", options={"step_size": 0.1}))(*args)
    got = torch.func.vmap(lambda y, tt, a: solvers.odeint(
        _torch_field, y, tt, a, method="rk4", options={"substeps": 3}))(*args)
    assert got.shape == (K, t.shape[-1], 3, 4) and torch.isfinite(got).all()


# ------------------------------------------------------------ bfloat16


def _bf16_field(t, y, a):
    """A bf16 field computed in float64 and rounded once: the CPU's float32
    ``sin`` and ``tanh`` take a vectorised path on some elements and a
    scalar one on others, which a batch moves, so a float32 field would
    round an element to another bf16 value under vmap now and then (the
    card runs one kernel on every element)."""
    return (torch.tanh(y.double() @ a.double()) + 0.1 * torch.sin(t.double())).to(y.dtype)


@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
@pytest.mark.parametrize("differentiable", [False, True])
def test_bf16_lane_controller_steps_as_its_serial_bf16_solves(method, differentiable,
                                                               monkeypatch):
    """K lanes of a bfloat16 adaptive solve (ROADMAP 17d-a): every host time
    and step size a ``_Bf16`` (each result rounded to bf16, as the serial
    controller's), the device columns bf16 tensors built exactly from them,
    no float32 anywhere.  Each lane's accepted steps (to the bit: bf16 host
    scalars), nfe / accepted / rejected are its serial bf16 solve's, and
    its outputs equal to them."""
    A, y0, t = _lanes(11)
    t = t[0]
    seen = {"serial": [], "lanes": [[] for _ in range(K)]}
    real_attempt, real_lanes = solvers._Controller.attempt, solvers._LaneController.attempt

    def attempt(self, s):
        new, step = real_attempt(self, s)
        if step is not None:
            seen["serial"].append(tuple(float(v) for v in step[:3]))
        return new, step

    columns = []

    def lanes(self, st, active, fits=False):
        assert self.S is solvers._Bf16
        steps, fit = real_lanes(self, st, active, fits)
        for j, step in enumerate(steps):
            if step is not None:
                seen["lanes"][j].append(tuple(float(v) for v in step[:3]))
                assert all(isinstance(v, solvers._Bf16) for v in step[:3])
        columns.append(self.column([st.t1[0]]).dtype)
        return steps, fit

    monkeypatch.setattr(solvers._Controller, "attempt", attempt)
    monkeypatch.setattr(solvers._LaneController, "attempt", lanes)
    opts = {"differentiable": True} if differentiable else {}
    ty, tA = (torch.from_numpy(x).bfloat16().requires_grad_(differentiable) for x in (y0, A))
    tt = torch.from_numpy(t).bfloat16()

    def tsolve(y, a):
        return solvers.odeint(_bf16_field, y, tt, a, method=method, rtol=1e-3, atol=1e-4,
                              options=dict(opts), return_stats=True)

    got, stats = torch.func.vmap(tsolve)(ty, tA)
    assert got.dtype == torch.bfloat16 and set(columns) == {torch.bfloat16}
    for j in range(K):
        seen["serial"].clear()
        serial, sstats = tsolve(ty[j].detach(), tA[j].detach())
        assert seen["lanes"][j] == seen["serial"], j
        assert {k: v[j] for k, v in _counts(stats).items()} == _counts(sstats), j
        assert torch.equal(got[j].detach(), serial), j
