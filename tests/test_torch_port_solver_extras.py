"""Parity of the rest of the port's solvers against the JAX package, on the
CPU: the Adams multistep methods, ``scipy_solver``, ``odeint_event`` /
``combine_event_functions`` and ``odeint`` of a bf16 state, through
``odeint``, ``cdeint``'s generic path, ``odeint_adjoint`` and
``NeuralCDE``.

The same numpy inputs (fixed seeds) go through both sides; weights are made
by the JAX ``init`` and carried across with ``params_from_jax``.  Module
tests run in float64 at rtol=1e-9 with equal solve statistics; the model
slice in float32 at |err| <= 1e-5 (|want| + max|want|).  A bf16 solve is
held to a share of JAX's own bf16-vs-f32 distance on the same inputs
(``BF16_SHARE``): XLA rounds at the end of a fusion and the port after
every op, so the two bf16 results part by a few bf16 ulps, far less than
bf16 parts from f32.  The oracles are the JAX package's
``tests/test_solver_extras.py``, ``tests/test_solvers.py`` and
``tests/test_detest.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops import cdeint as jax_cdeint
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import solvers as jax_solvers
from online_neural_cdes_tpu_torch import NeuralCDE, params_from_jax
from online_neural_cdes_tpu_torch import combine_event_functions, odeint_event
from online_neural_cdes_tpu_torch.ops import cdeint as torch_cdeint
from online_neural_cdes_tpu_torch.ops import interpolation, kernels, solvers
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
RTOL32 = 1e-5
# A bf16 result's distance from JAX's bf16 result, as a share of JAX's own
# bf16-vs-f32 distance (max abs over the trajectory).
BF16_SHARE = 0.25
BF16_GRAD_RATIO = 2.0


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def close32(got, want, err_msg=""):
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, RTOL32, RTOL32 * scale, err_msg)


def same_stats(got, want):
    assert {k: int(got[k]) for k in want} == {k: int(v) for k, v in want.items()}


def _case(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(4, 4)) * 0.5, rng.normal(size=(3, 4))


def _jax_field(t, y, a):
    return jnp.tanh(y @ a) * jnp.cos(t)


def _torch_field(t, y, a):
    return torch.tanh(y @ a) * torch.cos(t)


def _both(method, y0, t, A, rtol=1e-6, atol=1e-8, **opts):
    want = jax_solvers.odeint(_jax_field, jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A),
                              method=method, rtol=rtol, atol=atol, options=dict(opts),
                              return_stats=True)
    got = solvers.odeint(_torch_field, torch.from_numpy(y0), torch.from_numpy(t),
                         torch.from_numpy(A), method=method, rtol=rtol, atol=atol,
                         options=dict(opts), return_stats=True)
    return got, want


# ------------------------------------------------------------- Adams


def test_adams_coefficient_tables_match_jax():
    for order in (4, 5, 12):
        got, want = (solvers._adams_coefficient_tables(order),
                     jax_solvers._adams_coefficient_tables(order))
        for g_rows, w_rows in zip(got, want):
            assert len(g_rows) == len(w_rows) == order + 1
            for g, w in zip(g_rows, w_rows):
                np.testing.assert_array_equal(g, w)
    bash, moul = solvers._adams_coefficient_tables(12)
    np.testing.assert_allclose(bash[4], np.array([55, -59, 37, -9]) / 24)
    np.testing.assert_allclose(moul[3], np.array([5, 8, -1]) / 12)


ADAMS_OPTIONS = {"substeps": {"substeps": 3}, "order5": {"substeps": 8, "max_order": 5},
                 "step_size": {"step_size": 0.1}, "iters2": {"substeps": 4, "max_iters": 2},
                 "order4": {"substeps": 6, "max_order": 4}}


@pytest.mark.parametrize("opts", sorted(ADAMS_OPTIONS))
@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_adams_odeint_matches_jax(method, opts):
    A, y0 = _case()
    t = np.linspace(0.0, 2.0, 5)
    (gy, gstats), (wy, wstats) = _both(method, y0, t, A, rtol=1e-3, atol=1e-4,
                                       **ADAMS_OPTIONS[opts])
    close(gy, wy)
    same_stats(gstats, wstats)


def test_adams_tuple_state_matches_jax():
    A, y0 = _case(1)
    t = np.linspace(0.0, 1.0, 4)

    def jf(tt, y, a):
        return (jnp.tanh(y[0] @ a), -0.5 * y[1] * tt)

    def tf(tt, y, a):
        return (torch.tanh(y[0] @ a), -0.5 * y[1] * tt)

    y1 = np.arange(3.0)
    want = jax_solvers.odeint(jf, (jnp.asarray(y0), jnp.asarray(y1)), jnp.asarray(t),
                              jnp.asarray(A), method="implicit_adams",
                              options={"substeps": 3})
    got = solvers.odeint(tf, (torch.from_numpy(y0), torch.from_numpy(y1)),
                         torch.from_numpy(t), torch.from_numpy(A), method="implicit_adams",
                         options={"substeps": 3})
    for g, w in zip(got, want):
        close(g, w)


def test_adams_gradients_match_jax():
    A, y0 = _case(2)
    t = np.linspace(0.0, 2.0, 11)

    def jloss(y, a):
        return jnp.sum(jax_solvers.odeint(_jax_field, y, jnp.asarray(t), a,
                                          method="implicit_adams") ** 2)

    wy, wa = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(A))
    ty, ta = (torch.from_numpy(a).requires_grad_() for a in (y0, A))
    torch.sum(solvers.odeint(_torch_field, ty, torch.from_numpy(t), ta,
                             method="implicit_adams") ** 2).backward()
    close(ty.grad, wy)
    close(ta.grad, wa)


def test_adams_order_growth_and_accuracy():
    """The JAX oracle's accuracy checks on the port: the growing order is
    far more accurate than the order-4 cap, and the corrector beats the
    predictor alone."""
    y0, t = torch.tensor([1.0], dtype=torch.float64), torch.linspace(0.0, 2.0, 41,
                                                                     dtype=torch.float64)
    decay = lambda tt, y, a: -y
    hi = solvers.odeint(decay, y0, t, method="implicit_adams")
    lo = solvers.odeint(decay, y0, t, method="implicit_adams", options={"max_order": 4})
    err_hi, err_lo = (abs(float(y[-1, 0]) - np.exp(-2.0)) for y in (hi, lo))
    assert err_hi < err_lo / 10 and err_hi < 1e-9
    t5 = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    coarse = {m: solvers.odeint(decay, y0, t5, method=m,
                                options={"substeps": 2, "max_order": 5})
              for m in ("explicit_adams", "implicit_adams")}
    errs = {m: abs(float(y[-1, 0]) - np.exp(-2.0)) for m, y in coarse.items()}
    assert errs["implicit_adams"] < errs["explicit_adams"]


def test_implicit_adams_makes_no_host_read_and_counts_every_corrector_call():
    A, y0 = _case(3)
    calls = []

    def field(tt, y, a):
        calls.append(1)
        return _torch_field(tt, y, a)

    solvers.reset_counts()
    _, stats = solvers.odeint(field, torch.from_numpy(y0), torch.linspace(0.0, 1.0, 3),
                              torch.from_numpy(A), method="implicit_adams",
                              options={"substeps": 5}, return_stats=True)
    n_steps = 10
    # Two RK4 bootstraps (4 calls each), then 1 + max_iters calls a step.
    assert int(stats["nfe"]) == len(calls) == 2 * 4 + (n_steps - 2) * 5
    assert solvers.COUNTS["forward"]["reads"] == 0
    assert solvers.COUNTS["forward"]["nfe"] == len(calls)


def test_adams_rejects_non_uniform_output_grid():
    with pytest.raises(ValueError, match="uniformly spaced"):
        solvers.odeint(lambda t, y, a: -y, torch.ones(1),
                       torch.tensor([0.0, 1.0, 10.0]), method="explicit_adams")


def _cdeint_case(seed, H=5, HH=6, C=3, L=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, L, C))
    x[..., 0] = np.arange(L)
    coeffs = np.array(jax_interp.hermite_cubic_coefficients_with_backward_differences(
        jnp.asarray(x)))
    jm = JaxNeuralCDE(input_dim=C, hidden_dim=H, output_dim=1, hidden_hidden_dim=HH,
                      num_layers=2)
    field = jax.tree.map(lambda a: np.asarray(a, np.float64),
                         jm.init(jax.random.PRNGKey(seed))["field"])
    return coeffs, field, rng.normal(size=(3, H)), H, C


@pytest.mark.parametrize("method,adjoint", [("explicit_adams", False),
                                            ("implicit_adams", False),
                                            ("implicit_adams", True)])
def test_adams_cdeint_matches_jax(method, adjoint):
    """The generic path with an Adams method, and its reverse solve through
    ``odeint_adjoint`` (the JAX oracle:
    ``test_adams_adjoint_substeps_resolved_from_concrete_grid``): values
    and the gradients of the coefficients, z0 and the field."""
    from online_neural_cdes_tpu.ops import kernels as jax_kernels

    coeffs, field, z0, H, C = _cdeint_case(4)
    opts = {"step_size": 0.5}

    def jloss(c, z, f):
        spline = jax_interp.CubicSpline.create(c)
        fp = jax_kernels.pack_fused_params(f, H, C, pad=False)
        func = lambda tt, zz, dx, p: jax_kernels.fused_matmul_field(
            p["trunk"], p["head_w"], p["head_b"], zz, dx, H, C, False)
        zs = jax_cdeint.cdeint(spline, func, z, spline.interval, fp, adjoint=adjoint,
                               vector_field_type="matmul_fused", method=method,
                               options=dict(opts))
        return jnp.sum(zs ** 2), zs

    (_, wz), wg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(coeffs), jnp.asarray(z0), jax.tree.map(jnp.asarray, field))
    tc, tz = (torch.from_numpy(a).requires_grad_() for a in (coeffs, z0))
    tfield = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), field)
    tp = kernels.pack_fused_params(tfield, H, C)
    spline = interpolation.CubicSpline.create(tc)
    func = lambda tt, zz, dx, p: kernels.fused_matmul_field(
        p["trunk"], p["head_w"], p["head_b"], zz, dx, H, C)
    solvers.reset_counts()
    gz = torch_cdeint.cdeint(spline, func, tz, spline.interval, tp, adjoint=adjoint,
                             vector_field_type="matmul_fused", method=method,
                             options=dict(opts))
    torch.sum(gz ** 2).backward()
    close(gz, wz)
    close(tc.grad, wg[0], rtol=1e-8)
    close(tz.grad, wg[1], rtol=1e-8)
    want = flatten_tree(jax.tree.map(np.asarray, wg[2]))
    for name, leaf in flatten_tree(tfield).items():
        close(leaf.grad, want[name], rtol=1e-8, err_msg=name)
    if adjoint:
        assert solvers.COUNTS["reverse"]["solves"] == 1


# ------------------------------------------------------------ the model


B, C, H, HH = 5, 4, 8, 8


def _model_pair(dtype, **kw):
    kw = dict(dict(input_dim=C, hidden_dim=H, output_dim=1, hidden_hidden_dim=HH,
                   num_layers=2, interpolation="hermite"), **kw)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jm.init(jax.random.PRNGKey(0)))
    tdtype = {jnp.float64: torch.float64, jnp.float32: torch.float32,
              jnp.bfloat16: torch.bfloat16}[dtype]
    tm = NeuralCDE(**kw, device="cpu", dtype=tdtype)
    params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32 if dtype == jnp.bfloat16
                                                      else a.dtype), jparams), tm)
    return jm, jparams, tm


def _coeffs(L, dtype=np.float32, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(dtype)
    x[..., 0] = np.arange(L)
    c = np.array(jax_interp.hermite_cubic_coefficients_with_backward_differences(
        jnp.asarray(x)))
    return jnp.asarray(c), torch.from_numpy(c)


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("adjoint", [True, False])
@pytest.mark.parametrize("solver", ["explicit_adams", "implicit_adams"])
def test_neural_cde_adams_matches_jax(solver, adjoint, return_sequences):
    """Outputs, nfe and parameter gradients of an f32 Adams ``NeuralCDE``
    (``solver_settings``: one multistep step per knot unit)."""
    jm, jparams, tm = _model_pair(jnp.float32, solver=solver, adjoint=adjoint,
                                  return_sequences=return_sequences)
    jc, tc = _coeffs(6)
    want, wstats = jm.apply(jparams, jc, return_stats=True)
    got, gstats = tm(tc, return_stats=True)
    close32(got, want)
    same_stats(gstats, wstats)
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply(p, jc) ** 2))(jparams)
    tm.zero_grad()
    torch.sum(tm(tc) ** 2).backward()
    want_g = flatten_tree(jax.tree.map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        close32(p.grad, want_g[name], name)


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("solver", ["dopri5", "implicit_adams"])
def test_neural_cde_generic_path_takes_its_times_from_the_host_grid(
        monkeypatch, solver, return_sequences):
    """The generic path steps on the knot grid's host copy, all of it or
    the end points of the spline's one ``interval`` tensor, and reads no
    times from the device; the Adams step count comes from that grid."""
    jm, jparams, tm = _model_pair(jnp.float32, solver=solver, adjoint=False,
                                  return_sequences=return_sequences)
    jc, tc = _coeffs(6)
    spline = tm._setup_h0(tc)[0]
    assert spline.interval is spline.interval

    def no_read(t):
        raise AssertionError("cdeint read its times from the tensor")

    monkeypatch.setattr(solvers, "_host_tensor", no_read)
    want, wstats = jm.apply(jparams, jc, return_stats=True)
    with torch.no_grad():
        got, gstats = tm(tc, return_stats=True)
    close32(got, want)
    same_stats(gstats, wstats)


def test_neural_cde_scipy_solver_matches_jax_and_refuses_the_adjoint():
    jm, jparams, tm = _model_pair(jnp.float64, solver="scipy_solver", adjoint=False)
    jc, tc = _coeffs(5, np.float64)
    want, wstats = jm.apply(jparams, jc, return_stats=True)
    with torch.no_grad():
        got, gstats = tm(tc, return_stats=True)
    close(got, want)
    same_stats(gstats, wstats)
    with pytest.raises(ValueError, match="adjoint=False"):
        NeuralCDE(input_dim=C, hidden_dim=4, output_dim=1, solver="scipy_solver",
                  adjoint=True, device="cpu")


# ------------------------------------------------------------- scipy


@pytest.mark.parametrize("opts", [{}, {"solver": "RK45"}, {"solver": "LSODA", "min_step": 1e-6,
                                                            "max_step": 0.5}])
def test_scipy_solver_matches_jax(opts):
    A, y0 = _case(5)
    t = np.linspace(0.0, 3.0, 7)
    solvers.reset_counts()
    (gy, gstats), (wy, wstats) = _both("scipy_solver", y0, t, A, rtol=1e-8, atol=1e-10,
                                       **opts)
    close(gy, wy)
    same_stats(gstats, wstats)
    counts = solvers.COUNTS["forward"]
    assert counts["nfe"] == int(gstats["nfe"]) and counts["reads"] == counts["nfe"] + 1


def test_scipy_min_step_forwarded_and_refused_off_lsoda(monkeypatch):
    import scipy.integrate

    captured, real = {}, scipy.integrate.solve_ivp

    def spy(*args, **kwargs):
        captured.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr("scipy.integrate.solve_ivp", spy)
    decay = lambda t, y, a: -y
    solvers.odeint(decay, torch.ones(1, dtype=torch.float64),
                   torch.linspace(0.0, 10.0, 5, dtype=torch.float64),
                   method="scipy_solver", rtol=1e-8, atol=1e-10,
                   options={"solver": "LSODA", "min_step": 0.1, "max_step": 5.0})
    assert captured["min_step"] == 0.1 and captured["max_step"] == 5.0
    with pytest.raises(ValueError, match="min_step"):
        solvers.odeint(decay, torch.ones(2), torch.linspace(0.0, 1.0, 3),
                       method="scipy_solver", options={"solver": "RK45", "min_step": 0.1})


# ------------------------------------------------------------- events


def _event_case(seed=6):
    rng = np.random.default_rng(seed)
    y0 = rng.normal(size=(3, 4))
    return y0, np.eye(4) * 0.5 + rng.normal(size=(4, 4)) * 0.1, y0.sum() - 1.0


def _event_field_jax(t, y, a):
    return -jnp.tanh(y @ a) - 0.3


def _event_field_torch(t, y, a):
    return -torch.tanh(y @ a) - 0.3


def _events(case, y0, level):
    """(JAX, port) event functions: one entry's fall, the sum's fall, and
    both with the time, as a vector (combined)."""
    mark = y0[0, 0] - 0.3
    if case == "entry":
        return (lambda t, y: y[0, 0] - mark), (lambda t, y: y[0, 0] - mark)
    if case == "sum":
        return (lambda t, y: jnp.sum(y) - level), (lambda t, y: torch.sum(y) - level)
    return ((lambda t, y: jnp.stack([y[0, 0] - mark, jnp.sum(y) - level + 0.1 * t])),
            (lambda t, y: torch.stack([y[0, 0] - mark, torch.sum(y) - level + 0.1 * t])))


@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
@pytest.mark.parametrize("case", ["entry", "sum", "vector"])
def test_odeint_event_matches_jax(case, method):
    y0, A, level = _event_case()
    jev, tev = _events(case, y0, level)
    wt, wy = jax_solvers.odeint_event(_event_field_jax, jnp.asarray(y0), 0.0, jev,
                                      jnp.asarray(A), method=method, rtol=1e-8, atol=1e-10)
    solvers.reset_counts()
    gt, gy = odeint_event(_event_field_torch, torch.from_numpy(y0), 0.0, tev,
                          torch.from_numpy(A), method=method, rtol=1e-8, atol=1e-10)
    close(gt, wt)
    close(gy, wy)
    counts = solvers.COUNTS["forward"]
    # One read per attempt (its error ratio) and per accepted step (the
    # event's sign), one for the initial step: none in the bisection.
    assert counts["reads"] == counts["accepted"] * 2 + counts["rejected"] + 1


def test_combine_event_functions_matches_jax():
    y0 = np.array([1.0])

    def jevents(t, y):
        return jnp.stack([y[0] - 0.25, 0.75 - y[0]])

    def tevents(t, y):
        return torch.stack([y[0] - 0.25, 0.75 - y[0]])

    got_fn = combine_event_functions(tevents, torch.tensor(0.0), torch.from_numpy(y0))
    want_fn = jax_solvers.combine_event_functions(jevents, 0.0, jnp.asarray(y0))
    for v in (1.0, 0.6, 0.3, 0.1):
        close(got_fn(0.0, torch.tensor([v], dtype=torch.float64)),
              want_fn(0.0, jnp.asarray([v])))
    fall = lambda t, y, a: -torch.ones_like(y)
    event_t, _ = odeint_event(fall, torch.from_numpy(y0), 0.0, tevents, rtol=1e-8,
                              atol=1e-10)
    np.testing.assert_allclose(float(event_t), 0.25, atol=1e-5)


def test_differentiable_event_time_and_state_gradients_match_jax():
    y0, A, level = _event_case(7)

    def jrun(y, a):
        return jax_solvers.odeint_event(_event_field_jax, y, 0.0,
                                        lambda t, yy: jnp.sum(yy) - level, a,
                                        rtol=1e-9, atol=1e-12, differentiable=True)

    (wt, wy), (gt_y, gt_a) = jrun(jnp.asarray(y0), jnp.asarray(A)), jax.grad(
        lambda y, a: jrun(y, a)[0], argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(A))
    gy_y, gy_a = jax.grad(lambda y, a: jnp.sum(jrun(y, a)[1] ** 2),
                          argnums=(0, 1))(jnp.asarray(y0), jnp.asarray(A))
    ty, ta = (torch.from_numpy(x).requires_grad_() for x in (y0, A))

    def trun():
        return odeint_event(_event_field_torch, ty, 0.0,
                            lambda t, yy: torch.sum(yy) - level, ta, rtol=1e-9,
                            atol=1e-12, differentiable=True)

    event_t, y_event = trun()
    close(event_t, wt)
    close(y_event, wy)
    event_t.backward()
    close(ty.grad, gt_y)
    close(ta.grad, gt_a)
    ty.grad = ta.grad = None
    torch.sum(trun()[1] ** 2).backward()
    close(ty.grad, gy_y)
    close(ta.grad, gy_a)


def test_event_time_gradient_oracle():
    """dy/dt = -r from y0: the event y = 0 at t* = y0 / r, so dt*/dy0 = 1/r
    and dt*/dr = -y0 / r^2 (the JAX package's oracle)."""
    y0 = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    r = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    t_star, _ = odeint_event(lambda t, y, a: -a * torch.ones_like(y), y0, 0.0,
                             lambda t, y: y[0], r, rtol=1e-9, atol=1e-12,
                             differentiable=True)
    t_star.backward()
    np.testing.assert_allclose(float(t_star), 4.0, rtol=1e-6)
    np.testing.assert_allclose(float(y0.grad), 2.0, rtol=1e-4)
    np.testing.assert_allclose(float(r.grad), -8.0, rtol=1e-4)


# -------------------------------------------------------------- bf16


def _bf16_share(got, want_bf16, want_f32):
    got, want = got.float().numpy(), np.asarray(want_bf16, np.float32)
    gap = np.abs(np.asarray(want_f32, np.float32) - want).max()
    assert gap > 0
    return np.abs(got - want).max() / gap


@pytest.mark.parametrize("method", ["dopri5", "bosh3", "rk4", "implicit_adams"])
def test_bf16_odeint_matches_jax(method):
    """A bf16 state (its controller scalars rounded to bf16 on the host)
    against JAX's bf16 solve, as a share of JAX's bf16-vs-f32 distance;
    the times in bf16, as JAX casts them for an adaptive bf16 solve."""
    A, y0 = _case(8)
    t = np.array([0.0, 0.5, 1.25, 2.0])
    opts = {"substeps": 3} if method in ("rk4", "implicit_adams") else {}

    def jsolve(dtype):
        return jax_solvers.odeint(_jax_field, jnp.asarray(y0, dtype), jnp.asarray(t, dtype),
                                  jnp.asarray(A, dtype), method=method, rtol=1e-3,
                                  atol=1e-4, options=dict(opts))

    t_bf16 = torch.from_numpy(t).bfloat16()
    if method == "implicit_adams":   # uniform in bf16 too
        t = np.arange(4) * 0.5
        t_bf16 = torch.from_numpy(t).bfloat16()
    got = solvers.odeint(_torch_field, torch.from_numpy(y0).bfloat16(), t_bf16,
                         torch.from_numpy(A).bfloat16(), method=method, rtol=1e-3,
                         atol=1e-4, options=dict(opts))
    assert got.dtype == torch.bfloat16
    assert _bf16_share(got, jsolve(jnp.bfloat16), jsolve(jnp.float32)) <= BF16_SHARE


def test_bf16_host_scalars_round_every_operation():
    S = solvers._Bf16
    third = S(1.0) / 3.0
    assert float(third) == float(torch.tensor(1.0 / 3.0, dtype=torch.bfloat16))
    assert isinstance(S(2.0) * 0.1 + 1.0, S)
    assert float(solvers._nextafter(S(1.0), S(2.0))) == 1.0 + 2.0 ** -7
    grid = solvers._cast(np.array([0.0, 0.1, 1.0]), S)
    assert all(isinstance(v, S) for v in grid) and float(grid[1]) == float(S(0.1))


def test_bf16_neural_cde_dopri5_matches_jax():
    """A bf16 ``NeuralCDE(solver="dopri5")`` serves and trains: its outputs
    held to a share of JAX's bf16-vs-f32 distance.  Its parameter gradients
    (through the replayed solve) part from JAX's bf16 ones by about as much
    as those part from f32 (shares 0.1-1.0 over seeds and lengths): bf16
    round-off placed at fusion ends or after every op settles the backward
    differently.  So each gradient tensor is held to the f32 gradient: the
    port's bf16 one no further from it (Frobenius) than BF16_GRAD_RATIO
    times JAX's bf16 one (1.05 here; up to 1.6 over seeds and lengths)."""
    jm, jparams, tm = _model_pair(jnp.bfloat16, solver="dopri5", adjoint=False)
    jparams32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    jc, _ = _coeffs(5)
    jc16 = jc.astype(jnp.bfloat16)
    tc = torch.from_numpy(np.asarray(jc)).bfloat16()
    want, want32 = jm.apply(jparams, jc16), jm.apply(jparams32, jc)
    got = tm(tc)
    assert got.dtype == torch.bfloat16
    assert _bf16_share(got.detach(), want, want32) <= BF16_SHARE

    def grads(p, c):
        return flatten_tree(jax.tree.map(
            lambda a: np.asarray(a, np.float32),
            jax.grad(lambda q: jnp.sum(jm.apply(q, c).astype(jnp.float32) ** 2))(p)))

    w16, w32 = grads(jparams, jc16), grads(jparams32, jc)
    torch.sum(tm(tc).float() ** 2).backward()
    for name, p in tm.named_parameters():
        g = p.grad.float().numpy()
        dist = np.linalg.norm(w16[name] - w32[name])
        assert np.linalg.norm(g - w32[name]) <= BF16_GRAD_RATIO * dist, name


# ------------------------------------------------------------ DETEST


DETEST = {
    "A1": (lambda t, y: -y, np.array([1.0])),
    "A3": (lambda t, y: y * np.cos(t) if isinstance(y, np.ndarray) else y * torch.cos(t),
           np.array([1.0])),
    "B1": (None, np.array([1.0, 3.0])),
}


def _b1(y, stack):
    return stack([2.0 * (y[0] - y[0] * y[1]), -(y[1] - y[0] * y[1])])


@pytest.mark.parametrize("method", ["implicit_adams", "scipy_solver"])
@pytest.mark.parametrize("name", sorted(DETEST))
def test_detest_problems_match_jax(name, method):
    """DETEST problems (``tests/test_detest.py``) over [0, 20] through the
    ported methods: the port against JAX in f64, and both near a tight
    scipy solution."""
    from scipy.integrate import solve_ivp

    _, y0 = DETEST[name]
    if name == "B1":
        jf = lambda t, y, a: _b1(y, jnp.stack)
        tf = lambda t, y, a: _b1(y, torch.stack)
        nf = lambda t, y: _b1(y, np.stack)
    elif name == "A3":
        jf = lambda t, y, a: y * jnp.cos(t)
        tf = lambda t, y, a: y * torch.cos(t)
        nf = lambda t, y: y * np.cos(t)
    else:
        jf = tf = lambda t, y, a: -y
        nf = lambda t, y: -y
    t = np.array([0.0, 20.0])
    opts = {"substeps": 400} if method == "implicit_adams" else {}
    want = jax_solvers.odeint(jf, jnp.asarray(y0), jnp.asarray(t), method=method,
                              rtol=1e-7, atol=1e-9, options=dict(opts))
    got = solvers.odeint(tf, torch.from_numpy(y0), torch.from_numpy(t), method=method,
                         rtol=1e-7, atol=1e-9, options=dict(opts))
    close(got, want)
    truth = solve_ivp(nf, (0.0, 20.0), y0, method="DOP853", rtol=1e-12, atol=1e-12).y[:, -1]
    scale = np.maximum(np.abs(truth), 1.0)
    np.testing.assert_allclose(got[-1].numpy() / scale, truth / scale, atol=1e-4)
