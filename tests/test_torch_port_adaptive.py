"""Parity of the port's adaptive Runge-Kutta solvers, ``odeint``,
``odeint_adjoint`` and the generic ``cdeint`` path against the JAX package,
on the CPU.

The same numpy inputs (fixed seeds) go through both sides; weights are made
by the JAX ``init`` and carried across with ``params_from_jax``.  Module
tests run in float64 at rtol=1e-9 and hold the solve statistics (nfe,
accepted and rejected steps) equal: the controller takes the same decisions.
The model slice runs in float32 at rtol=1e-5, as served and trained, with
both sides given the same coefficient arrays (the coefficient builders'
parity is tested in ``test_torch_port_splines.py``); a float32 Hermite
solve carries round-off forward at about x2 per unit of time (the JAX
package's own f32 and f64 solves of an L=10 series differ by 6e-3), so
its f32 cases use L=6 and the L=10 series is held in float64.  On the
card the same paths run the fused field's Hopper kernels;
``chip_smoke.py`` holds them there.
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
from online_neural_cdes_tpu.serving import Predictor as JaxPredictor
from online_neural_cdes_tpu.training import loop as jax_loop
from online_neural_cdes_tpu_torch import NeuralCDE, Predictor, params_from_jax
from online_neural_cdes_tpu_torch.ops import cdeint as torch_cdeint
from online_neural_cdes_tpu_torch.ops import interpolation, kernels, solvers
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
# float32: |got - want| <= RTOL32 (|want| + max|want|).
RTOL32 = 1e-5


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def close32(got, want, err_msg=""):
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, RTOL32, RTOL32 * scale, err_msg)


def same_stats(got, want):
    assert set(got) == set(want)
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


# ------------------------------------------------------------- tableaux


@pytest.mark.parametrize("name", sorted(jax_solvers.ADAPTIVE_METHODS))
def test_tableaux_match_jax(name):
    assert tuple(solvers.ADAPTIVE_METHODS) == tuple(jax_solvers.ADAPTIVE_METHODS)
    got, want = solvers.ADAPTIVE_METHODS[name], jax_solvers.ADAPTIVE_METHODS[name]
    for field in ("alpha", "beta", "c_sol", "c_error", "order", "mid", "c_error_alt"):
        assert getattr(got, field) == getattr(want, field), field


# ------------------------------------------------------------- norms


@pytest.mark.parametrize("blocks", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_error_ratio_matches_jax(blocks, weighted):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), ()]
    leaves = [[rng.normal(size=s) for s in shapes] for _ in range(3)]   # err, y0, y1
    flat = [np.concatenate([np.ravel(x) for x in leaf]) for leaf in leaves]
    weights = [np.ones(s) for s in shapes[:2]] + [np.zeros(())] if weighted else None
    w_flat = (jnp.asarray(np.concatenate([np.ravel(w) for w in weights]))
              if weighted else None)
    rtol, atol = 1e-3, 1e-5
    want = jax_solvers._error_ratio(
        *(jnp.asarray(f) for f in (flat[0],)), rtol, atol, jnp.asarray(flat[1]),
        jnp.asarray(flat[2]), w_flat,
        tuple(int(np.prod(s)) for s in shapes) if blocks else None)
    err, y0, y1 = ([torch.from_numpy(np.asarray(x)) for x in leaf] for leaf in leaves)
    scale = [torch.maximum(a.abs(), b.abs()) * rtol + atol for a, b in zip(y0, y1)]
    norm = solvers._ErrorNorm(err, [torch.from_numpy(w) for w in weights]
                              if weighted else None, blocks)
    close(norm.ratio([e / s for e, s in zip(err, scale)]), want)


def test_select_initial_step_matches_jax():
    rng = np.random.default_rng(1)
    A, y0 = rng.normal(size=(4, 4)), rng.normal(size=(3, 4))
    jf = lambda t, y, a: jnp.sin(t + 1.0) * y @ a
    want = jax_solvers._select_initial_step(
        jf, jnp.asarray(0.25), jnp.asarray(y0), 4, jnp.asarray(1e-6), jnp.asarray(1e-8),
        jf(0.25, jnp.asarray(y0), jnp.asarray(A)), jnp.asarray(A))
    tA = torch.from_numpy(A)
    tf = lambda t, y: [torch.sin(torch.as_tensor(t, dtype=torch.float64) + 1.0) * y[0] @ tA]
    y = [torch.from_numpy(y0)]
    got = solvers._select_initial_step(tf, np.float64(0.25), y, 4, np.float64(1e-6),
                                       np.float64(1e-8), tf(0.25, y))
    close(got, want)


# ------------------------------------------------------------- odeint


def _linear_case(seed=0):
    rng = np.random.default_rng(seed)
    A, y0 = rng.normal(size=(4, 4)) * 0.5, rng.normal(size=(3, 4))
    return A, y0, np.array([0.0, 0.3, 1.0, 2.5])


def _jax_field(t, y, a):
    return jnp.sin(t) * y @ a


def _torch_field(t, y, a):
    return torch.sin(t) * y @ a


def _both(method, y0, t, A, rtol=1e-6, atol=1e-8, **opts):
    jfn = jax.jit(lambda y, tt, a: jax_solvers.odeint(
        _jax_field, y, tt, a, method=method, rtol=rtol, atol=atol, options=dict(opts),
        return_stats=True))
    want = jfn(jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))
    got = solvers.odeint(_torch_field, torch.from_numpy(y0), torch.from_numpy(t),
                         torch.from_numpy(A), method=method, rtol=rtol, atol=atol,
                         options=dict(opts), return_stats=True)
    return got, want


ODEINT_OPTIONS = {
    "plain": {},
    "min_step": {"min_step": 0.2},
    "step_jump": {"step_t": [0.7], "jump_t": [1.5]},
    "max_step": {"max_step": 0.1},
}


# Not dop853 with max_step: DOP853 lands on every output time, where the
# clamped step t1 - t0 can exceed max_step by an ulp, and both packages then
# reject it until max_num_steps.
ODEINT_CASES = [(m, o) for m in sorted(set(jax_solvers.ADAPTIVE_METHODS) - {"dopri8"})
                for o in sorted(ODEINT_OPTIONS) if (m, o) != ("dop853", "max_step")]


@pytest.mark.parametrize("method,opts", ODEINT_CASES)
def test_odeint_adaptive_matches_jax(method, opts):
    A, y0, t = _linear_case()
    (gy, gstats), (wy, wstats) = _both(method, y0, t, A, **ODEINT_OPTIONS[opts])
    close(gy, wy)
    same_stats(gstats, wstats)


@pytest.mark.parametrize("norm", [None, "rms"])
@pytest.mark.parametrize("method", ["dopri5", "dop853"])
def test_odeint_tuple_state_matches_jax(method, norm):
    """A tuple state: per-leaf error blocks max-combined, or one RMS."""
    rng = np.random.default_rng(2)
    A, y0, t = rng.normal(size=(4, 4)) * 0.5, rng.normal(size=(2, 4)), np.array([0.0, 1.5])
    v0 = rng.normal(size=(3,)) * 1e-3
    opts = {} if norm is None else {"norm": norm}
    want_y, want_s = jax.jit(lambda y, v: jax_solvers.odeint(
        lambda tt, s, a: (s[0] @ a, -tt * s[1]), (y, v), jnp.asarray(t), jnp.asarray(A),
        method=method, rtol=1e-6, atol=1e-9, options=dict(opts), return_stats=True))(
        jnp.asarray(y0), jnp.asarray(v0))
    tA = torch.from_numpy(A)
    got_y, got_s = solvers.odeint(
        lambda tt, s, a: (s[0] @ a, -tt * s[1]),
        (torch.from_numpy(y0), torch.from_numpy(v0)), torch.from_numpy(t), tA,
        method=method, rtol=1e-6, atol=1e-9, options=dict(opts), return_stats=True)
    for g, w in zip(got_y, want_y):
        close(g, w)
    same_stats(got_s, want_s)


def test_odeint_error_weights_match_jax():
    A, y0, t = _linear_case(3)
    w = np.ones(y0.shape)
    w[0] = 0.0
    (gy, gs), (wy, ws) = _both("bosh3", y0, t, A, error_weights=w)
    close(gy, wy)
    same_stats(gs, ws)


def test_odeint_nan_poisons_outputs_past_the_step_budget():
    A, y0, t = _linear_case(4)
    (gy, gs), (wy, ws) = _both("dopri5", y0, t, A, max_num_steps=5)
    assert np.isnan(gy[-1].numpy()).all() and np.isnan(np.asarray(wy[-1])).all()
    close(gy, wy)
    same_stats(gs, ws)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_odeint_fixed_grid_matches_jax(method):
    A, y0, t = _linear_case(5)
    (gy, gs), (wy, ws) = _both(method, y0, t, A, substeps=3)
    close(gy, wy)
    same_stats(gs, ws)
    grid = np.linspace(0.0, 2.5, 8)
    want = jax_solvers.odeint(_jax_field, jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A),
                              method=method,
                              options={"grid_constructor": lambda f, y, tt: jnp.asarray(grid)})
    got = solvers.odeint(_torch_field, torch.from_numpy(y0), torch.from_numpy(t),
                         torch.from_numpy(A), method=method,
                         options={"grid_constructor": lambda f, y, tt: grid})
    close(got, want)


def test_odeint_refuses_unported_methods_and_bf16_states():
    """Nothing is refused any more: the Adams methods and scipy_solver match
    JAX's in f64 (tests/test_torch_port_solver_extras.py holds them in
    full), a bf16 state steps in bf16 and matches JAX's bf16 solve, and a
    float16 state is refused, as before."""
    A, y0, t = _linear_case(4)
    for method, opts in (("explicit_adams", {"substeps": 2}),
                         ("implicit_adams", {"substeps": 2}),
                         ("scipy_solver", {})):
        tu = np.linspace(0.0, 1.5, 4)
        wy, wstats = jax_solvers.odeint(_jax_field, jnp.asarray(y0), jnp.asarray(tu),
                                        jnp.asarray(A), method=method, options=dict(opts),
                                        return_stats=True)
        gy, gstats = solvers.odeint(_torch_field, torch.from_numpy(y0), torch.from_numpy(tu),
                                    torch.from_numpy(A), method=method, options=dict(opts),
                                    return_stats=True)
        close(gy, wy)
        same_stats(gstats, wstats)
    for method in ("dopri5", "rk4"):
        tb = jnp.asarray(t, jnp.bfloat16)
        want = jax_solvers.odeint(_jax_field, jnp.asarray(y0, jnp.bfloat16), tb,
                                  jnp.asarray(A, jnp.bfloat16), method=method, rtol=1e-3,
                                  atol=1e-4)
        got = solvers.odeint(_torch_field, torch.from_numpy(y0).bfloat16(),
                             torch.from_numpy(t).bfloat16(), torch.from_numpy(A).bfloat16(),
                             method=method, rtol=1e-3, atol=1e-4)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="bfloat16"):
        solvers.odeint(lambda t, y, a: -y, torch.ones(2, 3).half(), torch.tensor([0.0, 1.0]))


# --------------------------------------------- differentiable solve


DIFF_CASES = {
    "dopri5": ("dopri5", {}),
    "dopri5_min_step": ("dopri5", {"min_step": 0.2}),
    "dop853_step_jump": ("dop853", {"step_t": [0.7], "jump_t": [1.5]}),
    "exhausted": ("bosh3", {"max_steps": 3}),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_odeint_differentiable_matches_jax(case):
    """Values, gradients (y0, args and the output times) and stats of the
    discretise-then-optimise solve; with the step budget exhausted, the
    unreached outputs are NaN and the gradients stay finite."""
    method, opts = DIFF_CASES[case]
    opts = {**opts, "differentiable": True}
    A, y0, t = _linear_case(6)
    w = np.random.default_rng(6).normal(size=(len(t),) + y0.shape)

    def jloss(y, tt, a):
        ys, stats = jax_solvers.odeint(_jax_field, y, tt, a, method=method, rtol=1e-6,
                                       atol=1e-8, options=dict(opts), return_stats=True)
        return jnp.nansum(ys * w), (ys, stats)

    (_, (wy, ws)), wg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))
    ty, tt, tA = (torch.from_numpy(a).requires_grad_() for a in (y0, t, A))
    gy, gs = solvers.odeint(_torch_field, ty, tt, tA, method=method, rtol=1e-6, atol=1e-8,
                            options=dict(opts), return_stats=True)
    torch.nansum(gy * torch.from_numpy(w)).backward()
    close(gy, wy)
    same_stats(gs, ws)
    assert bool(gs["grid_exhausted"]) == (case == "exhausted")
    if case == "exhausted":
        assert np.isnan(gy[-1].detach().numpy()).all()
    for x, want in zip((ty, tt, tA), wg):
        # No output reached: t gets no gradient (JAX: zeros).
        got = torch.zeros_like(x) if x.grad is None else x.grad
        assert np.isfinite(got.numpy()).all()
        close(got, want)


# ------------------------------------------------------- odeint_adjoint


@pytest.mark.parametrize("adjoint_options", [None, {"norm": "seminorm"},
                                             {"method": "bosh3", "rtol": 1e-8}])
def test_odeint_adjoint_matches_jax(adjoint_options):
    """Gradients of y0, args and the output times through the reverse
    adaptive solves (the integrated vt included)."""
    A, y0, t = _linear_case(7)
    w = np.random.default_rng(7).normal(size=(len(t),) + y0.shape)

    def jloss(y, tt, a):
        ys = jax_cdeint.odeint_adjoint(_jax_field, y, tt, a, rtol=1e-7, atol=1e-9,
                                       adjoint_options=adjoint_options)
        return jnp.sum(ys * w), ys

    (_, wy), wg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))
    ty, tt, tA = (torch.from_numpy(a).requires_grad_() for a in (y0, t, A))
    solvers.reset_counts()
    gy = torch_cdeint.odeint_adjoint(_torch_field, ty, tt, tA, rtol=1e-7, atol=1e-9,
                                     adjoint_options=adjoint_options)
    torch.sum(gy * torch.from_numpy(w)).backward()
    close(gy, wy)
    for got, want in zip((ty.grad, tt.grad, tA.grad), wg):
        close(got, want, rtol=1e-8)
    # One reverse solve and one f(t_i, y_i) per output interval.
    assert solvers.COUNTS["reverse"]["solves"] == len(t) - 1
    assert solvers.COUNTS["reverse"]["evals"] == len(t) - 1


# ------------------------------------------------------ generic cdeint


def _cdeint_case(seed, H=5, HH=6, C=3, L=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, L, C))
    x[..., 0] = np.arange(L)
    coeffs = np.array(jax_interp.hermite_cubic_coefficients_with_backward_differences(
        jnp.asarray(x)))
    jm = JaxNeuralCDE(input_dim=C, hidden_dim=H, output_dim=1, hidden_hidden_dim=HH,
                      num_layers=2)
    field = jax.tree.map(lambda a: np.asarray(a, np.float64),
                         jm.init(jax.random.PRNGKey(seed))["field"])
    z0 = rng.normal(size=(4, H))
    return coeffs, field, z0, H, C


def _jax_packed(field, H, C):
    from online_neural_cdes_tpu.ops import kernels as jax_kernels
    return jax_kernels.pack_fused_params(jax.tree.map(jnp.asarray, field), H, C, pad=False)


@pytest.mark.parametrize("method,adjoint", [("rk4", True), ("rk4", False),
                                            ("dopri5", True), ("dopri5", False)])
def test_cdeint_generic_path_matches_jax(method, adjoint):
    """Output times that are not the knot grid (a partial interval and a
    point between knots): the generic path, values and gradients of z0,
    the coefficients and the field."""
    coeffs, field, z0, H, C = _cdeint_case(8)
    t = np.array([0.0, 1.5, 2.0])
    opts = {"substeps": 2} if method == "rk4" else {"min_step": 0.5}
    from online_neural_cdes_tpu.ops import kernels as jax_kernels

    def jloss(c, z, fp):
        spline = jax_interp.CubicSpline.create(c)
        func = lambda tt, zz, dx, p: jax_kernels.fused_matmul_field(
            p["trunk"], p["head_w"], p["head_b"], zz, dx, H, C, False)
        zs = jax_cdeint.cdeint(spline, func, z, jnp.asarray(t), fp, adjoint=adjoint,
                               vector_field_type="matmul_fused", method=method,
                               atol=1e-6, rtol=1e-4, options=dict(opts))
        return jnp.sum(zs ** 2), zs

    (_, wz), wg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(coeffs), jnp.asarray(z0), _jax_packed(field, H, C))
    tc, tz = (torch.from_numpy(a).requires_grad_() for a in (coeffs, z0))
    tfield = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), field)
    tp = kernels.pack_fused_params(tfield, H, C)
    spline = interpolation.CubicSpline.create(tc)
    func = lambda tt, zz, dx, p: kernels.fused_matmul_field(
        p["trunk"], p["head_w"], p["head_b"], zz, dx, H, C)
    gz = torch_cdeint.cdeint(spline, func, tz, torch.from_numpy(t), tp, adjoint=adjoint,
                             vector_field_type="matmul_fused", method=method,
                             atol=1e-6, rtol=1e-4, options=dict(opts))
    torch.sum(gz ** 2).backward()
    close(gz, wz)
    close(tc.grad, wg[0], rtol=1e-8)
    close(tz.grad, wg[1], rtol=1e-8)
    jgrads = jax.grad(lambda f: jloss(jnp.asarray(coeffs), jnp.asarray(z0),
                                      _jax_packed(f, H, C))[0])(
        jax.tree.map(jnp.asarray, field))
    want = flatten_tree(jax.tree.map(np.asarray, jgrads))
    for name, leaf in flatten_tree(tfield).items():
        close(leaf.grad, want[name], rtol=1e-8, err_msg=name)


# ------------------------------------------------------------ the model


B, C, H, HH = 6, 4, 8, 8


def _model_pair(dtype, **kw):
    kw = dict(dict(input_dim=C, hidden_dim=H, output_dim=1, hidden_hidden_dim=HH,
                   num_layers=2, solver="dopri5"), **kw)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jm.init(jax.random.PRNGKey(0)))
    tm = NeuralCDE(**kw, device="cpu",
                   dtype=torch.float64 if dtype == jnp.float64 else torch.float32)
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    return jm, jparams, tm


def _coeffs(interp, L, dtype=np.float32, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(dtype)
    x[..., 0] = np.arange(L)
    if interp == "hermite":
        c = jax_interp.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x))
    else:
        c = jax_interp.linear_interpolation_coeffs(jnp.asarray(x), rectilinear=0)
    c = np.array(c)
    return jnp.asarray(c), torch.from_numpy(c)


SLICE = {"hermite": dict(interpolation="hermite", return_sequences=False),
         "rectilinear": dict(interpolation="rectilinear", return_sequences=True)}
SLICE_L = {"hermite": 6, "rectilinear": 10}


@pytest.mark.parametrize("interp", sorted(SLICE))
def test_neural_cde_dopri5_forward_matches_jax(interp):
    jm, jparams, tm = _model_pair(jnp.float32, **SLICE[interp])
    jc, tc = _coeffs(interp, SLICE_L[interp])
    want, wstats = jax.jit(lambda p, c: jm.apply(p, c, return_stats=True))(jparams, jc)
    with torch.inference_mode():
        got, gstats = tm(tc, return_stats=True)
    close32(got, want)
    same_stats(gstats, wstats)


def test_neural_cde_hermite_dopri5_matches_jax_in_float64():
    """The L=10 Hermite series of the float32 note, in float64."""
    jm, jparams, tm = _model_pair(jnp.float64, **SLICE["hermite"])
    jc, tc = _coeffs("hermite", 10, np.float64)
    want, wstats = jax.jit(lambda p, c: jm.apply(p, c, return_stats=True))(jparams, jc)
    got, gstats = tm(tc, return_stats=True)
    close(got, want)
    same_stats(gstats, wstats)


@pytest.mark.parametrize("adjoint", [True, False])
@pytest.mark.parametrize("interp", sorted(SLICE))
def test_neural_cde_dopri5_gradients_match_jax(interp, adjoint):
    jm, jparams, tm = _model_pair(jnp.float32, adjoint=adjoint, **SLICE[interp])
    jc, tc = _coeffs(interp, SLICE_L[interp])
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, jc) ** 2)))(jparams)
    solvers.reset_counts()
    torch.sum(tm(tc) ** 2).backward()
    want = flatten_tree(jax.tree.map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        close32(p.grad, want[name], name)
    kind = "reverse" if adjoint else "replay"
    assert solvers.COUNTS[kind]["evals"] > 0


@pytest.mark.parametrize("name", sorted(jax_solvers.ADAPTIVE_METHODS))
def test_neural_cde_takes_every_adaptive_solver(name):
    jm, jparams, tm = _model_pair(jnp.float64, solver=name, **SLICE["hermite"])
    jc, tc = _coeffs("hermite", 5, np.float64, seed=2)
    want, wstats = jax.jit(lambda p, c: jm.apply(p, c, return_stats=True))(jparams, jc)
    got, gstats = tm(tc, return_stats=True)
    close(got, want)
    same_stats(gstats, wstats)


def test_adjoint_method_may_be_adaptive_only_for_an_adaptive_solver():
    NeuralCDE(input_dim=C, hidden_dim=4, output_dim=1, solver="dopri5",
              adjoint_method="bosh3", device="cpu")
    with pytest.raises(ValueError, match="adjoint_method"):
        NeuralCDE(input_dim=C, hidden_dim=4, output_dim=1, solver="rk4",
                  adjoint_method="bosh3", device="cpu")


def test_train_step_config3_like_matches_jax():
    """One Adam step of a small model shaped as the JAX bench's config 3:
    Hermite, dopri5 with min_step=0.5, adjoint=False, MSE."""
    jm, jparams, tm = _model_pair(jnp.float32, adjoint=False, **SLICE["hermite"])
    jc, tc = _coeffs("hermite", 6, seed=3)
    labels = np.random.default_rng(3).normal(size=(B,)).astype(np.float32)
    jstep = jax_loop.make_train_step(jm, loss="mse", lr=1e-2, donate=False)
    jparams, _, want = jstep(jparams, jax_loop.init_adam_state(jparams), jc,
                             jnp.asarray(labels), 1.0)
    got = loop.make_train_step(tm, loss="mse", lr=1e-2)(tc, torch.from_numpy(labels), 1.0)
    close32(got, want)
    want_p = flatten_tree(jax.tree.map(np.asarray, jparams))
    for name, p in tm.state_dict().items():
        close32(p, want_p[name], name)


def test_predictor_with_a_dopri5_model_matches_jax():
    jm, jparams, tm = _model_pair(jnp.float32, static_dim=2, **SLICE["rectilinear"])
    rng = np.random.default_rng(9)
    reqs = []
    for length in (5, 7, 4):
        s = rng.normal(size=(length, C)).astype(np.float32)
        s[:, 0] = np.arange(length)
        reqs.append(s)
    static = rng.normal(size=(3, 2)).astype(np.float32)
    kw = dict(batch_buckets=(4,), length_multiple=4)
    jp = JaxPredictor(jm, jparams, coeff_fn=lambda x: jax_interp.linear_interpolation_coeffs(
        x, rectilinear=0), **kw)
    tp = Predictor(tm, coeff_fn=lambda x: interpolation.linear_interpolation_coeffs(
        x, rectilinear=0), device="cpu", **kw)
    for g, w in zip(tp.predict(reqs, static=static), jp.predict(reqs, static=static)):
        close32(g, w)
