"""The spline family of the PyTorch port against the JAX package, on the
CPU: ``tridiagonal_solve``, natural cubic (both versions) and Hermite
coefficients, ``CubicSpline``, ``SmoothLinearInterpolation``,
``TupleControl`` and ``linear_rectilinear_hybrid`` (module tests, float64
at rtol=1e-9, atol=1e-10); then the slice: ``NeuralCDE`` with each of the
cubic, Hermite and smoothed schemes (forward and parameter gradients,
float32 at rtol=1e-5), a Hermite ``Predictor``, and the toy's cubic and
Hermite loss curves.

Inputs come from numpy with a fixed seed; weights are made by the JAX
``init`` and carried across with ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import struct

from online_neural_cdes_tpu.models import ncde as jax_ncde
from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops import fill as jax_fill
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.serving import Predictor as JaxPredictor
from online_neural_cdes_tpu_torch import NeuralCDE, Predictor, params_from_jax
from online_neural_cdes_tpu_torch.experiments import sim_bm_toy
from online_neural_cdes_tpu_torch.models.ncde import make_spline
from online_neural_cdes_tpu_torch.ops import fill, interpolation
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
F32_RTOL, F32_ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _series(seed, shape=(3, 9, 4)):
    """A NaN-holding batch: interior, leading and trailing gaps, an all-NaN
    channel of one series, a whole missing observation, and a fully
    observed time channel 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    x[..., 0] = np.arange(shape[-2])
    x[0, 2:4, 1] = np.nan          # interior gap
    x[1, :3, 2] = np.nan           # leading gap
    x[2, :, 3] = np.nan            # all-NaN channel
    x[0, -2:, 3] = np.nan          # trailing gap
    x[1, 5, 1:] = np.nan           # whole observation missing
    return x


def _times(seed, length):
    return np.cumsum(np.random.default_rng(seed).uniform(0.5, 2.0, size=length))


# ------------------------------------------------------------ modules


@pytest.mark.parametrize("n", [1, 2, 7])
def test_tridiagonal_solve_matches_jax(n):
    rng = np.random.default_rng(n)
    b, diag = rng.normal(size=(3, 2, n)), rng.uniform(3.0, 4.0, size=(3, 2, n))
    upper, lower = rng.normal(size=(3, 2, n - 1)), rng.normal(size=(3, 2, n - 1))
    got = fill.tridiagonal_solve(*(torch.from_numpy(a) for a in (b, upper, diag, lower)))
    close(got, jax_fill.tridiagonal_solve(*(jnp.asarray(a) for a in (b, upper, diag,
                                                                      lower))))


@pytest.mark.parametrize("name", ["natural_cubic_coeffs", "natural_cubic_spline_coeffs",
                                  "hermite_cubic_coefficients_with_backward_differences"])
@pytest.mark.parametrize("explicit_t", [False, True])
def test_cubic_coefficients_match_jax(name, explicit_t):
    """Leading, trailing, interior and all-NaN channels, on the unit grid
    and on explicit irregular times."""
    x = _series(1)
    t = _times(1, x.shape[-2]) if explicit_t else None
    got = getattr(interpolation, name)(torch.from_numpy(x),
                                       None if t is None else torch.from_numpy(t))
    want = getattr(jax_interp, name)(jnp.asarray(x), None if t is None else jnp.asarray(t))
    assert got.shape == (3, 8, 16)
    close(got, want)
    assert torch.isfinite(got).all()
    if name != "hermite_cubic_coefficients_with_backward_differences":
        assert (got[2, :, 3::4] == 0).all()  # the all-NaN channel: a zero path


def test_cubic_coefficients_refuse_a_single_knot():
    for name in ("natural_cubic_coeffs", "hermite_cubic_coefficients_with_backward_differences"):
        with pytest.raises(ValueError, match="at least 2"):
            getattr(interpolation, name)(torch.zeros(2, 1, 3))


T_QUERIES = [2.0, 3.7, -1.5, 11.0, np.array([0.0, 0.25, 4.5, 7.99, 8.0, 9.5, -0.5])]


def _spline_pair(kind, seed=2):
    x = _series(seed)
    if kind in ("natural", "hermite"):
        builder = ("natural_cubic_coeffs" if kind == "natural" else
                   "hermite_cubic_coefficients_with_backward_differences")
        coeffs = np.array(getattr(jax_interp, builder)(jnp.asarray(x)))
        return (interpolation.CubicSpline.create(torch.from_numpy(coeffs)),
                jax_interp.CubicSpline.create(jnp.asarray(coeffs)))
    quintic, eps = {"cubic_0.5": (False, 0.5), "cubic_1": (False, 1.0),
                    "quintic_0.5": (True, 0.5), "quintic_0.2": (True, 0.2)}[kind]
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x)))
    return (interpolation.SmoothLinearInterpolation.create(torch.from_numpy(coeffs), eps,
                                                           quintic),
            jax_interp.SmoothLinearInterpolation.create(jnp.asarray(coeffs), eps,
                                                        quintic))


@pytest.mark.parametrize("kind", ["natural", "hermite", "cubic_0.5", "cubic_1",
                                  "quintic_0.5", "quintic_0.2"])
def test_spline_evaluate_derivative_and_pieces_match_jax(kind):
    """``evaluate`` / ``derivative`` at scalar, vector and out-of-range
    times, the grid, and the piece-wise API at a few fractions."""
    ours, theirs = _spline_pair(kind)
    close(ours.grid_points, theirs.grid_points)
    close(ours.interval, theirs.interval)
    assert ours.host_grid() == tuple(float(v) for v in np.asarray(theirs.t))
    for t in T_QUERIES:
        close(ours.evaluate(t), theirs.evaluate(jnp.asarray(t)), err_msg=f"evaluate {t}")
        close(ours.derivative(t), theirs.derivative(jnp.asarray(t)),
              err_msg=f"derivative {t}")
    ours_p, theirs_p = ours.piece_data(), theirs.piece_data()
    assert set(ours_p) == set(theirs_p)
    for key in ours_p:
        close(ours_p[key], theirs_p[key], err_msg=key)
    for i in (0, 3, 7):
        op = {k: v[i] for k, v in ours_p.items()}
        tp = {k: v[i] for k, v in theirs_p.items()}
        for frac in (0.0, 0.1, 0.5, 0.9):
            close(type(ours).piece_derivative(op, frac),
                  type(theirs).piece_derivative(tp, frac), err_msg=f"piece {i} d {frac}")
            close(type(ours).piece_evaluate(op, frac),
                  type(theirs).piece_evaluate(tp, frac), err_msg=f"piece {i} x {frac}")


def test_spline_constructors_refuse_bad_input():
    with pytest.raises(ValueError, match="invalid coeffs"):
        interpolation.CubicSpline.create(torch.zeros(2, 3, 5))
    with pytest.raises(NotImplementedError, match="times"):
        interpolation.SmoothLinearInterpolation.create(torch.zeros(2, 4, 3), 0.5,
                                                       t=torch.arange(4.0))
    for eps in (0.0, 1.5):
        with pytest.raises(ValueError, match="eps"):
            interpolation.SmoothLinearInterpolation.create(torch.zeros(2, 4, 3), eps)
    assert interpolation.NaturalCubicSpline is interpolation.CubicSpline


def test_cubic_spline_keeps_host_times_and_explicit_grid():
    x = _series(3)
    t = _times(3, x.shape[-2])
    coeffs = interpolation.natural_cubic_coeffs(torch.from_numpy(x), torch.from_numpy(t))
    ours = interpolation.CubicSpline.create(coeffs, t)
    theirs = jax_interp.CubicSpline.create(
        jax_interp.natural_cubic_coeffs(jnp.asarray(x), jnp.asarray(t)), jnp.asarray(t))
    assert ours.host_grid() == tuple(t.tolist())
    query = np.array([t[0], 0.5 * (t[2] + t[3]), t[-1] + 1.0])
    close(ours.evaluate(query), theirs.evaluate(jnp.asarray(query)))
    close(ours.derivative(query), theirs.derivative(jnp.asarray(query)))


def test_tuple_control_matches_jax_and_refuses_mismatches():
    x = _series(4)
    lin = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x)))
    cub = np.array(jax_interp.natural_cubic_coeffs(jnp.asarray(x)))
    ours = interpolation.TupleControl.create(
        interpolation.LinearInterpolation.create(torch.from_numpy(lin)),
        interpolation.CubicSpline.create(torch.from_numpy(cub)))
    theirs = jax_interp.TupleControl.create(
        jax_interp.LinearInterpolation.create(jnp.asarray(lin)),
        jax_interp.CubicSpline.create(jnp.asarray(cub)))
    close(ours.grid_points, theirs.grid_points)
    close(ours.interval, theirs.interval)
    assert ours.host_grid() == tuple(range(9))
    for t in (2.5, np.array([0.5, 7.5])):
        for g, w in zip(ours.evaluate(t), theirs.evaluate(jnp.asarray(t))):
            close(g, w)
        for g, w in zip(ours.derivative(t), theirs.derivative(jnp.asarray(t))):
            close(g, w)
    with pytest.raises(ValueError, match="one or more"):
        interpolation.TupleControl.create()
    with pytest.raises(ValueError, match="same interval"):
        interpolation.TupleControl.create(
            interpolation.LinearInterpolation.create(torch.from_numpy(lin)),
            interpolation.LinearInterpolation.create(torch.from_numpy(lin[:, :5])))
    uneven = interpolation.TupleControl.create(
        interpolation.LinearInterpolation.create(torch.from_numpy(lin)),
        interpolation.LinearInterpolation.create(torch.from_numpy(lin[:, ::2]),
                                                 t=np.arange(0.0, 9.0, 2.0)))
    with pytest.raises(RuntimeError, match="different grid points"):
        uneven.grid_points


def test_linear_rectilinear_hybrid_matches_jax():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(3, 8, 4))
    data[..., 0] = np.arange(8)
    data[:, ::2, 1] = np.nan          # a sparse channel, rectilinear
    data[:, 3:, 2] = data[:, 3:4, 2]  # a channel that stops changing
    data[1, 2, 3] = np.nan
    got = interpolation.linear_rectilinear_hybrid(data, [1])
    want = jax_interp.linear_rectilinear_hybrid(data, [1])
    assert got.shape == want.shape
    close(got, want)
    with pytest.raises(TypeError, match="list"):
        interpolation.linear_rectilinear_hybrid(data, (1,))


# -------------------------------------------------------------- slice


SPLINE_CASES = {
    "cubic": ("cubic", None, "natural_cubic_coeffs"),
    "hermite": ("hermite", None, "hermite_cubic_coefficients_with_backward_differences"),
    "linear_cubic_smoothing": ("linear_cubic_smoothing", 0.4, "linear_interpolation_coeffs"),
    "linear_quintic_smoothing": ("linear_quintic_smoothing", 0.6,
                                 "linear_interpolation_coeffs"),
}
B, L, C, H, HH, S = 4, 6, 3, 5, 7, 2


def _model_pair(case, seed=0, **kw):
    interp_name, eps, builder = SPLINE_CASES[case]
    kw = dict(dict(input_dim=C, hidden_dim=H, output_dim=2, hidden_hidden_dim=HH,
                   num_layers=2, solver="rk4", interpolation=interp_name,
                   interpolation_eps=eps, return_sequences=True, static_dim=S), **kw)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init(jax.random.PRNGKey(seed)))
    tm = NeuralCDE(**kw, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[..., 0] = np.arange(L)
    if builder != "linear_interpolation_coeffs":
        x[0, 2, 1] = np.nan
        x[3, 1:3, 2] = np.nan
    coeffs = np.array(getattr(jax_interp, builder)(jnp.asarray(x)), np.float32)
    static = rng.normal(size=(B, S)).astype(np.float32)
    return (jm, jparams, tm, (jnp.asarray(static), jnp.asarray(coeffs)),
            (torch.from_numpy(static), torch.from_numpy(coeffs)))


def test_make_spline_covers_the_registry():
    x = torch.from_numpy(_series(6)[:, :, :3])
    lin = interpolation.linear_interpolation_coeffs(x)
    cub = interpolation.natural_cubic_coeffs(x)
    kinds = {"linear": (lin, interpolation.LinearInterpolation),
             "rectilinear": (lin, interpolation.LinearInterpolation),
             "cubic": (cub, interpolation.CubicSpline),
             "hermite": (cub, interpolation.CubicSpline),
             "linear_cubic_smoothing": (lin, interpolation.SmoothLinearInterpolation),
             "linear_quintic_smoothing": (lin, interpolation.SmoothLinearInterpolation)}
    for name, (coeffs, cls) in kinds.items():
        assert type(make_spline(name, coeffs, 0.5)) is cls
    with pytest.raises(ValueError, match="Unrecognised"):
        make_spline("quadratic", lin)


@pytest.mark.parametrize("case", sorted(SPLINE_CASES))
@pytest.mark.parametrize("return_sequences", [True, False])
def test_neural_cde_with_spline_matches_jax(case, return_sequences):
    jm, jparams, tm, jin, tin = _model_pair(case, seed=1,
                                            return_sequences=return_sequences)
    with torch.inference_mode():
        got = tm(tin)
    want = jm.apply(jparams, jin)
    assert got.shape == want.shape
    close(got, want, rtol=F32_RTOL, atol=F32_ATOL)


def _close_grads(tm, jgrads):
    want = flatten_tree(jax.tree.map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        close(got[name].grad, w, rtol=F32_RTOL, atol=F32_ATOL * float(np.abs(w).max()),
              err_msg=name)


@struct.dataclass
class _JaxSmoothFloatMask(jax_interp.SmoothLinearInterpolation):
    """The JAX smoothing spline with its boolean piece mask carried as a
    float (0/1), else the same arithmetic.  The JAX interval adjoint cannot
    carry the boolean leaf's float0 cotangent (ROADMAP C), so the oracle of
    the smoothing splines' adjoint gradients uses this copy."""

    def piece_data(self):
        p = super().piece_data()
        return dict(p, has_match=p["has_match"].astype(self.coeffs.dtype))

    @staticmethod
    def piece_derivative(piece, frac):
        return jax_interp.SmoothLinearInterpolation.piece_derivative(
            dict(piece, has_match=piece["has_match"] > 0), frac)

    @staticmethod
    def piece_evaluate(piece, frac):
        return jax_interp.SmoothLinearInterpolation.piece_evaluate(
            dict(piece, has_match=piece["has_match"] > 0), frac)


_jax_make_spline = jax_ncde.make_spline


def _float_mask_make_spline(interpolation_name, coeffs, eps=None):
    if interpolation_name.endswith("_smoothing"):
        return _JaxSmoothFloatMask.create(
            coeffs, gradient_matching_eps=eps,
            match_second_derivatives=interpolation_name == "linear_quintic_smoothing")
    return _jax_make_spline(interpolation_name, coeffs, eps)


@pytest.mark.parametrize("case", sorted(SPLINE_CASES))
@pytest.mark.parametrize("adjoint", [True, False])
def test_neural_cde_with_spline_gradients_match_jax(case, adjoint, monkeypatch):
    """Parameter gradients through the interval adjoint and through direct
    backprop, float32 (per tensor, atol 1e-6 x its largest entry).  The JAX
    model differentiates the smoothing splines through its adjoint only
    with the float-mask copy of the spline."""
    if adjoint and case.endswith("_smoothing"):
        monkeypatch.setattr(jax_ncde, "make_spline", _float_mask_make_spline)
    jm, jparams, tm, jin, tin = _model_pair(case, seed=2, adjoint=adjoint)

    def jloss(p):
        return jnp.sum(jm.apply(p, jin) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(jparams)
    torch.sum(tm(tin) ** 2).backward()
    _close_grads(tm, jgrads)


def test_hermite_predictor_matches_jax():
    """Ragged NaN-holding requests through a Hermite ``Predictor``: the
    causal cubic scheme serves offline batches like the linear ones."""
    kw = dict(input_dim=C, hidden_dim=6, output_dim=2, hidden_hidden_dim=8,
              num_layers=2, solver="rk4", adjoint=False, interpolation="hermite",
              return_sequences=True)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init(jax.random.PRNGKey(3)))
    tm = NeuralCDE(**kw, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    jp = JaxPredictor(jm, jparams, batch_buckets=(2, 4), length_multiple=8,
                      coeff_fn=jax_interp.hermite_cubic_coefficients_with_backward_differences)
    tp = Predictor(tm, batch_buckets=(2, 4), length_multiple=8, device="cpu",
                   coeff_fn=interpolation.hermite_cubic_coefficients_with_backward_differences)
    rng = np.random.default_rng(3)
    reqs = []
    for length in (5, 11, 7):
        s = rng.normal(size=(length, C)).astype(np.float32)
        s[:, 0] = np.arange(length)
        s[1:][rng.random(size=(length - 1, C)) < 0.2] = np.nan
        s[:, 0] = np.arange(length)
        reqs.append(s)
    want, got = jp.predict(reqs), tp.predict(reqs)
    for g, w, r in zip(got, want, reqs):
        assert g.shape == w.shape == (len(r), 2)
        close(g, w, rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.parametrize("scheme", ["cubic", "cubic_hermite"])
def test_toy_loss_curve_matches_jax_for_cubic_schemes(scheme):
    """The toy's natural cubic and Hermite schemes trained by the port's
    ``train_scheme`` and by the JAX script's loop (optax.adam(1e-3), mean
    sigmoid BCE) from the same numpy data and weights, in float64."""
    rng = np.random.default_rng(13)
    inc = rng.normal(size=(16, 2)) * np.sqrt(0.5)
    bm = np.concatenate([np.zeros((16, 1)), np.cumsum(inc, axis=1)], axis=1)
    x = np.stack([np.broadcast_to(np.linspace(0, 1, 3), bm.shape), bm], axis=-1)
    y = np.broadcast_to((bm[:, -1:] > 0).astype(np.float64), bm.shape).copy()
    interp_name = sim_bm_toy.SCHEMES[scheme][0]
    kw = dict(input_dim=2, hidden_dim=3, output_dim=1, hidden_hidden_dim=4, num_layers=2,
              interpolation=interp_name, return_sequences=True, adjoint=True,
              solver="rk4")
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float64), jm.init(jax.random.PRNGKey(2)))
    tm = NeuralCDE(**kw, device="cpu", dtype=torch.float64)
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)

    data = tuple(torch.from_numpy(a) for a in (x, y, x, y))
    got = sim_bm_toy.train_scheme(scheme, data, epochs=2, hidden=3, width=4, reps=1,
                                  batch_size=8, device="cpu", models=[tm])

    coeffs = (jax_interp.natural_cubic_coeffs(jnp.asarray(x)) if scheme == "cubic" else
              jax_interp.hermite_cubic_coefficients_with_backward_differences(
                  jnp.asarray(x)))
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, s, c, lab):
        def loss_fn(p_):
            logits = jm.apply(p_, c)[..., 0]
            return optax.sigmoid_binary_cross_entropy(logits, lab).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    state, want = opt.init(jparams), []
    for _ in range(2):
        for b in range(2):
            jparams, state, value = step(jparams, state, coeffs[b * 8:(b + 1) * 8],
                                         jnp.asarray(y[b * 8:(b + 1) * 8]))
            want.append(float(value))
    assert got["losses"].shape == (1, 4)
    close(got["losses"][0], want, rtol=1e-8)
