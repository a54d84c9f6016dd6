"""Parity of the PyTorch port's vector-field zoo against the JAX package, on
the CPU: every valid (kind, type) pair of ``VectorField`` (forward and
VJP), the plain ``matmul``/``evaluate``/``derivative`` fields of ``cdeint``
on the piece scan and on the generic dopri5 path, ``TupleControl`` under
``matmul``, ``NeuralCDE`` with each field, and ``OnlineNCDEStepper`` over a
gated field.

Weights are made by the JAX ``init`` and carried across with
``params_from_jax``; inputs come from numpy with a fixed seed.  Module and
model tests run in float64 on both sides at rtol=1e-9, atol=1e-10 (the
same formulas, only summation order differs); the slice test in float32 at
rtol=1e-5, atol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.models.vector_fields import VectorField as JaxVectorField
from online_neural_cdes_tpu.ops import cdeint as jax_cdeint_mod
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu_torch import NeuralCDE, OnlineNCDEStepper, params_from_jax
from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
from online_neural_cdes_tpu_torch.ops import cdeint as torch_cdeint_mod
from online_neural_cdes_tpu_torch.ops import interpolation, kernels
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
B, L, C, H, HH = 3, 5, 3, 4, 5

# Every valid (kind, vector_field_type, sparsity): the sparse and low-rank
# kinds take matmul only and need a sparsity.
FIELDS = ([(kind, vf_type, None) for kind in ("original", "gru", "minimal")
           for vf_type in ("matmul", "evaluate", "derivative")]
          + [("sparse", "matmul", 0.5), ("low-rank", "matmul", 0.5)])
FIELD_IDS = [f"{k}-{t}" for k, t, _ in FIELDS]


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _field(seed, kind, vf_type, sparsity, num_layers=2):
    jf = JaxVectorField(input_dim=C, hidden_dim=H, hidden_hidden_dim=HH,
                        num_layers=num_layers, sparsity=sparsity,
                        vector_field_type=vf_type, kind=kind)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float64),
                           jf.init(jax.random.PRNGKey(seed)))
    tf = VectorField(C, H, HH, num_layers, sparsity, vf_type, kind,
                     generator=torch.Generator().manual_seed(seed),
                     dtype=torch.float64, device="cpu")
    params_from_jax(_np_tree(jparams), tf)
    return jf, jparams, tf


def _leaves_requiring_grad(tree):
    """The field's tensors as fresh leaves; the sparse mask takes no grad."""
    return {k: ([{n: t.detach().clone().requires_grad_() for n, t in layer.items()}
                 for layer in v] if k == "trunk" else
                v.detach().clone() if k == "mask" else
                {n: t.detach().clone().requires_grad_() for n, t in v.items()})
            for k, v in tree.items()}


def _flat_grads(tree):
    return {k: t.grad for k, t in flatten_tree(tree).items()}


@pytest.mark.parametrize("kind,vf_type,sparsity", FIELDS, ids=FIELD_IDS)
def test_vector_field_matches_jax(kind, vf_type, sparsity):
    """Forward and VJP (state and every parameter) of each (kind, type)
    pair; the sparse mask's cotangent is zero in JAX and absent here."""
    jf, jparams, tf = _field(len(kind) + len(vf_type), kind, vf_type, sparsity)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, tf.initial_dim))
    want, vjp = jax.vjp(lambda p, x: jf.apply(p, 0.0, x), jparams, jnp.asarray(h))
    g = rng.normal(size=want.shape)
    w_params, w_h = vjp(jnp.asarray(g))

    tp = _leaves_requiring_grad(tf.params)
    th = torch.from_numpy(h).requires_grad_()
    got = tf.apply(tp, 0.0, th)
    assert tuple(got.shape) == want.shape
    assert want.shape == ((B, H, C) if vf_type == "matmul" else (B, H))
    close(got, want)
    close(tf(0.0, torch.from_numpy(h)), want)
    got.backward(torch.from_numpy(g))
    close(th.grad, w_h)
    want_flat = flatten_tree(_np_tree(w_params))
    for key, grad in _flat_grads(tp).items():
        if key == "mask":
            assert grad is None and not np.any(want_flat[key])
        else:
            close(grad, want_flat[key], err_msg=key)


def test_sparse_mask_is_a_buffer_adam_leaves_alone():
    _, jparams, tf = _field(3, "sparse", "matmul", 0.5)
    names = [n for n, _ in tf.named_parameters()]
    assert "mask" not in names and "mask" in tf.state_dict()
    mask = tf.mask.clone()
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    close(mask, jparams["mask"], rtol=0, atol=0)
    opt = loop.make_optimizer(tf, lr=0.1)
    tf(0.0, torch.randn(B, H, dtype=torch.float64)).sum().backward()
    opt.step()
    assert torch.equal(tf.mask, mask)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="sparse"), "requires sparsity"),
    (dict(kind="low-rank", sparsity=0.5, vector_field_type="evaluate"), "matmul"),
    (dict(kind="gru", sparsity=0.5), "gated"),
    (dict(kind="dense"), "unknown vector field"),
])
def test_vector_field_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        VectorField(C, H, generator=torch.Generator(), device="cpu", **kw)


# ------------------------------------------------------------ cdeint


def _control(seed, n=L, hermite=False):
    """Linear coefficients, or Hermite cubic ones (a smooth control, whose
    adaptive solves have no kinks to flip a step decision at round-off)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n, C))
    x[..., 0] = np.arange(n)
    x[1, 2, 1] = np.nan
    build = (jax_interp.hermite_cubic_coefficients_with_backward_differences if hermite
             else jax_interp.linear_interpolation_coeffs)
    return np.array(build(jnp.asarray(x))), rng


def _cdeint_grads_jax(jf, jparams, coeffs, z0, vf_type, spline="LinearInterpolation",
                      **kw):
    def loss(z0_, p, coeffs_):
        X = getattr(jax_interp, spline).create(coeffs_)
        zs = jax_cdeint_mod.cdeint(X, lambda t, z, p_: jf.apply(p_, t, z), z0_,
                                   X.grid_points, p, vector_field_type=vf_type, **kw)
        return jnp.sum(zs ** 2) + jnp.sum(zs[..., -1, :]), zs

    (value, zs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(z0), jparams, jnp.asarray(coeffs))
    return zs, grads


def _cdeint_grads_torch(tf, coeffs, z0, vf_type, spline="LinearInterpolation", **kw):
    tp = _leaves_requiring_grad(tf.params)
    z0 = torch.from_numpy(z0).requires_grad_()
    coeffs = torch.from_numpy(coeffs).requires_grad_()
    X = getattr(interpolation, spline).create(coeffs)
    zs = torch_cdeint_mod.cdeint(X, lambda t, z, p: tf.apply(p, t, z), z0, X.grid_points,
                                 tp, vector_field_type=vf_type, **kw)
    (torch.sum(zs ** 2) + torch.sum(zs[..., -1, :])).backward()
    return zs, z0.grad, _flat_grads(tp), coeffs.grad


def _close_cdeint(got, want, rtol=RTOL, atol=ATOL):
    zs, dz0, dparams, dcoeffs = got
    w_zs, (w_z0, w_p, w_coeffs) = want
    close(zs, w_zs, rtol, atol, "states")
    close(dz0, w_z0, rtol, atol, "z0")
    close(dcoeffs, w_coeffs, rtol, atol, "coeffs")
    w_flat = flatten_tree(_np_tree(w_p))
    for key, grad in dparams.items():
        close(grad, w_flat[key], rtol, atol, key)
    assert float(dcoeffs.abs().max()) > 0


@pytest.mark.parametrize("adjoint", [True, False], ids=["adjoint", "direct"])
@pytest.mark.parametrize("vf_type", ["matmul", "evaluate", "derivative"])
def test_cdeint_plain_fields_on_the_piece_scan_match_jax(vf_type, adjoint):
    """The unfused fields on the fixed-grid piece scan, differentiated by
    the interval adjoint and by autograd through the scan: states and
    gradients of z0, every parameter and the coefficients."""
    jf, jparams, tf = _field(20, "original", vf_type, None)
    coeffs, rng = _control(20)
    z0 = rng.normal(size=(B, H))
    kw = dict(adjoint=adjoint, method="rk4", options={"substeps": 2})
    _close_cdeint(_cdeint_grads_torch(tf, coeffs, z0, vf_type, **kw),
                  _cdeint_grads_jax(jf, jparams, coeffs, z0, vf_type, **kw))


@pytest.mark.parametrize("vf_type", ["matmul", "evaluate", "derivative"])
def test_cdeint_plain_fields_through_odeint_adjoint_match_jax(vf_type):
    """The generic path: dopri5 over the device lookup of a Hermite
    control, differentiated by ``odeint_adjoint`` with the field's plain
    VJPs.  The reverse solves step about a hundred times under the error
    controller, whose step sizes carry each side's round-off into every
    gradient: held at rtol=atol=1e-8 on gradients of order one (the
    adaptive tests' 1e-8)."""
    jf, jparams, tf = _field(21, "gru" if vf_type == "matmul" else "minimal", vf_type,
                             None)
    coeffs, rng = _control(21, hermite=True)
    z0 = rng.normal(size=(B, H))
    kw = dict(adjoint=True, method="dopri5", atol=1e-6, rtol=1e-4, spline="CubicSpline")
    _close_cdeint(_cdeint_grads_torch(tf, coeffs, z0, vf_type, **kw),
                  _cdeint_grads_jax(jf, jparams, coeffs, z0, vf_type, **kw),
                  rtol=1e-8, atol=1e-8)


def test_tuple_control_matmul_sums_one_matrix_per_control():
    """Two controls under ``"matmul"``: dz = sum_k f_k(z) dX_k, forward and
    gradients, on the generic path."""
    fields = [_field(22 + k, "original", "matmul", None) for k in range(2)]
    coeffs = [_control(22 + k)[0] for k in range(2)]
    z0 = np.random.default_rng(22).normal(size=(B, H))
    t = np.linspace(0.0, L - 1, 3)

    def jloss(z0_, ps):
        X = jax_interp.TupleControl.create(
            *[jax_interp.LinearInterpolation.create(jnp.asarray(c)) for c in coeffs])
        zs = jax_cdeint_mod.cdeint(
            X, lambda t_, z, p: tuple(f.apply(pk, t_, z) for (f, _, _), pk in zip(fields, p)),
            z0_, jnp.asarray(t), ps, vector_field_type="matmul", method="rk4",
            options={"substeps": 2})
        return jnp.sum(zs ** 2), zs

    (_, want), (w_z0, w_ps) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(z0), [p for _, p, _ in fields])
    tps = [_leaves_requiring_grad(tf.params) for _, _, tf in fields]
    tz0 = torch.from_numpy(z0).requires_grad_()
    X = interpolation.TupleControl.create(
        *[interpolation.LinearInterpolation.create(torch.from_numpy(c)) for c in coeffs])
    got = torch_cdeint_mod.cdeint(
        X, lambda t_, z, p: tuple(tf.apply(pk, t_, z) for (_, _, tf), pk in zip(fields, p)),
        tz0, torch.from_numpy(t), tps, vector_field_type="matmul", method="rk4",
        options={"substeps": 2})
    close(got, want)
    torch.sum(got ** 2).backward()
    close(tz0.grad, w_z0)
    for tp, wp in zip(tps, w_ps):
        w_flat = flatten_tree(_np_tree(wp))
        for key, grad in _flat_grads(tp).items():
            close(grad, w_flat[key], err_msg=key)


# ------------------------------------------------------------- NeuralCDE


def _model_pair(seed, kind, vf_type, sparsity, dtype=jnp.float64, **kw):
    kw = dict(dict(input_dim=C, hidden_dim=H, output_dim=2, hidden_hidden_dim=HH,
                   num_layers=2, vector_field=kind, vector_field_type=vf_type,
                   sparsity=sparsity), **kw)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jm.init(jax.random.PRNGKey(seed)))
    tm = NeuralCDE(**kw, device="cpu",
                   dtype=torch.float64 if dtype == jnp.float64 else torch.float32)
    params_from_jax(_np_tree(jparams), tm)
    return jm, jparams, tm


def _series(seed, n=L, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n, C)).astype(dtype)
    x[..., 0] = np.arange(n)
    x[0, 2, 1] = np.nan
    return x


@pytest.mark.parametrize("kind,vf_type,sparsity", FIELDS, ids=FIELD_IDS)
def test_neural_cde_with_each_field_matches_jax(kind, vf_type, sparsity):
    """Forward (every output time) and the gradients of every parameter
    through the interval adjoint, rectilinear controls; the original/matmul
    field takes the fused op, every other the plain field."""
    jm, jparams, tm = _model_pair(30, kind, vf_type, sparsity, interpolation="rectilinear",
                                  return_sequences=True, adjoint=True)
    assert tm.uses_fused_field == (kind == "original" and vf_type == "matmul")
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(
        jnp.asarray(_series(30)), rectilinear=0))
    rng = np.random.default_rng(31)
    want, vjp = jax.vjp(lambda p: jm.apply(p, jnp.asarray(coeffs)), jparams)
    g = rng.normal(size=want.shape)
    (w_grads,) = vjp(jnp.asarray(g))
    got = tm(torch.from_numpy(coeffs))
    close(got, want)
    got.backward(torch.from_numpy(g))
    w_flat = flatten_tree(_np_tree(w_grads))
    for name, p in tm.named_parameters():
        close(p.grad, w_flat[name], err_msg=name)


def test_neural_cde_plain_field_float32_slice_matches_jax():
    """The slice's own precision: a gated field with statics in float32 on
    both sides, forward and one Adam step's loss."""
    jm, jparams, tm = _model_pair(32, "gru", "matmul", None, dtype=jnp.float32,
                                  static_dim=2, interpolation="linear",
                                  return_sequences=True)
    x = _series(32, dtype=np.float32)
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x)))
    static = np.random.default_rng(32).normal(size=(B, 2)).astype(np.float32)
    with torch.inference_mode():
        got = tm((torch.from_numpy(static), torch.from_numpy(coeffs)))
    want = jm.apply(jparams, (jnp.asarray(static), jnp.asarray(coeffs)))
    close(got, want, rtol=1e-5, atol=1e-6)


def test_fused_false_is_ignored_for_the_original_field_only():
    _, _, tm = _model_pair(33, "original", "matmul", None, fused=False)
    assert tm.uses_fused_field
    *_, vf_type = tm.make_solve_func(None)
    assert vf_type == "matmul_fused"
    _, _, tm = _model_pair(33, "minimal", "matmul", None)
    *_, vf_type = tm.make_solve_func(None)
    assert vf_type == "matmul"


def test_plain_fields_launch_no_kernel_on_the_cpu():
    _, _, tm = _model_pair(34, "low-rank", "matmul", 0.5, interpolation="rectilinear",
                           return_sequences=True)
    coeffs = torch.from_numpy(np.array(jax_interp.linear_interpolation_coeffs(
        jnp.asarray(_series(34)), rectilinear=0)))
    before = kernels.fused_field_kernel.launches
    tm(coeffs).sum().backward()
    assert kernels.fused_field_kernel.launches == before


# --------------------------------------------------------------- stepper


@pytest.mark.parametrize("kind,sparsity", [("gru", None), ("sparse", 0.5)])
def test_stepper_over_a_plain_field_matches_the_offline_rows(kind, sparsity):
    """``OnlineNCDEStepper`` over a non-original matmul field: after k
    observations its output equals the offline model's row k."""
    _, _, tm = _model_pair(35, kind, "matmul", sparsity, interpolation="rectilinear",
                           return_sequences=True, static_dim=2)
    x = _series(35)
    x[1, 3, 2] = np.nan
    static = np.random.default_rng(35).normal(size=(B, 2))
    coeffs = interpolation.linear_interpolation_coeffs(torch.from_numpy(x), rectilinear=0)
    with torch.inference_mode():
        offline = tm((torch.from_numpy(static), coeffs))
    stepper = OnlineNCDEStepper(tm, static=static, device="cpu")
    state = stepper.init(x[:, 0])
    rows = [stepper.readout(state["z"])]
    for k in range(1, L):
        state, y = stepper.step(state, x[:, k])
        rows.append(y)
    close(torch.stack(rows, dim=1), offline)
    _, ys = stepper.step_many(stepper.init(x[:, 0]), np.swapaxes(x[:, 1:], 0, 1))
    close(ys.transpose(0, 1), offline[:, 1:])
