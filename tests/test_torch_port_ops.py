"""Parity of the PyTorch port's ops against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both sides; weights
are made by the JAX ``init`` and carried across.  Module tests run in
float64 on both sides (the test conftest enables x64) and hold the port to
rtol=1e-9, atol=1e-10: the two compute the same formulas, so only
summation order separates them.  The Hopper kernel itself needs the card;
``chip_smoke.py`` holds it against the plain version checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.data.loader import pad_ragged as jax_pad_ragged
from online_neural_cdes_tpu.models.vector_fields import VectorField as JaxVectorField
from online_neural_cdes_tpu.ops import cdeint as jax_cdeint_mod
from online_neural_cdes_tpu.ops import fill as jax_fill
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import kernels as jax_kernels
from online_neural_cdes_tpu.ops import solvers as jax_solvers
from online_neural_cdes_tpu_torch.data.loader import pad_ragged
from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
from online_neural_cdes_tpu_torch.ops import cdeint as torch_cdeint_mod
from online_neural_cdes_tpu_torch.ops import fill, interpolation, kernels, solvers
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree, params_from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _series(seed, shape=(3, 9, 4)):
    """A NaN-holding batch: interior gaps, a leading gap, an all-NaN
    channel of one series, and a fully observed time channel 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    x[..., 0] = np.arange(shape[-2])
    x[0, 2:4, 1] = np.nan          # interior gap
    x[1, :3, 2] = np.nan           # leading gap
    x[2, :, 3] = np.nan            # all-NaN channel
    x[0, -2:, 3] = np.nan          # trailing gap
    x[1, 5, 1:] = np.nan           # whole observation missing
    return x


# ---------------------------------------------------------------- fill


@pytest.mark.parametrize("name", ["forward_fill", "backward_fill", "linear_fill"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_fill_matches_jax(name, axis):
    x = _series(0)
    got = getattr(fill, name)(torch.from_numpy(x), axis=axis)
    want = getattr(jax_fill, name)(jnp.asarray(x), axis=axis)
    close(got, want)
    if name == "forward_fill" and axis == -2:
        # Leading NaNs stay NaN; an all-NaN series stays NaN.
        assert np.isnan(got[1, :3, 2].numpy()).all()


def test_linear_fill_with_times_and_all_nan_is_zero():
    x = _series(1)
    t = np.cumsum(np.random.default_rng(1).uniform(0.5, 2.0, size=x.shape[-2]))
    got = fill.linear_fill(torch.from_numpy(x), t=torch.from_numpy(t))
    close(got, jax_fill.linear_fill(jnp.asarray(x), t=jnp.asarray(t)))
    assert (got[2, :, 3] == 0).all()


# ------------------------------------------------------- interpolation


@pytest.mark.parametrize("kw", [
    {},
    {"rectilinear": 0},
    {"rectilinear": 2},
    {"initial_value_if_nan": -1.5},
    {"forward_fill": True},
    {"rectilinear": 0, "initial_value_if_nan": 0.0},
])
def test_linear_interpolation_coeffs_match_jax(kw):
    x = _series(2)
    got = interpolation.linear_interpolation_coeffs(torch.from_numpy(x), **kw)
    want = jax_interp.linear_interpolation_coeffs(jnp.asarray(x), **kw)
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_linear_interpolation_coeffs_explicit_times():
    x = _series(3)
    t = np.cumsum(np.random.default_rng(3).uniform(0.5, 2.0, size=x.shape[-2]))
    got = interpolation.linear_interpolation_coeffs(torch.from_numpy(x),
                                                    t=torch.from_numpy(t))
    close(got, jax_interp.linear_interpolation_coeffs(jnp.asarray(x),
                                                      t=jnp.asarray(t)))


def test_prepare_rectilinear_matches_jax():
    x = _series(4)
    got = interpolation.prepare_rectilinear_interpolation(torch.from_numpy(x), 0)
    want = jax_interp.prepare_rectilinear_interpolation(jnp.asarray(x), 0)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    close(torch.nan_to_num(got, nan=7.0), jnp.nan_to_num(want, nan=7.0))


@pytest.mark.parametrize("explicit_t", [False, True])
def test_linear_interpolation_spline_matches_jax(explicit_t):
    x = _series(5)
    coeffs_np = np.asarray(jax_interp.linear_interpolation_coeffs(jnp.asarray(x)))
    t_np = (np.cumsum(np.random.default_rng(5).uniform(0.5, 2.0, size=x.shape[-2]))
            if explicit_t else None)
    ours = interpolation.LinearInterpolation.create(torch.tensor(coeffs_np), t=t_np)
    theirs = jax_interp.LinearInterpolation.create(jnp.asarray(coeffs_np), t=t_np)
    close(ours.grid_points, theirs.grid_points)
    close(ours.interval, theirs.interval)
    assert ours.host_grid() == tuple(np.asarray(theirs.grid_points).tolist())
    times = np.array([-0.5, 0.0, 0.3, 2.0, 4.7, 7.99, 30.0])
    for t in [times, 1.25]:
        close(ours.evaluate(torch.as_tensor(t)), theirs.evaluate(jnp.asarray(t)))
        close(ours.derivative(torch.as_tensor(t)), theirs.derivative(jnp.asarray(t)))
    ours_p, theirs_p = ours.piece_data(), theirs.piece_data()
    for key in ("x0", "dxdt"):
        close(ours_p[key], theirs_p[key])
    assert ours_p["dxdt"][2].is_contiguous()  # the kernel's dX rows
    piece = {k: v[3] for k, v in ours_p.items()}
    close(ours.piece_evaluate(piece, 0.25),
          theirs.piece_evaluate({k: v[3] for k, v in theirs_p.items()}, 0.25))


# ----------------------------------------------------------- solvers


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_fixed_steppers_match_jax(method):
    rng = np.random.default_rng(6)
    m = rng.normal(size=(5, 5))
    y0 = rng.normal(size=(3, 5))

    def f_torch(t, y):
        return torch.tanh(y @ torch.from_numpy(m)) * (1.0 + t)

    def f_jax(t, y):
        return jnp.tanh(y @ jnp.asarray(m)) * (1.0 + t)

    got = solvers.tree_fixed_step(method)(f_torch, 0.5, 0.3, torch.from_numpy(y0))
    want = jax_solvers.tree_fixed_step(method)(f_jax, 0.5, 0.3, jnp.asarray(y0))
    close(got, want)
    assert solvers.FIXED_NFE_PER_STEP == jax_solvers.FIXED_NFE_PER_STEP
    assert solvers.FIXED_METHODS == jax_solvers.FIXED_METHODS


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_tuple_steppers_match_jax(method):
    """The adjoint's augmented-state form: a tuple state whose field reads
    only its first two leaves (``live=2``) and returns None for a zero
    derivative, against the JAX tree stepper on the same pytree."""
    rng = np.random.default_rng(16)
    m = rng.normal(size=(4, 4))
    ys = [rng.normal(size=(3, 4)), rng.normal(size=(3, 4)), rng.normal(size=(2,)),
          rng.normal(size=(5,))]

    def f_torch(t, y):
        z, a = y
        return (torch.tanh(z @ torch.from_numpy(m)) * (1.0 + t), a * z,
                z.sum(0)[:2] * t, None)

    def f_jax(t, y):
        z, a, _, _ = y
        return (jnp.tanh(z @ jnp.asarray(m)) * (1.0 + t), a * z,
                z.sum(0)[:2] * t, jnp.zeros(5))

    got = solvers.tree_fixed_step(method, live=2)(
        f_torch, 0.5, 0.3, tuple(torch.from_numpy(y) for y in ys))
    want = jax_solvers.tree_fixed_step(method)(
        f_jax, 0.5, 0.3, tuple(jnp.asarray(y) for y in ys))
    assert len(got) == 4
    for g, w in zip(got, want):
        close(g, w)


def test_fixed_step_casts_dt_to_state_dtype():
    y = torch.ones(2, dtype=torch.float32)
    out = solvers.tree_fixed_step("euler")(lambda t, y: y, 0.0, 0.1, y)
    assert out.dtype == torch.float32
    close(out, np.float32(1.0) + np.float32(0.1), rtol=0, atol=0)


# ------------------------------------------------------- fused field


def _field(seed, c, h, hh, n_layers, dtype=jnp.float64):
    jf = JaxVectorField(input_dim=c, hidden_dim=h, hidden_hidden_dim=hh,
                        num_layers=n_layers, kind="original")
    jparams = jax.tree.map(lambda a: a.astype(dtype), jf.init(jax.random.PRNGKey(seed)))
    tf = VectorField(c, h, hh, n_layers, generator=torch.Generator().manual_seed(seed),
                     dtype=torch.float64 if dtype == jnp.float64 else torch.float32,
                     device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tf)
    return jf, jparams, tf


def test_vector_field_matches_jax():
    jf, jparams, tf = _field(0, 4, 6, 7, 2)
    z = np.random.default_rng(0).normal(size=(5, 6))
    close(tf(0.0, torch.from_numpy(z)), jf.apply(jparams, 0.0, jnp.asarray(z)))


def test_pack_fused_params_matches_unpadded_jax_packing():
    jf, jparams, tf = _field(1, 3, 5, 6, 2)
    ours = kernels.pack_fused_params(tf.params, 5, 3)
    theirs = jax_kernels.pack_fused_params(jparams, 5, 3, pad=False)
    close(ours["head_w"], theirs["head_w"], rtol=0, atol=0)
    close(ours["head_b"], theirs["head_b"], rtol=0, atol=0)
    assert ours["head_w"].is_contiguous() and ours["head_b"].is_contiguous()


@pytest.mark.parametrize("n_trunk", [1, 3])
@pytest.mark.parametrize("time_slice", [False, True])
def test_fused_field_plain_matches_jax_reference(n_trunk, time_slice):
    """At I = C and at the rectilinear I = 1 time-channel slice."""
    B, C, H, HH = 6, 4, 8, 10
    jf, jparams, tf = _field(2 + n_trunk, C, H, HH, n_trunk)
    rng = np.random.default_rng(n_trunk)
    z = rng.normal(size=(B, H))
    dx = rng.normal(size=(B, C))
    ours = kernels.pack_fused_params(tf.params, H, C)
    theirs = jax_kernels.pack_fused_params(jparams, H, C, pad=False)
    if time_slice:
        k, I = 2, 1
        ours = dict(ours, head_w=ours["head_w"][:, k * H:(k + 1) * H].contiguous(),
                    head_b=ours["head_b"][k * H:(k + 1) * H].contiguous())
        theirs = dict(theirs, head_w=theirs["head_w"][:, k * H:(k + 1) * H],
                      head_b=theirs["head_b"][k * H:(k + 1) * H])
        dx = dx[:, k:k + 1]
    else:
        I = C
    got = kernels.fused_matmul_field(ours["trunk"], ours["head_w"], ours["head_b"],
                                     torch.from_numpy(z), torch.from_numpy(dx), H, I)
    want = jax_kernels._forward_reference(
        theirs["trunk"], theirs["head_w"], theirs["head_b"], jnp.asarray(z),
        jnp.asarray(dx), H, I)
    assert got.dtype == torch.float64
    close(got, want)


@pytest.mark.parametrize("B,H", [(8, 8), (5, 12)])
def test_fused_field_plain_matches_pallas_kernel_interpret(B, H):
    """The TPU kernel itself, run in Pallas interpret mode with its
    lane-padded packing, against the port's unpadded plain version; the
    padded hidden columns are sliced off at (B, H).  In float32 at f32
    round-off (rtol=1e-5, atol=1e-6): the interpreted kernel's dot does not
    keep float64 precision (it differs from the JAX reference by ~1e-8
    there)."""
    from jax.experimental.pallas import tpu as pltpu

    C, HH = 3, 16
    jf, jparams, tf = _field(7, C, H, HH, 2, dtype=jnp.float32)
    rng = np.random.default_rng(B)
    z = rng.normal(size=(B, H)).astype(np.float32)
    dx = rng.normal(size=(B, C)).astype(np.float32)
    padded = jax_kernels.pack_fused_params(jparams, H, C, pad=True)
    assert padded["head_w"].shape[1] == C * 128
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernels._forward_pallas(
            padded["trunk"], padded["head_w"], padded["head_b"],
            jnp.asarray(z), jnp.asarray(dx), H, C)
    ours = kernels.pack_fused_params(tf.params, H, C)
    got = kernels.fused_matmul_field(ours["trunk"], ours["head_w"], ours["head_b"],
                                     torch.from_numpy(z), torch.from_numpy(dx), H, C)
    assert want.shape == (B, H)
    close(got, want, rtol=1e-5, atol=1e-6)


def _packed_pair(tf, jparams, H, C, time_slice, k=2):
    """The port's and JAX's unpadded packings; with ``time_slice`` the
    rectilinear I = 1 head slice of channel k (contiguous on the port)."""
    ours = kernels.pack_fused_params(tf.params, H, C)
    theirs = jax_kernels.pack_fused_params(jparams, H, C, pad=False)
    if time_slice:
        ours = dict(ours, head_w=ours["head_w"][:, k * H:(k + 1) * H].contiguous(),
                    head_b=ours["head_b"][k * H:(k + 1) * H].contiguous())
        theirs = dict(theirs, head_w=theirs["head_w"][:, k * H:(k + 1) * H],
                      head_b=theirs["head_b"][k * H:(k + 1) * H])
    return ours, theirs


def _close_backward(got, want, rtol=RTOL, atol=ATOL):
    """Port (dtrunk, dhw, dhb, dz, ddx) against JAX's, group by group."""
    dtrunk, dhw, dhb, dz, ddx = got
    w_trunk, w_hw, w_hb, w_z, w_dx = want
    for g, w in [(dz, w_z), (ddx, w_dx), (dhw, w_hw), (dhb, w_hb)]:
        close(g, w, rtol, atol)
    assert len(dtrunk) == len(w_trunk)
    for g, w in zip(dtrunk, w_trunk):
        close(g["w"], w["w"], rtol, atol)
        close(g["b"], w["b"], rtol, atol)


@pytest.mark.parametrize("n_trunk", [1, 3])
@pytest.mark.parametrize("time_slice", [False, True])
def test_fused_field_backward_plain_matches_jax_vjp(n_trunk, time_slice):
    """The plain backward against jax.vjp of the JAX ``_forward_reference``
    (the JAX package's default VJP route), at I = C and at the I = 1 time
    slice, in float64."""
    B, C, H, HH = 6, 4, 8, 10
    jf, jparams, tf = _field(20 + n_trunk, C, H, HH, n_trunk)
    ours, theirs = _packed_pair(tf, jparams, H, C, time_slice)
    I = 1 if time_slice else C
    rng = np.random.default_rng(30 + n_trunk)
    z, g = rng.normal(size=(B, H)), rng.normal(size=(B, H))
    dx = rng.normal(size=(B, I))

    def ref(trunk, head_w, head_b, z_, dx_):
        return jax_kernels._forward_reference(trunk, head_w, head_b, z_, dx_, H, I)

    _, vjp = jax.vjp(ref, theirs["trunk"], theirs["head_w"], theirs["head_b"],
                     jnp.asarray(z), jnp.asarray(dx))
    want = vjp(jnp.asarray(g))
    got = kernels._backward(ours["trunk"], ours["head_w"], ours["head_b"],
                            torch.from_numpy(z), torch.from_numpy(dx),
                            torch.from_numpy(g), H, I)
    assert got[3].dtype == torch.float64
    _close_backward(got, want)


@pytest.mark.parametrize("B,H", [(8, 8), (5, 12)])
def test_fused_field_backward_plain_matches_pallas_kernel_interpret(B, H):
    """The TPU backward kernel itself, ``_backward_pallas`` in Pallas
    interpret mode with the unpadded packing, against the port's plain
    backward.  Float32 at rtol=1e-5, atol=2e-5: interpret mode does not
    keep float64 (ROADMAP C)."""
    from jax.experimental.pallas import tpu as pltpu

    C, HH = 3, 16
    jf, jparams, tf = _field(40 + B, C, H, HH, 2, dtype=jnp.float32)
    ours, theirs = _packed_pair(tf, jparams, H, C, time_slice=False)
    rng = np.random.default_rng(B)
    z, dx, g = (rng.normal(size=s).astype(np.float32) for s in [(B, H), (B, C), (B, H)])
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernels._backward_pallas(
            theirs["trunk"], theirs["head_w"], theirs["head_b"], jnp.asarray(z),
            jnp.asarray(dx), jnp.asarray(g), H, C, "float32")
    got = kernels._backward(ours["trunk"], ours["head_w"], ours["head_b"],
                            torch.from_numpy(z), torch.from_numpy(dx),
                            torch.from_numpy(g), H, C)
    _close_backward(got, want, rtol=1e-5, atol=2e-5)


def test_fused_field_autograd_matches_plain_backward():
    """fused_matmul_field under autograd routes its gradient through the
    backward's plain version on CPU tensors, leading dims included."""
    jf, jparams, tf = _field(3, 3, 4, 5, 2)
    p = kernels.pack_fused_params(tf.params, 4, 3)
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(2, 3, 4))).requires_grad_()
    dx = torch.from_numpy(rng.normal(size=(2, 3, 3)))
    g = torch.from_numpy(rng.normal(size=(2, 3, 4)))
    out = kernels.fused_matmul_field(p["trunk"], p["head_w"], p["head_b"], z, dx, 4, 3)
    leaves = [z, p["head_w"]] + [layer["w"] for layer in p["trunk"]]
    grads = torch.autograd.grad(out, leaves, g)
    dtrunk, dhw, _, dz, _ = kernels._backward_reference(
        p["trunk"], p["head_w"], p["head_b"], z.reshape(6, 4), dx.reshape(6, 3),
        g.reshape(6, 4), 4, 3)
    close(grads[0], dz.reshape(2, 3, 4))
    close(grads[1], dhw)
    for got, layer in zip(grads[2:], dtrunk):
        close(got, layer["w"])


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper's checks (run here on CPU tensors; on the card the same
    checks guard the launch)."""
    jf, jparams, tf = _field(5, 3, 4, 5, 2, dtype=jnp.float32)
    p = kernels.pack_fused_params(tf.params, 4, 3)
    z, dx = torch.randn(2, 4), torch.randn(2, 3)
    args = (p["trunk"], p["head_w"], p["head_b"])
    with pytest.raises(TypeError, match="float32"):
        kernels._forward_kernel(*args, z.double(), dx, 4, 3)
    with pytest.raises(ValueError, match="not contiguous"):
        kernels._forward_kernel(*args, torch.randn(4, 2).T, dx, 4, 3)
    with pytest.raises(ValueError, match="shape"):
        kernels._forward_kernel(*args, z, torch.randn(2, 2), 4, 3)
    with pytest.raises(ValueError, match="trunk layers"):
        kernels._forward_kernel(p["trunk"] * 3, p["head_w"], p["head_b"], z, dx, 4, 3)


def test_backward_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The wrapper's own checks.  Widths the kernel's tiles cannot hold
    (H or HH above the library's limit) are refused by the library, so
    that case is held on the card, in ``chip_smoke.py``."""
    jf, jparams, tf = _field(5, 3, 4, 5, 2, dtype=jnp.float32)
    p = kernels.pack_fused_params(tf.params, 4, 3)
    z, dx, g = torch.randn(2, 4), torch.randn(2, 3), torch.randn(2, 4)
    args = (p["trunk"], p["head_w"], p["head_b"])
    with pytest.raises(TypeError, match="float32"):
        kernels._backward_kernel(*args, z, dx, g.double(), 4, 3)
    with pytest.raises(ValueError, match="g has shape"):
        kernels._backward_kernel(*args, z, dx, torch.randn(3, 4), 4, 3)
    with pytest.raises(ValueError, match="not contiguous"):
        kernels._backward_kernel(*args, z, dx, torch.randn(4, 2).T, 4, 3)
    with pytest.raises(ValueError, match="trunk layers"):
        kernels._backward_kernel(p["trunk"] * 3, p["head_w"], p["head_b"], z, dx, g, 4, 3)


def test_fused_field_kernel_launch_counter_untouched_on_cpu():
    before = (kernels.fused_field_kernel.launches, kernels.fused_field_bwd_kernel.launches)
    jf, jparams, tf = _field(4, 3, 4, 5, 1, dtype=jnp.float32)
    packed = kernels.pack_fused_params(tf.params, 4, 3)
    z = torch.randn(2, 4, requires_grad=True)
    out = kernels.fused_matmul_field(packed["trunk"], packed["head_w"], packed["head_b"],
                                     z, torch.randn(2, 3), 4, 3)
    out.sum().backward()
    assert z.grad is not None
    assert (kernels.fused_field_kernel.launches,
            kernels.fused_field_bwd_kernel.launches) == before


# ------------------------------------------------------------ cdeint


def _cdeint_case(seed, rectilinear):
    B, L, C, H, HH = 3, 6, 3, 5, 7
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C))
    x[..., 0] = np.arange(L)
    x[1, 3, 1] = np.nan
    kw = {"rectilinear": 0} if rectilinear else {}
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x), **kw))
    jf, jparams, tf = _field(seed, C, H, HH, 2)
    z0 = rng.normal(size=(B, H))
    return coeffs, z0, jf, jparams, tf, H, C


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("full_grid", [False, True])
def test_cdeint_fixed_scan_matches_jax(method, paired, full_grid):
    """The plain scan and the paired rectilinear scan (time-channel slice
    on even intervals) of the port's fused field against the JAX cdeint,
    with return_stats: the plain scan against JAX's unfused 'matmul'
    field, the paired one against its fused field."""
    coeffs, z0, jf, jparams, tf, H, C = _cdeint_case(8, rectilinear=paired)
    jspline = jax_interp.LinearInterpolation.create(jnp.asarray(coeffs))
    tspline = interpolation.LinearInterpolation.create(torch.from_numpy(coeffs))
    jt = jspline.grid_points if full_grid else jspline.interval
    tt = tspline.grid_points if full_grid else tspline.interval
    common = dict(method=method, return_stats=True, options={"substeps": 2})
    tp = kernels.pack_fused_params(tf.params, H, C)

    def tfunc(t, z, dx, p):
        return kernels.fused_matmul_field(p["trunk"], p["head_w"], p["head_b"],
                                          z, dx, H, C)

    if paired:
        jp = jax_kernels.pack_fused_params(jparams, H, C, pad=False)

        def jfunc(t, z, dx, p):
            return jax_kernels.fused_matmul_field(
                p["trunk"], p["head_w"], p["head_b"], z, dx, H, C, False)

        def jeven(t, z, dx, p):
            return jax_kernels.fused_matmul_field(
                p["trunk"], p["head_w"][:, :H], p["head_b"][:H], z, dx[..., :1],
                H, 1, False)

        def teven(t, z, dx, p):
            return kernels.fused_matmul_field(
                p["trunk"], p["head_w"][:, :H].contiguous(),
                p["head_b"][:H].contiguous(), z, dx[..., :1].contiguous(), H, 1)

        want, wstats = jax_cdeint_mod.cdeint(
            jspline, jfunc, jnp.asarray(z0), jt, jp, adjoint=False,
            vector_field_type="matmul_fused", even_func=jeven, **common)
        got, gstats = torch_cdeint_mod.cdeint(
            tspline, tfunc, torch.from_numpy(z0), tt, tp,
            vector_field_type="matmul_fused", even_func=teven, **common)
    else:
        want, wstats = jax_cdeint_mod.cdeint(
            jspline, lambda t, z, p: jf.apply(p, t, z), jnp.asarray(z0), jt,
            jparams, adjoint=False, **common)
        got, gstats = torch_cdeint_mod.cdeint(
            tspline, tfunc, torch.from_numpy(z0), tt, tp, **common)
    assert tuple(got.shape) == want.shape
    close(got, want)
    for key in ("nfe", "accepted", "rejected"):
        assert int(gstats[key]) == int(wstats[key])


def test_cdeint_paired_scan_is_used_for_rectilinear_controls(monkeypatch):
    coeffs, z0, jf, jparams, tf, H, C = _cdeint_case(9, rectilinear=True)
    calls = []
    orig = torch_cdeint_mod._fixed_scan_forward_paired
    monkeypatch.setattr(torch_cdeint_mod, "_fixed_scan_forward_paired",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    tp = kernels.pack_fused_params(tf.params, H, C)
    spline = interpolation.LinearInterpolation.create(torch.from_numpy(coeffs))

    def func(t, z, dx, p):
        return kernels.fused_matmul_field(p["trunk"], p["head_w"], p["head_b"],
                                          z, dx, H, C)

    torch_cdeint_mod.cdeint(spline, func, torch.from_numpy(z0), spline.grid_points,
                            tp, vector_field_type="matmul_fused", even_func=func)
    assert calls == [1]


def test_cdeint_refuses_unported_branches():
    """No branch is refused any more: an Adams method takes the generic
    path and matches JAX's; output times [0, 2] inside the knot grid take
    the generic path, as in JAX; the unfused matmul field takes the piece
    scan."""
    coeffs, z0, jf, jparams, tf, H, C = _cdeint_case(10, rectilinear=False)
    spline = interpolation.LinearInterpolation.create(torch.from_numpy(coeffs))
    close(torch_cdeint_mod.cdeint(spline, lambda t, z, p: tf(t, z),
                                  torch.from_numpy(z0), spline.interval,
                                  vector_field_type="matmul", method="explicit_adams",
                                  options={"substeps": 5}),
          jax_cdeint_mod.cdeint(jax_interp.LinearInterpolation.create(jnp.asarray(coeffs)),
                                lambda t, z, p: jf.apply(jparams, t, z), jnp.asarray(z0),
                                jnp.asarray([0.0, 5.0]), vector_field_type="matmul",
                                method="explicit_adams", options={"substeps": 5}))
    tp = kernels.pack_fused_params(tf.params, H, C)
    got, gstats = torch_cdeint_mod.cdeint(
        spline, lambda t, z, dx, p: kernels.fused_matmul_field(
            p["trunk"], p["head_w"], p["head_b"], z, dx, H, C),
        torch.from_numpy(z0), torch.tensor([0.0, 2.0], dtype=torch.float64), tp,
        options={"substeps": 2}, return_stats=True)
    want, wstats = jax_cdeint_mod.cdeint(
        jax_interp.LinearInterpolation.create(jnp.asarray(coeffs)),
        lambda t, z, p: jf.apply(p, t, z), jnp.asarray(z0), jnp.asarray([0.0, 2.0]),
        jparams, options={"substeps": 2}, return_stats=True)
    close(got, want)
    for key in ("nfe", "accepted", "rejected"):
        assert int(gstats[key]) == int(wstats[key])
    # The unfused matmul field (the (..., H, I) matrix contracted by cdeint)
    # on the piece scan, against JAX's.
    close(torch_cdeint_mod.cdeint(spline, lambda t, z, p: tf(t, z),
                                  torch.from_numpy(z0), spline.interval,
                                  vector_field_type="matmul"),
          jax_cdeint_mod.cdeint(jax_interp.LinearInterpolation.create(jnp.asarray(coeffs)),
                                lambda t, z, p: jf.apply(jparams, t, z), jnp.asarray(z0),
                                jnp.asarray([0.0, 5.0]), vector_field_type="matmul"))


# ------------------------------------------------------ loader, convert


@pytest.mark.parametrize("forward_fill", [True, False])
def test_pad_ragged_matches_jax(forward_fill):
    rng = np.random.default_rng(11)
    series = [rng.normal(size=(n, 3)).astype(np.float32) for n in (4, 9, 1)]
    got = pad_ragged(series, bucket_multiple=8, forward_fill=forward_fill)
    want = jax_pad_ragged(series, bucket_multiple=8, forward_fill=forward_fill)
    np.testing.assert_array_equal(got, want)


def test_params_from_jax_checks_names_and_shapes():
    jf, jparams, tf = _field(12, 3, 4, 5, 2)
    flat = flatten_tree(jax.tree.map(np.asarray, jparams))
    assert set(flat) == set(tf.state_dict())
    bad = jax.tree.map(np.asarray, jparams)
    bad["out"]["w"] = bad["out"]["w"][:, :-1]
    with pytest.raises(ValueError, match="out.w"):
        params_from_jax(bad, tf)
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({"trunk": bad["trunk"]}, tf)
