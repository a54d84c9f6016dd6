"""Parity of the PyTorch port's training slice against the JAX package, on
the CPU: the interval adjoint and direct backprop through ``cdeint``,
``NeuralCDE`` gradients, the NaN-masked losses, the Adam train and epoch
steps, the toy data and the toy training curve.

Weights are made by the JAX ``init`` and carried across with
``params_from_jax``; inputs come from numpy with a fixed seed.  Gradients
and losses are compared in float64 at rtol=1e-9 (the same formulas, only
summation order differs); parameters after Adam steps at rtol=1e-8, since
Adam's division by the root of the second moment amplifies round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.models.vector_fields import VectorField as JaxVectorField
from online_neural_cdes_tpu.ops import cdeint as jax_cdeint_mod
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import kernels as jax_kernels
from online_neural_cdes_tpu.training import loop as jax_loop
from online_neural_cdes_tpu.training import metrics as jax_metrics
from online_neural_cdes_tpu_torch import NeuralCDE, params_from_jax
from online_neural_cdes_tpu_torch.data.toy import brownian_motion_data
from online_neural_cdes_tpu_torch.experiments import sim_bm_toy
from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
from online_neural_cdes_tpu_torch.ops import cdeint as torch_cdeint_mod
from online_neural_cdes_tpu_torch.ops import interpolation, kernels
from online_neural_cdes_tpu_torch.training import loop, metrics
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
B, L, C, H, HH, S = 4, 4, 3, 4, 5, 2


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


# ------------------------------------------------------------ cdeint


def _field(seed):
    jf = JaxVectorField(input_dim=C, hidden_dim=H, hidden_hidden_dim=HH,
                        num_layers=2, kind="original")
    jparams = jax.tree.map(lambda a: a.astype(jnp.float64),
                           jf.init(jax.random.PRNGKey(seed)))
    tf = VectorField(C, H, HH, 2, generator=torch.Generator().manual_seed(seed),
                     dtype=torch.float64, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tf)
    return jparams, tf


def _cdeint_case(seed, rectilinear):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C))
    x[..., 0] = np.arange(L)
    x[1, 2, 1] = np.nan
    kw = {"rectilinear": 0} if rectilinear else {}
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x), **kw))
    jparams, tf = _field(seed)
    return coeffs, rng.normal(size=(B, H)), jparams, tf


def _jax_cdeint_grads(coeffs, z0, jparams, paired, **kw):
    jp = jax_kernels.pack_fused_params(jparams, H, C, pad=False)

    def jfunc(t, z, dx, p):
        return jax_kernels.fused_matmul_field(p["trunk"], p["head_w"], p["head_b"],
                                              z, dx, H, C, False)

    def jeven(t, z, dx, p):
        return jax_kernels.fused_matmul_field(p["trunk"], p["head_w"][:, :H],
                                              p["head_b"][:H], z, dx[..., :1], H, 1,
                                              False)

    def loss(z0_, p, coeffs_):
        X = jax_interp.LinearInterpolation.create(coeffs_)
        zs = jax_cdeint_mod.cdeint(X, jfunc, z0_, X.grid_points, p,
                                   vector_field_type="matmul_fused",
                                   even_func=jeven if paired else None, **kw)
        return jnp.sum(zs ** 2) + jnp.sum(zs[..., -1, :])

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(z0), jp, jnp.asarray(coeffs))


def _torch_cdeint_grads(coeffs, z0, tf, paired, **kw):
    packed = kernels.pack_fused_params(tf.params, H, C)
    leaves = {"trunk": [{k: v.detach().clone().requires_grad_() for k, v in layer.items()}
                        for layer in packed["trunk"]],
              "head_w": packed["head_w"].detach().clone().requires_grad_(),
              "head_b": packed["head_b"].detach().clone().requires_grad_()}
    z0 = torch.from_numpy(z0).requires_grad_()
    coeffs = torch.from_numpy(coeffs).requires_grad_()

    def func(t, z, dx, p):
        return kernels.fused_matmul_field(p["trunk"], p["head_w"], p["head_b"], z, dx,
                                          H, C)

    def even(t, z, dx, p):
        return kernels.fused_matmul_field(
            p["trunk"], p["head_w"][:, :H].contiguous(), p["head_b"][:H].contiguous(),
            z, dx[..., :1].contiguous(), H, 1)

    X = interpolation.LinearInterpolation.create(coeffs)
    zs = torch_cdeint_mod.cdeint(X, func, z0, X.grid_points, leaves,
                                 vector_field_type="matmul_fused",
                                 even_func=even if paired else None, **kw)
    loss = torch.sum(zs ** 2) + torch.sum(zs[..., -1, :])
    flat = [leaves["head_w"], leaves["head_b"]] + [t for layer in leaves["trunk"]
                                                  for t in (layer["w"], layer["b"])]
    return torch.autograd.grad(loss, [z0, coeffs, *flat])


def _close_cdeint_grads(got, want, rtol=RTOL, atol=ATOL):
    dz0, dcoeffs, dhw, dhb, *dtrunk = got
    w_z0, w_p, w_coeffs = want
    close(dz0, w_z0, rtol, atol, "z0")
    close(dcoeffs, w_coeffs, rtol, atol, "coeffs")
    close(dhw, w_p["head_w"], rtol, atol, "head_w")
    close(dhb, w_p["head_b"], rtol, atol, "head_b")
    w_trunk = [t for layer in w_p["trunk"] for t in (layer["w"], layer["b"])]
    for i, (g, w) in enumerate(zip(dtrunk, w_trunk)):
        close(g, w, rtol, atol, f"trunk leaf {i}")
    assert float(dcoeffs.abs().max()) > 0


CDEINT_CASES = {
    **{f"adjoint_{m}_{'paired' if p else 'plain'}": (p, dict(adjoint=True, method=m))
       for m in ("euler", "midpoint", "rk4") for p in (False, True)},
    "adjoint_options_midpoint": (True, dict(adjoint=True, method="rk4",
                                            adjoint_options={"method": "midpoint"})),
    "adjoint_options_substeps": (False, dict(adjoint=True, method="rk4",
                                             adjoint_options={"substeps": 2})),
    "direct": (True, dict(adjoint=False, method="rk4")),
    "direct_remat": (True, dict(adjoint=False, method="rk4",
                                options={"remat": True})),
}


@pytest.mark.parametrize("case", sorted(CDEINT_CASES))
def test_cdeint_gradients_match_jax(case):
    """Gradients of a loss of every knot state with respect to z0, the
    coefficients and the packed field parameters: the interval adjoint
    (plain and paired rectilinear scan, each fixed method, the
    adjoint_options overrides) and direct backprop (with and without
    remat), against the JAX cdeint."""
    paired, kw = CDEINT_CASES[case]
    coeffs, z0, jparams, tf = _cdeint_case(len(case), rectilinear=paired)
    want = _jax_cdeint_grads(coeffs, z0, jparams, paired, **kw)
    got = _torch_cdeint_grads(coeffs, z0, tf, paired, **kw)
    _close_cdeint_grads(got, want)


def test_adjoint_matches_direct_backprop_at_fine_steps():
    """The port's own adjoint against its direct backprop at substeps=16
    (JAX ``tests/test_cdeint.py``'s oracle): the adjoint's extra
    discretisation error is O(h^4)."""
    coeffs, z0, _, tf = _cdeint_case(1, rectilinear=False)
    opts = {"options": {"substeps": 16}, "method": "rk4"}
    direct = _torch_cdeint_grads(coeffs, z0, tf, False, adjoint=False, **opts)
    adjoint = _torch_cdeint_grads(coeffs, z0, tf, False, adjoint=True, **opts)
    for a, d in zip(adjoint, direct):
        close(a, d, rtol=2e-4, atol=1e-6)


def _spy_adjoint(monkeypatch):
    calls = []
    orig = torch_cdeint_mod._FixedCDEAdjointPaired.apply
    monkeypatch.setattr(torch_cdeint_mod._FixedCDEAdjointPaired, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    return calls


def test_adjoint_function_only_when_a_gradient_is_needed(monkeypatch):
    calls = _spy_adjoint(monkeypatch)
    tm = NeuralCDE(input_dim=C, hidden_dim=H, output_dim=1, hidden_hidden_dim=HH,
                   num_layers=2, interpolation="rectilinear", return_sequences=True,
                   device="cpu", dtype=torch.float64)
    coeffs = torch.from_numpy(_cdeint_case(2, rectilinear=True)[0])
    with torch.inference_mode():
        tm(coeffs)
    with torch.no_grad():
        tm(coeffs)
    assert calls == []
    tm(coeffs).sum().backward()
    assert calls == [1]
    assert all(p.grad is not None for p in tm.parameters())


# ------------------------------------------------------- NeuralCDE


def _model_pair(seed, **kw):
    kw = dict(dict(input_dim=C, hidden_dim=H, output_dim=2, hidden_hidden_dim=HH,
                   num_layers=2, solver="rk4"), **kw)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float64), jm.init(jax.random.PRNGKey(seed)))
    tm = NeuralCDE(**kw, device="cpu", dtype=torch.float64)
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    return jm, jparams, tm


def _series(seed, nan=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C))
    x[..., 0] = np.arange(L)
    if nan:
        x[0, 2, 1] = np.nan
        x[3, 1, 2] = np.nan
    return x, rng.normal(size=(B, S))


def _close_param_grads(tm, jgrads, rtol=RTOL, atol=ATOL):
    want = flatten_tree(jax.tree.map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        close(got[name].grad, w, rtol, atol, name)


@pytest.mark.parametrize("case", ["rect_seq_static", "linear_final"])
def test_neural_cde_parameter_gradients_match_jax(case):
    kw = (dict(interpolation="rectilinear", return_sequences=True, static_dim=S)
          if case == "rect_seq_static" else
          dict(interpolation="linear", return_sequences=False))
    jm, jparams, tm = _model_pair(3, **kw)
    x, static = _series(3)
    rect = kw["interpolation"] == "rectilinear"
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(
        jnp.asarray(x), **({"rectilinear": 0} if rect else {})))
    jin = (jnp.asarray(static), jnp.asarray(coeffs)) if rect else jnp.asarray(coeffs)
    tin = ((torch.from_numpy(static), torch.from_numpy(coeffs)) if rect
           else torch.from_numpy(coeffs))

    def jloss(p):
        return jnp.sum(jm.apply(p, jin) ** 2)

    jgrads = jax.jit(jax.grad(jloss))(jparams)
    torch.sum(tm(tin) ** 2).backward()
    _close_param_grads(tm, jgrads)


def test_neural_cde_source_gradients_through_rectilinear_coefficients():
    """Gradients with respect to the raw series x through the rectilinear
    construction (JAX ``tests/test_kernels.py:144``): the paired scan's
    dropped even-interval terms cancel there, so they match JAX."""
    jm, jparams, tm = _model_pair(4, interpolation="rectilinear", return_sequences=True)
    x, _ = _series(4, nan=False)

    def jloss(p, x_):
        c = jax_interp.linear_interpolation_coeffs(x_, rectilinear=0)
        return jnp.sum(jm.apply(p, c) ** 2)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    coeffs = interpolation.linear_interpolation_coeffs(xt, rectilinear=0)
    torch.sum(tm(coeffs) ** 2).backward()
    close(xt.grad, jgx, err_msg="x")
    _close_param_grads(tm, jgp)


# ---------------------------------------------------------- losses


def _labels(seed, shape, kind="binary"):
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 2, size=shape).astype(np.float64) if kind == "binary"
         else rng.normal(size=shape))
    y[0, -1] = np.nan
    y[2, 1:] = np.nan
    return y


@pytest.mark.parametrize("name", ["bce", "ce", "mse", "rmse"])
def test_masked_losses_match_jax(name):
    rng = np.random.default_rng(5)
    if name == "ce":
        preds = rng.normal(size=(B, L, 3))
        labels = rng.integers(0, 3, size=(B, L)).astype(np.float64)
        labels[1, 2] = np.nan
    else:
        preds = rng.normal(size=(B, L, 1))
        labels = _labels(5, (B, L), "binary" if name == "bce" else "real")
    ours_pw, theirs_pw = metrics.make_loss(name), jax_metrics.make_loss(name)
    tp, tl = torch.from_numpy(preds), torch.from_numpy(labels)
    jp, jl = jnp.asarray(preds), jnp.asarray(labels)
    t, c = metrics.masked_temporal_loss_parts(ours_pw, tp, tl)
    wt, wc = jax_metrics.masked_temporal_loss_parts(theirs_pw, jp, jl)
    close(t, wt)
    assert float(c) == float(wc)
    close(metrics.masked_temporal_loss(ours_pw, tp, tl, sqrt=name == "rmse"),
          jax_metrics.masked_temporal_loss(theirs_pw, jp, jl, sqrt=name == "rmse"))


def test_loss_aligns_trailing_singleton_labels_and_accuracy_matches_jax():
    rng = np.random.default_rng(6)
    preds = rng.normal(size=(B, 1))
    labels = rng.integers(0, 2, size=(B, 1)).astype(np.float64)
    labels[1, 0] = np.nan
    pw = metrics.make_loss("bce")
    got = metrics.masked_temporal_loss(pw, torch.from_numpy(preds), torch.from_numpy(labels))
    want = jax_metrics.masked_temporal_loss(jax_metrics.make_loss("bce"),
                                            jnp.asarray(preds), jnp.asarray(labels))
    close(got, want)
    seq_preds, seq_labels = rng.normal(size=(B, L, 1)), _labels(6, (B, L))
    assert metrics.accuracy(seq_preds, seq_labels) == jax_metrics.accuracy(
        seq_preds, seq_labels)


@pytest.mark.parametrize("name", ["auc", "auprc", "precision", "f1"])
def test_sklearn_metrics_raise_naming_their_roadmap_item(name):
    """The name dates from when these four refused on the port; they are
    ported now, and the test holds each against the JAX package's
    (scikit-learn's) value on tied scores with NaN labels
    (tests/test_torch_port_metrics.py holds them in full)."""
    rng = np.random.default_rng(9)
    preds = np.round(rng.normal(size=(40, 1)), 1)
    labels = rng.integers(0, 2, size=40).astype(np.float64)
    labels[::7] = np.nan
    close(metrics.METRICS[name](preds, labels), jax_metrics.METRICS[name](preds, labels),
          rtol=1e-12)


# ------------------------------------------------------ train steps


def _train_case(seed, loss="bce"):
    jm, jparams, tm = _model_pair(seed, interpolation="rectilinear",
                                  return_sequences=True, static_dim=S, output_dim=1)
    x, static = _series(seed)
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x), rectilinear=0))
    labels = _labels(seed, (B, L), "binary" if loss == "bce" else "real")
    jin, jlab = (jnp.asarray(static), jnp.asarray(coeffs)), jnp.asarray(labels)
    tin = (torch.from_numpy(static), torch.from_numpy(coeffs))
    return jm, jparams, tm, jin, jlab, tin, torch.from_numpy(labels)


def _close_params(tm, jparams, rtol=1e-8, atol=1e-12):
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    for name, p in tm.state_dict().items():
        close(p, want[name], rtol, atol, name)


TRAIN_CASES = {
    "lr_scale": (dict(final_lr_multiplier=10.0), (0.5,)),
    "final_mult": (dict(final_lr_multiplier=None), (1.0, 3.0)),
    "accum_steps": (dict(accum_steps=2), (1.0,)),
    "rmse_accum_steps": (dict(accum_steps=2, loss="rmse"), (0.7,)),
    "optimizer": (dict(optimizer=True), ()),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case):
    """Three Adam steps of the port's ``make_train_step`` against JAX
    ``make_train_step(donate=False)`` on NaN-holding labels: the losses and
    the parameters after each step."""
    kw, extra = TRAIN_CASES[case]
    kw = dict(kw)
    loss = kw.pop("loss", "bce")
    jm, jparams, tm, jin, jlab, tin, tlab = _train_case(7, loss)
    lr = 1e-2
    if kw.pop("optimizer", False):
        jopt = jax_loop.make_optimizer(lr)
        jstep = jax_loop.make_train_step(jm, jopt, loss=loss, donate=False, **kw)
        jstate = jopt.init(jparams)
        tstep = loop.make_train_step(tm, loop.make_optimizer(tm, lr), loss=loss, **kw)
    else:
        jstep = jax_loop.make_train_step(jm, loss=loss, lr=lr, donate=False, **kw)
        jstate = jax_loop.init_adam_state(jparams)
        tstep = loop.make_train_step(tm, loss=loss, lr=lr, **kw)
    for _ in range(3):
        jparams, jstate, want = jstep(jparams, jstate, jin, jlab, *extra)
        got = tstep(tin, tlab, *extra)
        close(got, want, rtol=1e-8)
        _close_params(tm, jparams)


def test_train_step_compute_dtype_matches_jax():
    """compute_dtype=float32 on float64 master weights: the forward runs in
    float32 on both sides (first loss at f32 round-off), and the update
    keeps the master weights' dtype."""
    jm, jparams, tm, jin, jlab, tin, tlab = _train_case(8)
    jstep = jax_loop.make_train_step(jm, loss="bce", lr=1e-2, donate=False,
                                     compute_dtype="float32")
    _, _, want = jstep(jparams, jax_loop.init_adam_state(jparams), jin, jlab, 1.0)
    before = tm.field.out["w"].detach().clone()
    got = loop.make_train_step(tm, loss="bce", lr=1e-2, compute_dtype="float32")(
        tin, tlab, 1.0)
    close(got, want, rtol=1e-5)
    assert tm.field.out["w"].dtype == torch.float64
    assert not torch.equal(tm.field.out["w"], before)


def test_epoch_step_matches_jax():
    jm, jparams, tm, jin, jlab, tin, tlab = _train_case(9)
    steps = 3
    jin_s = jax.tree.map(lambda a: jnp.stack([a] * steps), jin)
    tin_s = tuple(torch.stack([t] * steps) for t in tin)
    jepoch = jax_loop.make_epoch_step(jm, loss="bce", lr=1e-2, donate=False)
    jparams, _, want = jepoch(jparams, jax_loop.init_adam_state(jparams), jin_s,
                              jnp.stack([jlab] * steps), 0.5)
    got = loop.make_epoch_step(tm, loss="bce", lr=1e-2)(
        tin_s, torch.stack([tlab] * steps), 0.5)
    assert got.shape == (steps,)
    close(got, want, rtol=1e-8)
    _close_params(tm, jparams)


def test_cpu_training_step_launches_no_kernel():
    _, _, tm, _, _, tin, tlab = _train_case(10)
    before = (kernels.fused_field_kernel.launches, kernels.fused_field_bwd_kernel.launches)
    loop.make_train_step(tm, loss="bce")(tin, tlab, 1.0)
    assert (kernels.fused_field_kernel.launches,
            kernels.fused_field_bwd_kernel.launches) == before


def test_unported_training_options_raise():
    _, _, tm, _, _, tin, _ = _train_case(11)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        loop.make_train_step(tm, mesh=object())
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        loop.make_eval_step(tm, mesh=object())
    with pytest.raises(ValueError, match="floating"):
        loop.make_train_step(tm, compute_dtype=torch.int32)
    preds = loop.make_eval_step(tm)(tin)
    assert preds.shape == (B, L, 1) and not preds.requires_grad


# --------------------------------------------------------------- toy


def test_brownian_motion_data_contract():
    x, y = brownian_motion_data(torch.Generator().manual_seed(0), 64, 5, device="cpu")
    assert x.shape == (64, 5, 2) and y.shape == (64, 5)
    close(x[0, :, 0], np.linspace(0.0, 1.0, 5), rtol=1e-6)
    assert (x[:, 0, 1] == 0).all()
    close(y, (x[:, -1:, 1] > 0).double().expand(64, 5), rtol=0, atol=0)
    x2, _ = brownian_motion_data(torch.Generator().manual_seed(0), 64, 5, device="cpu")
    assert torch.equal(x, x2)
    inc = torch.diff(brownian_motion_data(torch.Generator().manual_seed(1), 4096, 3,
                                          device="cpu")[0][..., 1], dim=1)
    assert abs(float(inc.std()) - 0.5 ** 0.5) < 0.03  # sqrt(dt), dt = 0.5


def test_toy_loss_curve_matches_jax():
    """The toy's rectilinear scheme trained by the port's ``train_scheme``
    and by the JAX script's loop (optax.adam(1e-3), mean sigmoid BCE) from
    the same numpy data and weights, in float64."""
    rng = np.random.default_rng(12)
    inc = rng.normal(size=(16, 2)) * np.sqrt(0.5)
    bm = np.concatenate([np.zeros((16, 1)), np.cumsum(inc, axis=1)], axis=1)
    x = np.stack([np.broadcast_to(np.linspace(0, 1, 3), bm.shape), bm], axis=-1)
    y = np.broadcast_to((bm[:, -1:] > 0).astype(np.float64), bm.shape).copy()
    kw = dict(input_dim=2, hidden_dim=3, output_dim=1, hidden_hidden_dim=4, num_layers=2,
              interpolation="rectilinear", return_sequences=True, adjoint=True,
              solver="rk4")
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float64), jm.init(jax.random.PRNGKey(2)))
    tm = NeuralCDE(**kw, device="cpu", dtype=torch.float64)
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)

    data = tuple(torch.from_numpy(a) for a in (x, y, x, y))
    got = sim_bm_toy.train_scheme("rectilinear", data, epochs=2, hidden=3, width=4,
                                  reps=1, batch_size=8, device="cpu", models=[tm])

    coeffs = jax_interp.linear_interpolation_coeffs(jnp.asarray(x), rectilinear=0)
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


def test_toy_experiment_runs_and_refuses_unported_schemes(tmp_path):
    """Every scheme of the JAX script runs on the CPU, the natural cubic
    and Hermite ones included."""
    out = tmp_path / "table.csv"
    sim_bm_toy.main(["--epochs", "1", "--paths", "16", "--batch-size", "8", "--reps", "1",
                     "--hidden", "3", "--width", "4", "--device", "cpu",
                     "--schemes", "linear", "cubic", "cubic_hermite", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0].startswith("interpolation,")
    assert [ln.split(",")[0] for ln in lines[1:]] == ["linear", "cubic", "cubic_hermite"]
    with pytest.raises(ValueError, match="unknown scheme"):
        sim_bm_toy.coefficients("quadratic", torch.zeros(2, 3, 2))
