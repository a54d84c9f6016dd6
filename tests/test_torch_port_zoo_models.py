"""Parity of the PyTorch port's model zoo against the JAX package, on the
CPU: the GRU and RNN cells, ``RNN``, ``time_since_last_observation``, the
five ``prepare_gru_variant_data`` variants, ``GRUD``, ``ODERNN``,
``StackedNeuralCDE``, ``sparsemax``, the kept-state compaction,
``AttentionNeuralCDE``, and one Adam step of every model string of the
JAX harness's registry.

Weights are made by the JAX ``init`` and carried across with
``params_from_jax``; inputs come from numpy with a fixed seed.  Module and
model tests run in float64 on both sides at rtol=1e-9, atol=1e-10 (the
same formulas, only summation order differs); parameters after an Adam
step at rtol=1e-8, since Adam's division by the root of the second moment
amplifies round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models import attention as jax_attention
from online_neural_cdes_tpu.models import grud as jax_grud
from online_neural_cdes_tpu.models import rnn as jax_rnn
from online_neural_cdes_tpu.models.odernn import ODERNN as JaxODERNN
from online_neural_cdes_tpu.models.stacked import StackedNeuralCDE as JaxStacked
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.training import harness as jax_harness
from online_neural_cdes_tpu.training import loop as jax_loop
from online_neural_cdes_tpu_torch import (
    GRUD,
    ODERNN,
    RNN,
    AttentionNeuralCDE,
    NeuralCDE,
    StackedNeuralCDE,
    params_from_jax,
    prepare_gru_variant_data,
    sparsemax,
)
from online_neural_cdes_tpu_torch.models import attention, grud, rnn
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree
from online_neural_cdes_tpu_torch.utils.params import param_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
B, L, C, H, HH, S = 3, 6, 3, 4, 5, 2


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64), tree)


def _series(seed, n=L, c=C, holes=True):
    """(B, n, c) with time in channel 0, interior gaps, a leading gap and a
    whole missing observation (time kept)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n, c))
    x[..., 0] = np.arange(n)
    if holes:
        x[0, 2:4, 1] = np.nan
        x[1, :2, 2] = np.nan
        x[2, 3, 1:] = np.nan
    return x


def _grads_match(tm, w_grads, rtol=RTOL, atol=ATOL):
    w_flat = flatten_tree(_np_tree(w_grads))
    for name, p in tm.named_parameters():
        if p.grad is None:   # no path from the loss (JAX: a zero gradient)
            assert not np.any(w_flat[name]), name
        else:
            close(p.grad, w_flat[name], rtol, atol, name)


def _fwd_bwd(jfn, jparams, tm, t_inputs, seed=0):
    """Forward against JAX and the VJP of a random cotangent against
    JAX's, for every parameter; ``t_inputs`` is the port model's input, or
    a function of the model that runs it."""
    want, vjp = jax.vjp(jfn, jparams)
    g = np.random.default_rng(seed).normal(size=want.shape)
    (w_grads,) = vjp(jnp.asarray(g))
    got = t_inputs(tm) if callable(t_inputs) else tm(t_inputs)
    assert tuple(got.shape) == want.shape
    close(got, want)
    got.backward(torch.from_numpy(g))
    _grads_match(tm, w_grads)
    return got


# -------------------------------------------------------------- cells


@pytest.mark.parametrize("gru", [True, False], ids=["gru", "rnn"])
def test_cell_matches_jax(gru):
    init, apply = ((jax_rnn.gru_cell_init, jax_rnn.gru_cell_apply) if gru else
                   (jax_rnn.rnn_cell_init, jax_rnn.rnn_cell_apply))
    jp = _f64(init(jax.random.PRNGKey(0), C, H))
    tp = param_tree(jax.tree.map(torch.tensor, _np_tree(jp)))
    rng = np.random.default_rng(0)
    x, h = rng.normal(size=(B, C)), rng.normal(size=(B, H))
    t_apply = rnn.gru_cell_apply if gru else rnn.rnn_cell_apply
    close(t_apply(tp, torch.from_numpy(x), torch.from_numpy(h)),
          apply(jp, jnp.asarray(x), jnp.asarray(h)))


def test_gru_cell_is_torch_gru_cell():
    """The (in, out) layout transposed is ``torch.nn.GRUCell``'s weights."""
    gen = torch.Generator().manual_seed(1)
    p = param_tree(rnn.gru_cell_init(gen, C, H, torch.float64))
    cell = torch.nn.GRUCell(C, H, dtype=torch.float64)
    with torch.no_grad():
        cell.weight_ih.copy_(p["ih"]["w"].T)
        cell.bias_ih.copy_(p["ih"]["b"])
        cell.weight_hh.copy_(p["hh"]["w"].T)
        cell.bias_hh.copy_(p["hh"]["b"])
    x, h = torch.randn(B, C, dtype=torch.float64), torch.randn(B, H, dtype=torch.float64)
    close(rnn.gru_cell_apply(p, x, h), cell(x, h).detach())


RNN_CASES = {"gru_last": dict(gru=True), "gru_seq": dict(gru=True, return_sequences=True),
             "rnn_seq_no_final": dict(gru=False, return_sequences=True,
                                      apply_final_linear=False)}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_rnn_matches_jax(case):
    kw = dict(input_dim=C, hidden_dim=H, output_dim=2, **RNN_CASES[case])
    jm = jax_rnn.RNN(**kw)
    jp = _f64(jm.init(jax.random.PRNGKey(2)))
    tm = params_from_jax(_np_tree(jp), RNN(**kw, device="cpu", dtype=torch.float64))
    x = np.nan_to_num(_series(2))
    _fwd_bwd(lambda p: jm.apply(p, jnp.asarray(x)), jp, tm, torch.from_numpy(x))


# --------------------------------------------------------------- GRU-D


def test_time_since_last_observation_matches_jax():
    x = _series(3)
    want_delta, want_mask = jax_grud.time_since_last_observation(jnp.asarray(x))
    delta, mask = grud.time_since_last_observation(torch.from_numpy(x))
    close(delta, want_delta)
    close(mask, want_mask, rtol=0, atol=0)


@pytest.mark.parametrize("with_means", [False, True], ids=["no_means", "means"])
@pytest.mark.parametrize("variant", grud.GRU_VARIANTS)
def test_prepare_gru_variant_data_matches_jax(variant, with_means):
    x = _series(4)
    x[2, -2:] = np.nan               # past the series' end: NaN time channel
    means = np.nanmean(x.reshape(-1, C), axis=0) if with_means else None
    want = jax_grud.prepare_gru_variant_data(
        jnp.asarray(x), variant, None if means is None else jnp.asarray(means))
    got = prepare_gru_variant_data(torch.from_numpy(x), variant,
                                   None if means is None else torch.from_numpy(means))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("return_sequences", [False, True], ids=["last", "seq"])
def test_grud_matches_jax(return_sequences):
    x = _series(5)
    means = np.nanmean(x.reshape(-1, C), axis=0)
    means[1] = np.nan                # a channel never observed: its mean is 0
    inputs = np.asarray(jax_grud.prepare_gru_variant_data(jnp.asarray(x), "gru-d",
                                                          jnp.asarray(means)))
    kw = dict(input_dim=C, hidden_dim=H, output_dim=2, return_sequences=return_sequences)
    jm = jax_grud.GRUD(**kw)
    jp = _f64(jm.init(jax.random.PRNGKey(5)))
    tm = params_from_jax(_np_tree(jp), GRUD(**kw, feature_means=torch.from_numpy(means),
                                           device="cpu", dtype=torch.float64))
    assert "feature_means" not in tm.state_dict()
    _fwd_bwd(lambda p: jm.apply(p, jnp.asarray(inputs), jnp.asarray(means)), jp, tm,
             torch.from_numpy(inputs))
    # An explicit argument overrides the held means.
    other = np.full(C, 3.0)
    with torch.no_grad():
        close(tm(torch.from_numpy(inputs), torch.from_numpy(other)),
              jm.apply(jp, jnp.asarray(inputs), jnp.asarray(other)))


# -------------------------------------------------------------- ODE-RNN


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no_quirk"])
@pytest.mark.parametrize("return_sequences", [False, True], ids=["last", "seq"])
@pytest.mark.parametrize("gru", [True, False], ids=["gru", "rnn"])
def test_odernn_matches_jax(gru, return_sequences, quirk):
    """Each cell, each return mode, the first-gap quirk on and off, over
    irregular times: outputs and every parameter's gradient."""
    kw = dict(input_dim=C, hidden_dim=H, output_dim=2, hidden_hidden_dim=HH, num_layers=2,
              gru=gru, return_sequences=return_sequences, replicate_dt_quirk=quirk)
    jm = JaxODERNN(**kw)
    jp = _f64(jm.init(jax.random.PRNGKey(6)))
    tm = params_from_jax(_np_tree(jp), ODERNN(**kw, device="cpu", dtype=torch.float64))
    x = np.nan_to_num(_series(6))
    times = np.cumsum(np.random.default_rng(6).uniform(0.2, 1.5, size=L))
    _fwd_bwd(lambda p: jm.apply(p, jnp.asarray(x), jnp.asarray(times)), jp, tm,
             lambda m: m(torch.from_numpy(x), times), seed=6)
    if quirk:   # default times 0..L-1
        with torch.no_grad():
            close(tm(torch.from_numpy(x)), jm.apply(jp, jnp.asarray(x)))


# ------------------------------------------------------- stacked NCDE


STACKED_CASES = {"no_static": dict(), "static_first": dict(static_dim=S),
                 "static_all": dict(static_dim=S, static_in_all_layers=True,
                                    return_sequences=True)}


@pytest.mark.parametrize("case", sorted(STACKED_CASES))
def test_stacked_ncde_matches_jax(case):
    """Forward and float64 gradients of every parameter; layer 0's reach it
    only through layer 1's control (the interval adjoint's coefficient
    cotangent)."""
    kw = dict(input_dim=C, hidden_dims=(H, H + 1), output_dim=2, hidden_hidden_dim=HH,
              **STACKED_CASES[case])
    jm = JaxStacked(**kw)
    jp = _f64(jm.init(jax.random.PRNGKey(8)))
    tm = params_from_jax(_np_tree(jp), StackedNeuralCDE(**kw, device="cpu",
                                                        dtype=torch.float64))
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(_series(8))))
    static = np.random.default_rng(8).normal(size=(B, S))
    if "static_dim" in kw:
        jin, tin = ((jnp.asarray(static), jnp.asarray(coeffs)),
                    (torch.from_numpy(static), torch.from_numpy(coeffs)))
    else:
        jin, tin = jnp.asarray(coeffs), torch.from_numpy(coeffs)
    _fwd_bwd(lambda p: jm.apply(p, jin), jp, tm, tin, seed=8)
    assert float(tm.ncde_0.field.trunk[0]["w"].grad.abs().max()) > 0


# ------------------------------------------------------ attention NCDE


def test_sparsemax_matches_jax():
    """Values (rows sum to one, some exact zeros) and gradients, along
    either axis, with ties."""
    z = np.random.default_rng(9).normal(size=(4, 7))
    z[1, 3] = z[1, 5]
    for axis in (-1, 0):
        want, vjp = jax.vjp(lambda v: jax_attention.sparsemax(v, axis=axis), jnp.asarray(z))
        g = np.random.default_rng(10).normal(size=z.shape)
        tz = torch.from_numpy(z).requires_grad_()
        got = sparsemax(tz, dim=axis)
        close(got, want)
        close(got.sum(dim=axis), np.ones(z.shape[1 + axis]))
        assert (got == 0).any()
        got.backward(torch.from_numpy(g))
        close(tz.grad, vjp(jnp.asarray(g))[0])


def test_compact_kept_states_matches_jax():
    rng = np.random.default_rng(11)
    hidden = rng.normal(size=(4, L, H))
    keep = rng.random(size=(4, L)) < 0.4
    keep[0] = False                   # keeps nothing: position 0 stays
    keep[1] = True
    got = attention._compact_kept_states(torch.from_numpy(hidden), torch.from_numpy(keep))
    want = jax_attention._compact_kept_states(jnp.asarray(hidden), jnp.asarray(keep))
    close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("use_sparsemax", [False, True], ids=["softmax", "sparsemax"])
def test_attention_ncde_matches_jax(use_sparsemax):
    """Forward and gradients with statics in all three NCDEs; no gradient
    reaches the attention NCDE through its keep mask (JAX's is zero)."""
    kw = dict(input_dim=C, hidden_dim=H, output_dim=2, static_dim=S,
              sparsemax=use_sparsemax)
    jm = jax_attention.AttentionNeuralCDE(**kw)
    jp = _f64(jm.init(jax.random.PRNGKey(12)))
    tm = params_from_jax(_np_tree(jp), AttentionNeuralCDE(**kw, device="cpu",
                                                          dtype=torch.float64))
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(_series(12))))
    static = np.random.default_rng(12).normal(size=(B, S))
    jin = (jnp.asarray(static), jnp.asarray(coeffs))
    _fwd_bwd(lambda p: jm.apply(p, jin), jp, tm,
             (torch.from_numpy(static), torch.from_numpy(coeffs)), seed=12)
    assert all(p.grad is None for p in tm.attention.parameters())
    _, weights = tm.attention_weights((torch.from_numpy(static), torch.from_numpy(coeffs)))
    kept = (weights > 1.0 / L).sum(dim=-1)
    assert ((kept > 0) & (kept < L)).all()   # the compaction does real work


# ------------------------------------- one Adam step per model string


def _port_model(model_string, bundle, **kw):
    m = bundle.model
    if model_string == "ncde":
        return NeuralCDE(input_dim=m.input_dim, hidden_dim=m.hidden_dim,
                         output_dim=m.output_dim, static_dim=m.static_dim,
                         hidden_hidden_dim=m.hidden_hidden_dim, num_layers=m.num_layers,
                         interpolation=m.interpolation, adjoint=m.adjoint, **kw)
    if model_string == "ncde-stacked":
        return StackedNeuralCDE(input_dim=m.input_dim, hidden_dims=m.hidden_dims,
                                output_dim=m.output_dim, hidden_hidden_dim=m.hidden_hidden_dim,
                                static_dim=m.static_dim, adjoint=m.adjoint, **kw)
    if model_string == "ncde-attention":
        return AttentionNeuralCDE(input_dim=m.input_dim, hidden_dim=m.hidden_dim,
                                  output_dim=m.output_dim, static_dim=m.static_dim,
                                  adjoint=m.adjoint, **kw)
    if model_string == "odernn":
        return ODERNN(input_dim=m.input_dim, hidden_dim=m.hidden_dim, output_dim=m.output_dim,
                      hidden_hidden_dim=m.hidden_hidden_dim, num_layers=m.num_layers,
                      solver=m.solver, adjoint=m.adjoint, **kw)
    if model_string == "gru-d":
        return GRUD(input_dim=m.input_dim, hidden_dim=m.hidden_dim, output_dim=m.output_dim,
                    **kw)
    return RNN(input_dim=m.input_dim, hidden_dim=m.hidden_dim, output_dim=m.output_dim,
               gru=m.gru, **kw)


@pytest.mark.parametrize("model_string", jax_harness.MODEL_STRINGS)
def test_adam_step_per_model_string_matches_jax(model_string):
    """The harness's model built in both packages, one Adam step of each
    package's ``make_train_step`` (BCE, a NaN label masked out): the loss
    and every parameter after the step.  It pins the 10x learning rate on
    the top-level ``final``: the attention model's final NCDE, a readout
    elsewhere, and nothing in the stacked model (its layers are
    ``ncde_i``)."""
    bundle = jax_harness.setup_model(model_string, input_dim=C, output_dim=1,
                                     static_dim=S, hidden_dim=H, hidden_hidden_dim=HH,
                                     num_layers=2)
    jp = _f64(bundle.init(jax.random.PRNGKey(13)))
    tm = params_from_jax(_np_tree(jp), _port_model(model_string, bundle, device="cpu",
                                                   dtype=torch.float64))
    x = _series(13)
    static = np.random.default_rng(13).normal(size=(B, S))
    labels = np.array([1.0, 0.0, np.nan])
    if model_string.startswith("ncde"):
        coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x)))
        jin = (jnp.asarray(static), jnp.asarray(coeffs))
        tin = (torch.from_numpy(static), torch.from_numpy(coeffs))
    else:
        # The harness prepares the ODE-RNN's inputs as gru-intensity, and
        # GRU-D's with zero means when it has no training set.
        variant = "gru-intensity" if model_string == "odernn" else model_string
        means = torch.zeros(C, dtype=torch.float64) if model_string == "gru-d" else None
        jin = bundle.prepare_batch((jnp.asarray(static), jnp.asarray(x)))
        tin = prepare_gru_variant_data(torch.from_numpy(x), variant, means)
        close(tin, jin)
    lr = 1e-2
    jstep = jax_loop.make_train_step(bundle.apply_fn, loss="bce", lr=lr, donate=False)
    jp_new, _, want = jstep(jp, jax_loop.init_adam_state(jp), jin, jnp.asarray(labels), 1.0)
    got = loop.make_train_step(tm, loss="bce", lr=lr)(tin, torch.from_numpy(labels), 1.0)
    close(got, want, rtol=1e-8)
    want_flat = flatten_tree(_np_tree(jp_new))
    for name, p in tm.named_parameters():
        close(p, want_flat[name], rtol=1e-8, atol=1e-10, err_msg=name)
    moved = {name: not np.allclose(want_flat[name], flatten_tree(_np_tree(jp))[name])
             for name in want_flat}
    assert any(moved.values())


# ------------------------------------------- relu decisions (experiment)


def test_tf32_split_rounds_as_the_kernels():
    """``relu_flips``'s model of the kernels' 3xTF32 products: TF32
    rounding to nearest with ties away from zero (cvt.rna), and a split
    product that keeps about 21 of f32's 24 bits."""
    from online_neural_cdes_tpu_torch.experiments.relu_flips import split_product, tf32_round

    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -11],
                     dtype=torch.float32)
    want = [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2 * 2.0 ** -10]
    assert tf32_round(x).tolist() == want
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((16, 64), (64, 8)))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max()
    assert float((split_product(a, b).double() - exact).abs().max() / scale) < 2.0 ** -20
    assert float((tf32_round(a).double() @ tf32_round(b).double() - exact).abs().max()
                 / scale) > 2.0 ** -16


def test_relu_flips_experiment_runs_on_the_cpu():
    """On the CPU the kernels arm is the plain version: no relu decision
    and no gradient differs between them."""
    from online_neural_cdes_tpu_torch.experiments import relu_flips

    out = relu_flips.main(["--device", "cpu", "--rows", "2", "--length", "4",
                           "--hidden", "8"])
    first = out["pairs"][0]
    assert first["arms"] == ["kernels", "plain"]
    assert first["differing_relu_decisions"] == 0
    assert first["largest_gradient_gap"][1] == 0.0
    assert out["backward_calls"] == 2 * 4 * 3
    assert out["forward_calls"]["kernel_vs_emulated"] < 1e-5
