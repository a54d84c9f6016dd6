"""bf16 operands in the port's fused field, against the JAX package on the
CPU: bf16 storage (the ``compute_dtype="bfloat16"`` training step) and the
op's ``precision="bfloat16"`` (every product's operands rounded to bf16),
each with float32 accumulation.

The plain field must round where the JAX reference rounds: its products
accumulate in float32 (``_mm``), the bias add, relu, tanh and the dX sum
stay float32, and only the output is cast to the storage dtype; autograd
through it then rounds each cotangent where ``jax.vjp`` does.  The two
sides sum in float32 in other orders, so a sum near a rounding boundary may
land on the neighbouring bf16 value.  Under ``"float32"`` precision only
the results are rounded, and the gate is one bf16 ulp, |err| <= 2^-7 |want|
+ 1e-5 max|want|.  Under ``"bfloat16"`` every product's operands are
rounded too, and an operand that lands on its neighbour moves every sum
downstream by an ulp of its terms, which cancellation can leave large
against the sum itself: the absolute part becomes one ulp of the group's
largest value, 2^-8 max|want|.  Stored in bf16, at least 99% of the
elements must be equal to the bit.

Inputs come from numpy with a fixed seed; weights cross with
``params_from_jax`` where a model is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import kernels as jax_kernels
from online_neural_cdes_tpu.training import loop as jax_loop
from online_neural_cdes_tpu_torch import Predictor, linear_interpolation_coeffs
from online_neural_cdes_tpu_torch.ops import kernels
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

from test_torch_port_training import _model_pair, _series, _train_case

torch.set_num_threads(1)

ULP_RTOL, ULP_ATOL_PER_MAX, MIN_BIT_EQUAL = 2.0 ** -7, 1e-5, 0.99
ROUNDED_ATOL_PER_MAX = 2.0 ** -8
# (B, H, HH, I, n_trunk): a small ragged field and an unpadded
# flagship-like one.
SHAPES = [(8, 16, 24, 3, 2), (16, 128, 128, 21, 2)]
PRECISIONS = ("float32", "bfloat16")


def _ids(shape):
    return "x".join(map(str, shape))


def _inputs(shape, seed=0):
    """Weights at 1/sqrt(fan-in), z, dx and the cotangent g, float32."""
    batch, hidden, hh, n_in, n_trunk = shape
    rng = np.random.default_rng(seed)

    def u(size, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return rng.uniform(-bound, bound, size=size).astype(np.float32)

    trunk, d_in = [], hidden
    for _ in range(n_trunk):
        trunk.append({"w": u((d_in, hh), d_in), "b": u((hh,), d_in)})
        d_in = hh
    head_w, head_b = u((hh, n_in * hidden), hh), u((n_in * hidden,), hh)
    z, dx, g = (rng.standard_normal(s).astype(np.float32)
                for s in ((batch, hidden), (batch, n_in), (batch, hidden)))
    return trunk, head_w, head_b, z, dx, g


def _both(shape, storage, seed=0):
    """The same inputs as JAX arrays and as torch tensors in ``storage``
    ("float32" or "bfloat16")."""
    trunk, head_w, head_b, z, dx, g = _inputs(shape, seed)
    jd, td = jnp.dtype(storage), getattr(torch, storage)

    def j(a):
        return jnp.asarray(a).astype(jd)

    def t(a):
        return torch.from_numpy(a).to(td)

    jargs = ([{k: j(v) for k, v in layer.items()} for layer in trunk], j(head_w), j(head_b),
             j(z), j(dx))
    targs = ([{k: t(v) for k, v in layer.items()} for layer in trunk], t(head_w), t(head_b),
             t(z), t(dx))
    return jargs, targs, j(g), t(g)


def _ulp_gate(name, got, want, precision, min_equal=MIN_BIT_EQUAL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), dtype=np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    atol = ULP_ATOL_PER_MAX if precision == "float32" else ROUNDED_ATOL_PER_MAX
    tol = ULP_RTOL * np.abs(want) + atol * np.abs(want).max()
    assert (err <= tol).all(), (name, float(err.max()))
    equal = float((got == want).mean())
    assert equal >= min_equal, (name, equal)
    return equal


def _port_vjp(targs, tg, hidden, n_in, precision):
    """The port's output and every cotangent through the autograd op, in
    ``jax.vjp``'s order (trunk, head_w, head_b, z, dx)."""
    trunk, head_w, head_b, z, dx = targs
    leaves = [t.clone().requires_grad_() for t in
              (head_w, head_b, z, dx, *kernels._flat_trunk(trunk))]
    hw, hb, z_, dx_, *flat = leaves
    out = kernels.fused_matmul_field(kernels._unflat_trunk(flat), hw, hb, z_, dx_, hidden,
                                     n_in, precision)
    d_hw, d_hb, d_z, d_dx, *d_flat = torch.autograd.grad(out, leaves, tg)
    return out, (kernels._unflat_trunk(d_flat), d_hw, d_hb, d_z, d_dx)


def _jax_vjp(jargs, jg, hidden, n_in, precision):
    def f(trunk, head_w, head_b, z, dx):
        return jax_kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, hidden, n_in,
                                              False, precision)

    out, vjp = jax.vjp(f, *jargs)
    return out, vjp(jg)


def _groups(cotangents):
    trunk, head_w, head_b, z, dx = cotangents
    named = [("dhead_w", head_w), ("dhead_b", head_b), ("dz", z), ("ddx", dx)]
    for l, layer in enumerate(trunk):
        named += [(f"dtrunk[{l}].w", layer["w"]), (f"dtrunk[{l}].b", layer["b"])]
    return named


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_bf16_field_and_vjp_match_jax_reference(shape, precision):
    """bf16 storage: the port's output and every cotangent of ``jax.vjp``
    within the gate of the JAX reference, >= 99% equal to the bit, in the
    JAX dtypes (before the plain field accumulated in float32, fewer than
    half of its output bits matched: the next test)."""
    batch, hidden, hh, n_in, n_trunk = shape
    jargs, targs, jg, tg = _both(shape, "bfloat16")
    got, got_ct = _port_vjp(targs, tg, hidden, n_in, precision)
    want, want_ct = _jax_vjp(jargs, jg, hidden, n_in, precision)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _ulp_gate("out", got, want, precision)
    for (name, g), (_, w) in zip(_groups(got_ct), _groups(want_ct)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        _ulp_gate(name, g, w, precision)


def test_rounding_every_op_to_bf16_misses_the_jax_reference():
    """The fault the plain field had: ``u @ w`` on bf16 tensors rounds every
    product, bias add, relu, tanh and the channel sum to bf16, where the JAX
    reference accumulates in float32 and rounds only the output.  At (64,
    128, 128, 21, 2) fewer than half of that arithmetic's outputs equal
    JAX's bits; the repaired plain field matches at least 99%."""
    def rounding_every_op(trunk, head_w, head_b, z, dx, hidden, n_in):
        u = z
        for layer in trunk:
            u = torch.relu(u @ layer["w"] + layer["b"])
        a = torch.tanh(u @ head_w + head_b).reshape(-1, n_in, hidden)
        return torch.sum(a * dx[..., :, None], dim=-2)

    jargs, targs, _, _ = _both((64, 128, 128, 21, 2), "bfloat16")
    want = np.asarray(jax_kernels._forward_reference(*jargs, 128, 21).astype(jnp.float32))
    old = rounding_every_op(*targs, 128, 21).float().numpy()
    assert float((old == want).mean()) < 0.5
    _ulp_gate("out", kernels.fused_matmul_field(*targs, 128, 21), want, "float32")


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_f32_storage_bfloat16_precision_vjp_matches_jax_reference(shape):
    """float32 storage under ``precision="bfloat16"``: float32 results and
    cotangents; the cotangents of the products' rounded operands (dz and the
    weight grads) are bf16 values, the rest float32 sums, whose last bits
    differ from JAX's, so bit-equality is not asked."""
    batch, hidden, hh, n_in, n_trunk = shape
    jargs, targs, jg, tg = _both(shape, "float32")
    got, got_ct = _port_vjp(targs, tg, hidden, n_in, "bfloat16")
    want, want_ct = _jax_vjp(jargs, jg, hidden, n_in, "bfloat16")
    assert got.dtype == torch.float32
    _ulp_gate("out", got, want, "bfloat16", min_equal=0.0)
    for (name, g), (_, w) in zip(_groups(got_ct), _groups(want_ct)):
        assert g.dtype == torch.float32, name
        _ulp_gate(name, g, w, "bfloat16", min_equal=0.0)
        if name == "dz" or name.endswith(".w") or name == "dhead_w":
            assert torch.equal(g, g.to(torch.bfloat16).float()), f"{name} is not bf16-exact"


@pytest.mark.parametrize("B,H", [(8, 8), (5, 12)])
def test_f32_storage_bfloat16_precision_matches_pallas_kernel_interpret(B, H):
    """The TPU kernel itself under ``precision="bfloat16"``, in Pallas
    interpret mode with its lane-padded packing (as the JAX package's own
    tests run it), against the port's plain version: bf16 products with
    float32 accumulation on both sides, at float32 round-off."""
    from jax.experimental.pallas import tpu as pltpu

    C, HH = 3, 16
    shape = (B, H, HH, C, 2)
    trunk, head_w, head_b, z, dx, _ = _inputs(shape, seed=B)
    field = {"trunk": trunk, "out": {
        "w": head_w.reshape(HH, C, H).transpose(0, 2, 1).reshape(HH, H * C),
        "b": head_b.reshape(C, H).T.reshape(-1)}}
    jfield = jax.tree.map(jnp.asarray, field)
    padded = jax_kernels.pack_fused_params(jfield, H, C, pad=True)
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernels._forward_pallas(
            padded["trunk"], padded["head_w"], padded["head_b"], jnp.asarray(z),
            jnp.asarray(dx), H, C, "bfloat16")
    ours = kernels.pack_fused_params(jax.tree.map(torch.from_numpy, field), H, C)
    np.testing.assert_array_equal(ours["head_w"].numpy(), head_w)
    got = kernels.fused_matmul_field(ours["trunk"], ours["head_w"], ours["head_b"],
                                     torch.from_numpy(z), torch.from_numpy(dx), H, C,
                                     "bfloat16")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_pallas_backward_under_bfloat16_precision_keeps_f32_cotangent_products():
    """Observed in the reference: the opt-in Pallas backward
    (``_backward_pallas``, ONCDE_PALLAS_BWD=1) rounds the forward
    recompute's operands under ``precision="bfloat16"`` but multiplies its
    cotangents by the unrounded operands, so its dz and dW_o are not the
    bf16 values that ``jax.vjp`` of the reference gives (its default route,
    which the port's plain version and its kernel follow); they differ by
    more than 1e-3 of max."""
    from jax.experimental.pallas import tpu as pltpu

    B, H, HH, C = 8, 8, 16, 3
    jargs, targs, jg, tg = _both((B, H, HH, C, 2), "float32", seed=3)
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_kernels._backward_pallas(*jargs, jg, H, C, "bfloat16")
    _, want = _jax_vjp(jargs, jg, H, C, "bfloat16")
    _, got = _port_vjp(targs, tg, H, C, "bfloat16")
    for p, w, g in [(pallas[3], want[3], got[3]), (pallas[1], want[1], got[1])]:
        p, w = np.asarray(p, np.float64), np.asarray(w, np.float64)
        assert np.abs(p - w).max() > 1e-3 * np.abs(w).max()
        assert torch.equal(g, g.bfloat16().float())
        assert not np.array_equal(p, np.asarray(jnp.asarray(p, jnp.float32).astype(
            jnp.bfloat16).astype(jnp.float32), np.float64))


def test_neural_cde_bf16_forward_matches_jax():
    """A NeuralCDE with bf16 parameters (carried over from JAX, then cast)
    on bf16 coefficients, rectilinear with static features, against the
    JAX model in bf16: the same bf16 states at every knot (the RK updates
    round to bf16 on both sides), within two bf16 ulps, most of them equal
    to the bit."""
    jm, jparams, tm = _model_pair(3, interpolation="rectilinear", return_sequences=True,
                                  static_dim=2)
    x, static = _series(3)
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x), rectilinear=0))
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    want = jm.apply(jp16, (jnp.asarray(static, jnp.bfloat16), jnp.asarray(coeffs, jnp.bfloat16)))
    tm = tm.to(torch.bfloat16)
    with torch.no_grad():
        got = tm((torch.from_numpy(static).bfloat16(), torch.from_numpy(coeffs).bfloat16()))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w = np.asarray(want.astype(jnp.float32), np.float64)
    g = got.float().numpy().astype(np.float64)
    np.testing.assert_allclose(g, w, rtol=2 * ULP_RTOL, atol=ULP_ATOL_PER_MAX * np.abs(w).max())
    assert float((g == w).mean()) >= 0.9


def test_rk_update_of_a_bf16_state_rounds_its_step_through_bf16():
    """The RK update y + (h c) k of a bf16 state: PyTorch's CPU add rounds
    its alpha to bf16 and the card's keeps it in float32, so the port
    rounds h c through the state's dtype itself, and both devices compute
    the same: float32 y + bf16(h c) k, rounded once (float32 and float64
    states are unchanged by the rounding)."""
    from online_neural_cdes_tpu_torch.ops import solvers

    rng = np.random.default_rng(0)
    y, k = (torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).bfloat16()
            for _ in range(2))
    h = 0.123456789
    h16 = float(torch.tensor(h).bfloat16())   # the step size in the state's dtype
    for c in (1.0 / 3.0, 0.375, 1.0):
        alpha = float(torch.tensor(h16 * c, dtype=torch.float32).bfloat16())
        assert torch.equal(solvers._axpy(y, h, k, c), (y.float() + alpha * k.float()).bfloat16())
    y32, k32 = y.float(), k.float()
    h32 = float(np.float32(h))
    assert torch.equal(solvers._axpy(y32, h, k32, 1.0 / 3.0),
                       torch.add(y32, k32, alpha=h32 / 3.0))


def _jax_step(jm, jparams, jin, jlab, compute_dtype):
    step = jax_loop.make_train_step(jm, loss="bce", lr=LR, donate=False,
                                    compute_dtype=compute_dtype)
    params, _, loss = step(jparams, jax_loop.init_adam_state(jparams), jin, jlab, 1.0)
    return flatten_tree(jax.tree.map(np.asarray, params)), float(loss)


LR = 1e-2


@pytest.mark.parametrize("seed", [8, 3])
def test_train_step_compute_dtype_bfloat16_matches_jax(seed):
    """One ``make_train_step(compute_dtype="bfloat16")`` step (float64
    master weights) against JAX's.  Both run the whole model in bf16, but
    XLA fuses bf16 elementwise chains and rounds at the end of a fusion
    where PyTorch rounds after every op, so the losses agree to a share of
    JAX's own bf16-vs-float32 loss gap on the same case, measured here
    (8.6e-4 at seed 8, 3.6e-5 at seed 3): a quarter of it (the port reads
    about a tenth at seed 8).  Adam's first step moves a weight by lr g / (|g| +
    eps): lr times the sign of its gradient wherever |g| is far above eps =
    1e-8, and by an amount that bf16 changes only where |g| is near it, so
    per parameter the weights after the step are held to twice JAX's own
    bf16-vs-float32 gap of that parameter (the port reads up to 1.4 of it,
    at seed 3's first trunk weight), plus 1e-9 where that gap is 0."""
    jm, jparams, tm, jin, jlab, tin, tlab = _train_case(seed)
    want16, loss16 = _jax_step(jm, jparams, jin, jlab, "bfloat16")
    want32, loss32 = _jax_step(jm, jparams, jin, jlab, "float32")
    got = loop.make_train_step(tm, loss="bce", lr=LR, compute_dtype="bfloat16")(
        tin, tlab, 1.0)
    assert abs(float(got) - loss16) <= 0.25 * abs(loss16 - loss32), (float(got), loss16,
                                                                      loss32)
    for name, p in tm.state_dict().items():
        assert p.dtype == torch.float64, name
        gap = np.abs(want16[name] - want32[name]).max()
        np.testing.assert_allclose(p.numpy(), want16[name], rtol=0, atol=2 * gap + 1e-9,
                                   err_msg=name)


# ------------------------------------------------------------ wrapper rules


def _field_args(dtype=torch.float32):
    _, targs, _, tg = _both((2, 4, 5, 3, 2), "float32")
    trunk, head_w, head_b, z, dx = targs
    cast = lambda t: t.to(dtype)
    return ([{k: cast(v) for k, v in layer.items()} for layer in trunk], cast(head_w),
            cast(head_b), cast(z), cast(dx)), cast(tg)


def test_kernel_wrappers_refuse_mixed_dtypes_float16_and_unknown_precision():
    """Run here on CPU tensors, before any launch: the same checks guard
    the launch on the card."""
    (trunk, head_w, head_b, z, dx), g = _field_args()
    before = (kernels.fused_field_kernel.launches, kernels.fused_field_bwd_kernel.launches)
    with pytest.raises(TypeError, match="one dtype"):
        kernels._forward_kernel(trunk, head_w, head_b, z.bfloat16(), dx, 4, 3)
    with pytest.raises(TypeError, match="one dtype"):
        kernels._backward_kernel(trunk, head_w, head_b, z, dx, g.bfloat16(), 4, 3)
    (trunk16, head_w16, head_b16, z16, dx16), g16 = _field_args(torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels._forward_kernel(trunk16, head_w16, head_b16, z16, dx16, 4, 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels._backward_kernel(trunk16, head_w16, head_b16, z16, dx16, g16, 4, 3)
    for call in (lambda: kernels._forward_kernel(trunk, head_w, head_b, z, dx, 4, 3, "tf32"),
                 lambda: kernels._backward_kernel(trunk, head_w, head_b, z, dx, g, 4, 3,
                                                  "tf32"),
                 lambda: kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, 4, 3,
                                                    "bf16")):
        with pytest.raises(ValueError, match="precision must be one of"):
            call()
    assert (kernels.fused_field_kernel.launches,
            kernels.fused_field_bwd_kernel.launches) == before


def test_cpu_bf16_training_step_and_forward_launch_no_kernel():
    """bf16 on the CPU runs the plain versions (no launch); on a CUDA
    tensor the same calls launch the kernels or raise."""
    _, _, tm, _, _, tin, tlab = _train_case(10)
    before = (kernels.fused_field_kernel.launches, kernels.fused_field_bwd_kernel.launches)
    loss = loop.make_train_step(tm, loss="bce", compute_dtype="bfloat16")(tin, tlab, 1.0)
    (trunk, head_w, head_b, z, dx), _ = _field_args(torch.bfloat16)
    out = kernels.fused_matmul_field(trunk, head_w, head_b, z, dx, 4, 3, "bfloat16")
    assert torch.isfinite(loss) and out.dtype == torch.bfloat16
    assert (kernels.fused_field_kernel.launches,
            kernels.fused_field_bwd_kernel.launches) == before


@pytest.mark.parametrize("op", ["fused_rk4_interval", "fused_rk4_interval_multi"])
def test_rk4_ops_refuse_float16(op):
    """The interval ops take float32 and bfloat16 (and float64 on the CPU),
    as the field ops; float16 is refused on every device, before any
    launch, with a message that names what they take."""
    (trunk, head_w, head_b, z, dx), _ = _field_args(torch.float16)
    if op.endswith("multi"):
        trunk = [{k: v[None] for k, v in layer.items()} for layer in trunk]
        head_w, head_b, z, dx = (t[None] for t in (head_w, head_b, z, dx))
    before = (kernels.fused_rk4_kernel.launches, kernels.fused_rk4_multi_kernel.launches)
    with torch.no_grad(), pytest.raises(TypeError, match="float32 or bfloat16"):
        getattr(kernels, op)(trunk, head_w, head_b, z, dx, 4, 3)
    assert (kernels.fused_rk4_kernel.launches,
            kernels.fused_rk4_multi_kernel.launches) == before


# ------------------------------------------------- whole-interval RK4 in bf16

# The flagship field's width at a small batch, and a ragged one (H and HH
# not multiples of 8, three trunk layers).
RK4_SHAPES = [(16, 128, 128, 21, 2), (5, 96, 196, 21, 3)]
RK4_REPLICAS = 3


def _stacked(args_list):
    """K single calls' operands in the K-replica op's stacked layouts."""
    trunk = [{k: np.stack([a[0][l][k] for a in args_list]) for k in ("w", "b")}
             for l in range(len(args_list[0][0]))]
    return (trunk, *(np.stack([a[i] for a in args_list]) for i in range(1, 5)))


def _bf16_both(args):
    """numpy operands (trunk, head_w, head_b, z, dx) as bf16 JAX arrays and
    bf16 torch tensors."""
    j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
    trunk, *rest = args
    return (([{k: j(v) for k, v in layer.items()} for layer in trunk], *map(j, rest)),
            ([{k: t(v) for k, v in layer.items()} for layer in trunk], *map(t, rest)))


@pytest.mark.parametrize("shape", RK4_SHAPES, ids=_ids)
def test_bf16_rk4_interval_matches_pallas_kernel_interpret(shape):
    """``fused_rk4_interval`` in bf16 storage against the TPU kernel in
    Pallas interpret mode (as ``test_torch_port_rk4.py`` runs it in
    float32): both widen the operands, step in float32 and round the result
    once to bf16; within one bf16 ulp, >= 99% equal to the bit."""
    from jax.experimental.pallas import tpu as pltpu

    batch, hidden, hh, n_in, n_trunk = shape
    jargs, targs = _bf16_both(_inputs(shape, seed=21)[:5])
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernels.fused_rk4_interval(*jargs, hidden, n_in)
    got = kernels.fused_rk4_interval(*targs, hidden, n_in)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == (batch, hidden)
    _ulp_gate("out", got, want, "float32")


@pytest.mark.parametrize("shape", RK4_SHAPES, ids=_ids)
def test_bf16_rk4_interval_multi_matches_pallas_kernel_interpret(shape):
    """``fused_rk4_interval_multi`` in bf16 storage, K=3 replicas with their
    own weights, against the TPU kernel in interpret mode; the same gate."""
    from jax.experimental.pallas import tpu as pltpu

    batch, hidden, hh, n_in, n_trunk = shape
    jargs, targs = _bf16_both(_stacked([_inputs(shape, seed=40 + r)[:5]
                                        for r in range(RK4_REPLICAS)]))
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernels.fused_rk4_interval_multi(*jargs, hidden, n_in)
    got = kernels.fused_rk4_interval_multi(*targs, hidden, n_in)
    assert got.dtype == torch.bfloat16 and got.shape == (RK4_REPLICAS, batch, hidden)
    _ulp_gate("out", got, want, "float32")


def test_stepping_rk4_in_bf16_misses_the_jax_reference():
    """What the plain version must not do: the RK4 stepper on bf16 tensors
    rounds every field evaluation, every stage input and every update to
    bf16, where the JAX op steps in float32 and rounds only the result.  At
    the flagship width fewer than two thirds of that arithmetic's outputs
    equal the interpreted kernel's bits; the port's plain version matches
    at least 99%."""
    from jax.experimental.pallas import tpu as pltpu
    from online_neural_cdes_tpu_torch.ops import solvers

    shape = RK4_SHAPES[0]
    batch, hidden, hh, n_in, n_trunk = shape
    jargs, targs = _bf16_both(_inputs(shape, seed=22)[:5])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_kernels.fused_rk4_interval(*jargs, hidden, n_in)
                          .astype(jnp.float32))
    trunk, head_w, head_b, z, dx = targs

    def field_in_bf16(t, zz):
        u = zz
        for layer in trunk:
            u = torch.relu(u @ layer["w"] + layer["b"])
        a = torch.tanh(u @ head_w + head_b).reshape(-1, n_in, hidden)
        return torch.sum(a * dx[..., :, None], dim=-2)

    stepped = solvers.tree_fixed_step("rk4")(field_in_bf16, 0.0, 1.0, z)
    assert stepped.dtype == torch.bfloat16
    assert float((stepped.float().numpy() == want).mean()) < 2 / 3
    _ulp_gate("out", kernels.fused_rk4_interval(*targs, hidden, n_in), want, "float32")


def test_predictor_serves_a_bf16_model_in_its_dtype():
    """The requests go in at the model's dtype, so a bf16 model serves in
    bf16 (the stepper's convention); outputs come back as float32 arrays
    equal to the model's own bf16 forward."""
    jm, jparams, tm = _model_pair(5, interpolation="rectilinear", return_sequences=True)
    tm = tm.to(torch.bfloat16)
    x, _ = _series(5, nan=False)
    coeff_fn = lambda s: linear_interpolation_coeffs(s, rectilinear=0)
    pred = Predictor(tm, coeff_fn=coeff_fn, batch_buckets=(4,), length_multiple=4,
                     device="cpu")
    outs = pred.predict(x.astype(np.float32))
    with torch.no_grad():
        want = tm(coeff_fn(torch.from_numpy(x.astype(np.float32)).bfloat16()))
    assert outs[0].dtype == np.float32
    np.testing.assert_array_equal(np.stack(outs), want.float().numpy())


def test_predictor_returns_a_float64_model_s_outputs_in_float64():
    """Only reduced-precision outputs are widened on their way to numpy: a
    float64 model's come back as float64 arrays, equal to its forward."""
    jm, jparams, tm = _model_pair(5, interpolation="rectilinear", return_sequences=True)
    x, _ = _series(5, nan=False)
    coeff_fn = lambda s: linear_interpolation_coeffs(s, rectilinear=0)
    pred = Predictor(tm, coeff_fn=coeff_fn, batch_buckets=(4,), length_multiple=4,
                     device="cpu")
    outs = pred.predict(x)
    with torch.no_grad():   # the requests are padded in float32 on the host
        want = tm(coeff_fn(torch.from_numpy(x.astype(np.float32)).double()))
    assert outs[0].dtype == np.float64
    np.testing.assert_array_equal(np.stack(outs), want.numpy())
