"""The whole-interval RK4 ops of the PyTorch port against the JAX package,
on the CPU: ``fused_rk4_interval`` and ``fused_rk4_interval_multi`` (their
plain versions, which the CPU runs), the wrappers' checks, the interval
chain against the model's solve, the two interval-chain experiments at a
tiny size, and the timing helpers.

The Hopper kernel itself needs the card; ``chip_smoke.py`` holds it
against the plain versions checked here.  Against the TPU kernels run in
Pallas interpret mode the comparison is in float32 at rtol=1e-5,
atol=1e-6 (interpret mode does not keep float64, ROADMAP C); against the
JAX composition (``tree_fixed_step("rk4")`` over ``_forward_reference``)
in float64 at rtol=1e-9, atol=1e-10.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.models.vector_fields import VectorField as JaxVectorField
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import kernels as jax_kernels
from online_neural_cdes_tpu.ops import solvers as jax_solvers
from online_neural_cdes_tpu_torch import NeuralCDE, params_from_jax
from online_neural_cdes_tpu_torch.experiments import interleave_experiment, pair_probe
from online_neural_cdes_tpu_torch.models.vector_fields import VectorField
from online_neural_cdes_tpu_torch.ops import kernels
from online_neural_cdes_tpu_torch.utils import timing

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
B, C, H, HH = 8, 3, 8, 16
REPO = pathlib.Path(__file__).resolve().parents[1]


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _field(seed, n_layers=2, dtype=jnp.float64):
    """JAX and port fields with the same weights, and both unpadded
    packings."""
    jf = JaxVectorField(input_dim=C, hidden_dim=H, hidden_hidden_dim=HH,
                        num_layers=n_layers, kind="original")
    jparams = jax.tree.map(lambda a: a.astype(dtype), jf.init(jax.random.PRNGKey(seed)))
    tf = VectorField(C, H, HH, n_layers, generator=torch.Generator().manual_seed(seed),
                     dtype=torch.float64 if dtype == jnp.float64 else torch.float32,
                     device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tf)
    ours = kernels.pack_fused_params(tf.params, H, C)
    ours = {"trunk": [{k: v.detach() for k, v in layer.items()} for layer in ours["trunk"]],
            "head_w": ours["head_w"].detach(), "head_b": ours["head_b"].detach()}
    return ours, jax_kernels.pack_fused_params(jparams, H, C, pad=False)


def _time_slice(packed, k=0):
    """The rectilinear I = 1 head slice of channel k."""
    w, b = packed["head_w"][:, k * H:(k + 1) * H], packed["head_b"][k * H:(k + 1) * H]
    if isinstance(w, torch.Tensor):
        w, b = w.contiguous(), b.contiguous()
    return dict(packed, head_w=w, head_b=b)


def _state(seed, n_in, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H)).astype(dtype),
            rng.normal(size=(B, n_in)).astype(dtype))


def _ours(p, z, dx, n_in, op=kernels.fused_rk4_interval):
    return op(p["trunk"], p["head_w"], p["head_b"], torch.from_numpy(z),
              torch.from_numpy(dx), H, n_in)


# ----------------------------------------------------------- kernel 3


@pytest.mark.parametrize("time_slice", [False, True])
def test_rk4_interval_plain_matches_pallas_kernel_interpret(time_slice):
    """The TPU kernel ``fused_rk4_interval`` in Pallas interpret mode (as
    ``tests/test_kernels.py`` runs it) against the port at I = C and at the
    I = 1 time slice, float32."""
    from jax.experimental.pallas import tpu as pltpu

    ours, theirs = _field(4, dtype=jnp.float32)
    n_in = 1 if time_slice else C
    if time_slice:
        ours, theirs = _time_slice(ours), _time_slice(theirs)
    z, dx = _state(4, n_in, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernels.fused_rk4_interval(theirs["trunk"], theirs["head_w"],
                                              theirs["head_b"], jnp.asarray(z),
                                              jnp.asarray(dx), H, n_in)
    got = _ours(ours, z, dx, n_in)
    assert got.dtype == torch.float32 and got.shape == (B, H)
    close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("time_slice", [False, True])
def test_rk4_interval_plain_matches_jax_composition(n_layers, time_slice):
    """Against JAX ``tree_fixed_step("rk4")`` from 0 to 1 over
    ``_forward_reference`` (the composition ``tests/test_kernels.py`` and
    ``bench.py`` hold the TPU kernel against), float64."""
    ours, theirs = _field(10 + n_layers, n_layers)
    n_in = 1 if time_slice else C
    if time_slice:
        ours, theirs = _time_slice(ours, k=2), _time_slice(theirs, k=2)
    z, dx = _state(n_layers, n_in)
    want = jax_solvers.tree_fixed_step("rk4")(
        lambda t, zz: jax_kernels._forward_reference(
            theirs["trunk"], theirs["head_w"], theirs["head_b"], zz, jnp.asarray(dx),
            H, n_in), 0.0, 1.0, jnp.asarray(z))
    got = _ours(ours, z, dx, n_in)
    assert got.dtype == torch.float64
    close(got, want)


# ----------------------------------------------------------- kernel 4


def _replicas(k, dtype=jnp.float64):
    fields = [_field(20 + r, dtype=dtype) for r in range(k)]
    np_dtype = np.float32 if dtype == jnp.float32 else np.float64
    states = [_state(30 + r, C, np_dtype) for r in range(k)]
    return fields, states


def _stack(packs, lib):
    trunk = [{"w": lib.stack([p["trunk"][i]["w"] for p in packs]),
              "b": lib.stack([p["trunk"][i]["b"] for p in packs])}
             for i in range(len(packs[0]["trunk"]))]
    return (trunk, lib.stack([p["head_w"] for p in packs]),
            lib.stack([p["head_b"] for p in packs]))


def test_rk4_interval_multi_plain_matches_pallas_kernel_interpret():
    """``fused_rk4_interval_multi`` in interpret mode, K=3 replicas with
    their own weights, as ``tests/test_kernels.py`` runs it; float32."""
    from jax.experimental.pallas import tpu as pltpu

    fields, states = _replicas(3, jnp.float32)
    zs = np.stack([s[0] for s in states])
    dxs = np.stack([s[1] for s in states])
    with pltpu.force_tpu_interpret_mode():
        want = jax_kernels.fused_rk4_interval_multi(
            *_stack([f[1] for f in fields], jnp), jnp.asarray(zs), jnp.asarray(dxs), H, C)
    got = kernels.fused_rk4_interval_multi(*_stack([f[0] for f in fields], torch),
                                           torch.from_numpy(zs), torch.from_numpy(dxs),
                                           H, C)
    assert got.shape == (3, B, H)
    close(got, want, rtol=1e-5, atol=1e-6)


def test_rk4_interval_multi_plain_equals_single_calls():
    fields, states = _replicas(3)
    zs = torch.from_numpy(np.stack([s[0] for s in states]))
    dxs = torch.from_numpy(np.stack([s[1] for s in states]))
    got = kernels.fused_rk4_interval_multi(*_stack([f[0] for f in fields], torch), zs,
                                           dxs, H, C)
    for r, ((ours, _), (z, dx)) in enumerate(zip(fields, states)):
        assert torch.equal(got[r], _ours(ours, z, dx, C))


# ---------------------------------------------------------- wrappers


def _single_args(dtype=torch.float32):
    ours, _ = _field(5, dtype=jnp.float32)
    z, dx = (torch.from_numpy(a).to(dtype) for a in _state(5, C, np.float32))
    return ours["trunk"], ours["head_w"], ours["head_b"], z, dx


def _multi_args():
    fields, states = _replicas(2, jnp.float32)
    return (*_stack([f[0] for f in fields], torch),
            torch.from_numpy(np.stack([s[0] for s in states])),
            torch.from_numpy(np.stack([s[1] for s in states])))


@pytest.mark.parametrize("which", ["single", "multi"])
def test_rk4_wrappers_reject_what_the_kernel_does_not_take(which):
    """The checks that guard the launch (run here on CPU tensors): a
    padded head on any device, then dtype, contiguity, shape and the
    number of trunk layers.  A width beyond the library's limit is refused
    by the library, on the card (``chip_smoke.py``)."""
    if which == "single":
        public, checked = kernels.fused_rk4_interval, kernels._rk4_kernel
        trunk, head_w, head_b, z, dx = _single_args()
        padded = torch.zeros(HH, C * 128)
    else:
        public, checked = kernels.fused_rk4_interval_multi, kernels._rk4_multi_kernel
        trunk, head_w, head_b, z, dx = _multi_args()
        padded = torch.zeros(2, HH, C * 128)
    with pytest.raises(ValueError, match="unpadded"):
        public(trunk, padded, head_b, z, dx, H, C)
    with pytest.raises(TypeError, match="float32"):
        checked(trunk, head_w, head_b, z.double(), dx, H, C)
    with pytest.raises(ValueError, match="not contiguous"):
        checked(trunk, head_w, head_b, z, dx.transpose(-1, -2).contiguous()
                .transpose(-1, -2), H, C)
    with pytest.raises(ValueError, match="shape"):
        checked(trunk, head_w, head_b, z, dx[..., :2].contiguous(), H, C)
    for bad in ([], trunk[:1] * 5):
        with pytest.raises(ValueError, match="trunk layers"):
            checked(bad, head_w, head_b, z, dx, H, C)


@pytest.mark.parametrize("which", ["single", "multi"])
def test_rk4_ops_have_no_gradient(which):
    """Like the JAX ops (bare ``pallas_call``s), they refuse a gradient
    request instead of returning a result cut from the graph."""
    args = _single_args() if which == "single" else _multi_args()
    op = kernels.fused_rk4_interval if which == "single" else kernels.fused_rk4_interval_multi
    z = args[3].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        op(*args[:3], z, args[4], H, C)
    with torch.no_grad():
        assert op(*args[:3], z, args[4], H, C).shape == args[3].shape


def test_rk4_counters_untouched_on_cpu():
    before = (kernels.fused_rk4_kernel.launches, kernels.fused_rk4_multi_kernel.launches,
              kernels.fused_field_kernel.launches)
    kernels.fused_rk4_interval(*_single_args(), H, C)
    kernels.fused_rk4_interval_multi(*_multi_args(), H, C)
    assert (kernels.fused_rk4_kernel.launches, kernels.fused_rk4_multi_kernel.launches,
            kernels.fused_field_kernel.launches) == before


# ------------------------------------------------------- model chain


def _chain_states(model, coeffs):
    """The interval op chained over a rectilinear model's pieces: even
    pieces with the time channel's head slice (I=1), odd pieces with the
    full head, each with its piece's dX/dt times the knot spacing."""
    with torch.inference_mode():
        spline, h0 = model._setup_h0(coeffs)
        p = model.packed_field()
        grid, dxdt = spline.host_grid(), spline.piece_data()["dxdt"]
        k, hd, states, z = model.rectilinear_time_channel, model.hidden_dim, [h0], h0
        for i in range(len(grid) - 1):
            dx = dxdt[i] * (grid[i + 1] - grid[i])
            if i % 2 == 0:
                z = kernels.fused_rk4_interval(p["trunk"], p["head_w_time"],
                                               p["head_b_time"], z,
                                               dx[:, k:k + 1].contiguous(), hd, 1)
            else:
                z = kernels.fused_rk4_interval(p["trunk"], p["head_w"], p["head_b"], z,
                                               dx, hd, model.input_dim)
            states.append(z)
    return torch.stack(states, dim=-2)


def _hidden_state_models(dtype):
    """A rectilinear model whose output is its hidden state at every knot
    (no readout, unfiltered rows), on both sides."""
    kw = dict(input_dim=C, hidden_dim=H, output_dim=H, hidden_hidden_dim=HH,
              num_layers=2, solver="rk4", interpolation="rectilinear",
              return_sequences=True, apply_final_linear=False,
              return_filtered_rectilinear=False, rectilinear_time_channel=1)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jm.init(jax.random.PRNGKey(6)))
    tm = NeuralCDE(**kw, device="cpu",
                   dtype=torch.float64 if dtype == jnp.float64 else torch.float32)
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 7, C))
    x[..., 1] = np.arange(7)
    x[0, 3, 2] = np.nan
    coeffs = np.array(jax_interp.linear_interpolation_coeffs(jnp.asarray(x),
                                                             rectilinear=1))
    return jm, jparams, tm, coeffs.astype(np.float64 if dtype == jnp.float64
                                          else np.float32)


def test_rk4_chain_matches_neural_cde_states():
    """The port's interval chain equals its own ``NeuralCDE`` hidden
    states (the per-stage solve), in float32 at rtol=1e-5."""
    _, _, tm, coeffs = _hidden_state_models(jnp.float32)
    got = _chain_states(tm, torch.from_numpy(coeffs))
    with torch.inference_mode():
        want = tm(torch.from_numpy(coeffs))
    assert got.shape == want.shape == (5, 13, H)
    close(got, want, rtol=1e-5, atol=1e-6)


def test_rk4_chain_matches_jax_neural_cde_states():
    """The same chain against the JAX model's hidden states, float64."""
    jm, jparams, tm, coeffs = _hidden_state_models(jnp.float64)
    got = _chain_states(tm, torch.from_numpy(coeffs))
    close(got, jm.apply(jparams, jnp.asarray(coeffs)))


# -------------------------------------------------------- experiments


def test_pair_probe_runs_on_cpu(capsys):
    out = pair_probe.main(["--device", "cpu", "--n", "3", "--batch", "4", "--hidden",
                           "8", "--width", "8", "--channels", "3"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["variants"].keys() == out["variants"].keys() == {
        f"{kind}_{path}" for kind in ("even", "odd", "pair")
        for path in ("stages", "interval")}
    for name, row in out["variants"].items():
        assert row["finite"] and row["n"] == 3 and row["wall_us"] > 0
        assert row["device_us"] == "not measured (cpu)"
        assert row["launches"] == {"fused_field": 0, "fused_rk4": 0}
        assert row["unit"] == ("pair" if name.startswith("pair") else "interval")


def test_interleave_experiment_runs_on_cpu(capsys):
    out = interleave_experiment.main(["--device", "cpu", "--n", "3", "--batch", "4",
                                      "--hidden", "8", "--channels", "3"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = printed["variants"]
    assert set(rows) == {"single", "k2_seq", "k2_launches", "k2_interleave", "k4_seq",
                         "k4_launches", "k4_interleave", "win"}
    assert out["parity"] == {"k2": "bit-identical", "k4": "bit-identical"}
    assert rows["k4_seq"]["wall_us"] == pytest.approx(4 * rows["single"]["wall_us"])
    assert rows["win"]["on"] == "wall_us" and rows["win"]["limit"] == 1.6
    assert isinstance(rows["win"]["met"], bool)


def test_chain_times_on_cpu_counts_launches_of_the_whole_chain():
    class Counter:
        launches = 0

    counter = Counter()

    def run_chain(k):
        counter.launches += k

    out = timing.chain_times(run_chain, 5, 1, {"c": counter}, "cpu")
    assert out["n"] == 5 and out["launches"] == {"c": 5}
    assert out["device_us"] == "not measured (cpu)"


def test_new_modules_load_no_jax():
    code = (
        "import sys\n"
        "import online_neural_cdes_tpu_torch.experiments.pair_probe\n"
        "import online_neural_cdes_tpu_torch.experiments.interleave_experiment\n"
        "import online_neural_cdes_tpu_torch.utils.timing\n"
        "import online_neural_cdes_tpu_torch.ops.interpolation\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'online_neural_cdes_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
