"""Parity of the PyTorch port's ``NeuralCDE`` against the JAX package, and
the port's import and device guards, on the CPU.

Weights are made by the JAX ``init`` and carried across with
``params_from_jax``; inputs come from numpy with a fixed seed.  Model tests
run in float64 on both sides at rtol=1e-9, atol=1e-10 (same formulas, only
summation order differs).
"""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops.interpolation import (
    linear_interpolation_coeffs as jax_coeffs,
)
from online_neural_cdes_tpu_torch import NeuralCDE, Predictor, OnlineNCDEStepper
from online_neural_cdes_tpu_torch import params_from_jax
from online_neural_cdes_tpu_torch.ops.kernels import fused_field_kernel

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "online_neural_cdes_tpu_torch"
B, L, C, S = 3, 6, 3, 2


def _pair(seed=0, dtype=jnp.float64, **kw):
    kw = dict(dict(input_dim=C, hidden_dim=5, output_dim=2, hidden_hidden_dim=7,
                   num_layers=2, solver="rk4", adjoint=False), **kw)
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jm.init(jax.random.PRNGKey(seed)))
    tm = NeuralCDE(**kw, device="cpu",
                   dtype=torch.float64 if dtype == jnp.float64 else torch.float32)
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    return jm, jparams, tm


def _inputs(seed, rectilinear, time_channel=0, static=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(dtype)
    x[..., time_channel] = np.arange(L)
    x[0, 2, (time_channel + 1) % C] = np.nan
    x[2, 4, :] = np.nan
    x[2, 4, time_channel] = 4.0
    kw = {"rectilinear": time_channel} if rectilinear else {}
    coeffs = np.array(jax_coeffs(jnp.asarray(x), **kw))
    st = rng.normal(size=(B, S)).astype(dtype) if static else None
    if st is None:
        return coeffs, jnp.asarray(coeffs), torch.from_numpy(coeffs)
    return (coeffs, (jnp.asarray(st), jnp.asarray(coeffs)),
            (torch.from_numpy(st), torch.from_numpy(coeffs)))


CASES = {
    "linear_seq": dict(interpolation="linear", return_sequences=True),
    "linear_final": dict(interpolation="linear", return_sequences=False),
    "rect_seq": dict(interpolation="rectilinear", return_sequences=True),
    "rect_final": dict(interpolation="rectilinear", return_sequences=False),
    "rect_unfiltered": dict(interpolation="rectilinear", return_sequences=True,
                            return_filtered_rectilinear=False),
    "rect_time_channel_1": dict(interpolation="rectilinear", return_sequences=True,
                                rectilinear_time_channel=1),
    "static_initial": dict(interpolation="rectilinear", return_sequences=True,
                           static_dim=S),
    "static_no_initial": dict(interpolation="rectilinear", return_sequences=True,
                              static_dim=S, use_initial=False),
    "no_initial": dict(interpolation="linear", return_sequences=True,
                       use_initial=False),
    "one_layer_no_final": dict(interpolation="rectilinear", return_sequences=True,
                               num_layers=1, apply_final_linear=False),
    "three_layers_midpoint": dict(interpolation="rectilinear",
                                  return_sequences=True, num_layers=3,
                                  solver="midpoint"),
    "unfused": dict(interpolation="rectilinear", return_sequences=True,
                    fused=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_neural_cde_matches_jax(case):
    kw = CASES[case]
    jm, jparams, tm = _pair(seed=len(case), **kw)
    _, jin, tin = _inputs(
        len(case), kw["interpolation"] == "rectilinear",
        time_channel=kw.get("rectilinear_time_channel", 0),
        static="static_dim" in kw)
    want, wstats = jm.apply(jparams, jin, return_stats=True)
    with torch.inference_mode():
        got, gstats = tm(tin, return_stats=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert int(gstats["nfe"]) == int(wstats["nfe"])
    assert float(np.std(got.numpy())) > 1e-4  # the dynamics are not trivial


@pytest.mark.parametrize("layout", ["unbatched", "two_batch_dims"])
def test_neural_cde_any_leading_dims_match_jax(layout):
    """States other than (B, H) go through the fused op too, flattened to
    its (B, H) and restored; JAX runs its unfused field for them."""
    kw = CASES["rect_seq"]
    jm, jparams, tm = _pair(seed=4, **kw)
    coeffs, _, _ = _inputs(4, True)
    coeffs = coeffs[0] if layout == "unbatched" else np.stack([coeffs, coeffs[::-1]])
    want = jm.apply(jparams, jnp.asarray(coeffs))
    with torch.inference_mode():
        got = tm(torch.from_numpy(coeffs))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_neural_cde_float32_matches_jax():
    """The slice's own precision: float32 on both sides, at f32 round-off
    over 2L-2 RK intervals."""
    kw = CASES["static_initial"]
    jm, jparams, tm = _pair(seed=3, dtype=jnp.float32, **kw)
    _, jin, tin = _inputs(3, True, static=True, dtype=np.float32)
    with torch.inference_mode():
        got = tm(tin)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(jparams, jin)),
                               rtol=1e-5, atol=1e-6)


def test_neural_cde_packs_time_slice_contiguously():
    _, _, tm = _pair(interpolation="rectilinear", rectilinear_time_channel=2)
    packed = tm.packed_field()
    H = tm.hidden_dim
    assert packed["head_w_time"].is_contiguous()
    assert packed["head_w_time"].shape == (tm.hidden_hidden_dim, H)
    torch.testing.assert_close(packed["head_w_time"], packed["head_w"][:, 2 * H:3 * H])
    torch.testing.assert_close(packed["head_b_time"], packed["head_b"][2 * H:3 * H])


@pytest.mark.parametrize("kw,match", [
    (dict(solver="implicit_adams"), "ROADMAP item 12"),
    (dict(solver="dopri5"), "ROADMAP item 12"),
    (dict(vector_field="gru"), "ROADMAP item 14"),
    (dict(vector_field_type="evaluate"), "ROADMAP item 14"),
])
def test_unported_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        NeuralCDE(input_dim=C, hidden_dim=4, output_dim=1, device="cpu", **kw)


# ------------------------------------------------------------- guards


def test_import_loads_no_jax():
    code = (
        "import sys, online_neural_cdes_tpu_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'online_neural_cdes_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_port_sources_import_no_jax():
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    jax_package = re.compile(
        r"online_neural_cdes_tpu\.|from\s+online_neural_cdes_tpu\s+import"
        r"|import\s+online_neural_cdes_tpu\b(?!_)")
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        text = path.read_text()
        assert not jax_import.search(text), path
        assert not jax_package.search(text), path


def test_entry_points_need_a_device_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeuralCDE(input_dim=C, hidden_dim=4, output_dim=1)
    model = NeuralCDE(input_dim=C, hidden_dim=4, output_dim=1,
                      interpolation="rectilinear", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineNCDEStepper(model)


def test_cpu_forward_launches_no_kernel():
    _, _, tm = _pair(interpolation="rectilinear", return_sequences=True)
    before = fused_field_kernel.launches
    with torch.inference_mode():
        tm(_inputs(1, True)[2])
    assert fused_field_kernel.launches == before
