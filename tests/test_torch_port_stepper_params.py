"""``OnlineNCDEStepper`` serves one snapshot of the weights (ROADMAP C1).

The stepper takes detached clones of every tensor it reads at
construction, as the JAX stepper holds the one ``params`` tree it was
given: an in-place update of the model afterwards (an optimizer step)
must not reach it, and assigning ``stepper.params`` serves the new
weights.  Held to the bit against a deep copy of the model made at
construction, and against a stepper built fresh, for the fused field and
a plain ``gru`` field; the JAX stepper's reassignment is the reference
for the refresh.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.serving import OnlineNCDEStepper as JaxStepper
from online_neural_cdes_tpu_torch import NeuralCDE, OnlineNCDEStepper, params_from_jax

torch.set_num_threads(1)

C, TICKS = 3, 6
KW = dict(input_dim=C, hidden_dim=6, output_dim=2, hidden_hidden_dim=8, num_layers=2,
          interpolation="rectilinear", solver="rk4", return_sequences=True)


def _observations(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TICKS, 4, C)).astype(np.float32)
    x[:, :, 0] = np.arange(TICKS)[:, None]
    return x


def _rows(stepper, x):
    state = stepper.init(x[0])
    rows = [stepper.readout(state["z"])]
    for k in range(1, len(x)):
        state, y = stepper.step(state, x[k])
        rows.append(y)
    return torch.stack(rows)


def _perturb(model, seed=1):
    """0.05 N(0, 1) on every parameter, in place, as an optimizer step."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen, dtype=p.dtype))


@pytest.mark.parametrize("field", ["original", "gru"])
def test_stepper_serves_its_construction_weights_after_an_in_place_update(field):
    model = NeuralCDE(**KW, vector_field=field, device="cpu")
    stepper = OnlineNCDEStepper(model, device="cpu")
    frozen = copy.deepcopy(model)
    _perturb(model)
    x = _observations()
    got = _rows(stepper, x)
    want = _rows(OnlineNCDEStepper(frozen, device="cpu"), x)
    assert torch.equal(got, want)
    # The update did reach the model: a stepper built now serves other rows.
    fresh = _rows(OnlineNCDEStepper(model, device="cpu"), x)
    assert (fresh - got).abs().max() > 1e-3

    stepper.params = model.state_dict()
    assert torch.equal(_rows(stepper, x), fresh)
    for value in stepper.params.values():
        assert not value.requires_grad
    assert set(stepper.params) == set(model.state_dict())


def test_stepper_params_assignment_checks_keys_and_shapes():
    model = NeuralCDE(**KW, device="cpu")
    stepper = OnlineNCDEStepper(model, device="cpu")
    state = model.state_dict()
    with pytest.raises(ValueError, match="keys"):
        stepper.params = {k: v for k, v in state.items() if k != "final.b"}
    bad = dict(state, **{"final.w": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape"):
        stepper.params = bad
    # A refused assignment leaves the snapshot as it was.
    assert all(torch.equal(stepper.params[k], v) for k, v in state.items())


def test_stepper_params_refresh_matches_jax_reassignment():
    """Both steppers built on weights A, then both given weights B: the
    rows agree at the slice tolerance (f32, rtol 1e-5)."""
    jm = JaxNeuralCDE(**KW)
    params_a = jm.init(jax.random.PRNGKey(0))
    params_b = jm.init(jax.random.PRNGKey(1))
    tm = NeuralCDE(**KW, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, params_a), tm)
    tstep = OnlineNCDEStepper(tm, device="cpu")
    jstep = JaxStepper(jm, params_a)
    other = NeuralCDE(**KW, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, params_b), other)
    tstep.params = other.state_dict()
    jstep.params = params_b
    x = _observations(2)
    jstate = jstep.init(x[0])
    want = [np.asarray(jstep.readout(jstate["z"]))]
    for k in range(1, TICKS):
        jstate, y = jstep.step(jstate, x[k])
        want.append(np.asarray(y))
    np.testing.assert_allclose(_rows(tstep, x).numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-6)
