"""The port's adaptive and Adams solves exported as serving artifacts
against the JAX package, on the CPU in float64.

``export_predictor`` of a ``NeuralCDE`` on each of dopri5 (the
reference's ``min_step=0.5`` preset), bosh3, fehlberg2, adaptive_heun,
dopri8, explicit_adams and implicit_adams traces its solve into the
tensor controller (``ops/solvers.py``: a ``scan`` over the output times of
``while_loop`` attempts; the Adams steps one ``scan``), and
``load_predictor(device="cpu")`` serves it with no model code: the
requests' rows equal the JAX package's live ``Predictor``'s at rtol 1e-9
and the port's live predictor's to the bit, with the live solve's nfe /
accepted / rejected.  The cases cover both ``return_sequences`` values,
statics, Hermite and rectilinear splines, models built with and without
the adjoint (a forward needs none) and ``update_params``.

The tensor controller is held to the JAX package's ``odeint`` (its
``_adaptive_integrate``) at rtol 1e-9 with equal nfe / accepted /
rejected, cased over ``first_step``, ``step_t`` / ``jump_t``, ``max_step``,
an exhausted ``max_num_steps`` (NaN rows on both sides) and DOP853's
landings: run eagerly with the loaded programs' loops
(``serving_export._scan_loop`` / ``_while_loop``) in place of the
higher-order ops, and the ``step_t`` / ``jump_t`` case also through
``torch.export``.
"""

import contextlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import solvers as jax_solvers
from online_neural_cdes_tpu.serving import Predictor as JaxPredictor
from online_neural_cdes_tpu_torch import NeuralCDE, Predictor, params_from_jax
from online_neural_cdes_tpu_torch import serving_export
from online_neural_cdes_tpu_torch.ops import interpolation, solvers
from online_neural_cdes_tpu_torch.serving_export import (
    export_predictor, load_predictor, update_params,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
C, H, HH, S = 3, 4, 6, 2
LENGTH = 8                       # one length bucket
STATS = ("solves", "nfe", "accepted", "rejected")

CASES = {
    "dopri5": dict(interpolation="linear", return_sequences=True, static_dim=S, adjoint=True),
    "bosh3": dict(interpolation="hermite", return_sequences=False),
    "fehlberg2": dict(interpolation="linear", return_sequences=False, update=True),
    "adaptive_heun": dict(interpolation="rectilinear", return_sequences=True),
    "dopri8": dict(interpolation="linear", return_sequences=True),
    "explicit_adams": dict(interpolation="linear", return_sequences=True, static_dim=S),
    "implicit_adams": dict(interpolation="hermite", return_sequences=False, update=True,
                           adjoint=True),
}


def _builders(interp):
    """(the JAX coefficient build in float64, the port's)."""
    if interp == "hermite":
        return (lambda x: jax_interp.hermite_cubic_coefficients_with_backward_differences(
                    x.astype(jnp.float64)),
                interpolation.hermite_cubic_coefficients_with_backward_differences)
    rect = 0 if interp == "rectilinear" else None
    return (lambda x: jax_interp.linear_interpolation_coeffs(x.astype(jnp.float64),
                                                             rectilinear=rect),
            lambda x: interpolation.linear_interpolation_coeffs(x, rectilinear=rect))


def _pair(solver, case, seed):
    kw = dict(input_dim=C, hidden_dim=H, output_dim=2, hidden_hidden_dim=HH, num_layers=1,
              solver=solver, adjoint=case.get("adjoint", False),
              interpolation=case["interpolation"],
              return_sequences=case["return_sequences"], static_dim=case.get("static_dim"))
    jm = JaxNeuralCDE(**kw)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float64), jm.init(jax.random.PRNGKey(seed)))
    tm = NeuralCDE(**kw, device="cpu", dtype=torch.float64)
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    return jm, jparams, tm


def _requests(seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for length in (LENGTH, 5, 7):
        s = rng.normal(size=(length, C)).astype(np.float32)
        s[:, 0] = np.arange(length)
        out.append(s)
    return out, rng.normal(size=(3, S)).astype(np.float32)


def _counted(fn):
    solvers.reset_counts()
    out = fn()
    return out, {k: solvers.COUNTS["forward"][k] for k in STATS}


@pytest.mark.parametrize("solver", sorted(CASES))
def test_exported_solver_serves_the_jax_live_predictor(solver, tmp_path, monkeypatch):
    """Export, load with no model code, serve: JAX's live rows at rtol
    1e-9, the port's live rows to the bit with its solve counts; after
    ``update_params`` (where the case asks) the new weights' rows.  With
    no card visible the artifact loads only where ``device="cpu"`` is
    asked for, as a fixed-grid one."""
    case = CASES[solver]
    jax_fn, port_fn = _builders(case["interpolation"])
    kw = dict(batch_buckets=(4,), length_multiple=LENGTH)
    reqs, static = _requests()
    static = static if case.get("static_dim") else None
    jm, jparams, tm = _pair(solver, case, 0)
    live = Predictor(tm, coeff_fn=port_fn, device="cpu", **kw)
    assert export_predictor(live, str(tmp_path), channels=C, max_length=LENGTH,
                            static_dim=case.get("static_dim")) == 1
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["solve_stats"] is True
    loaded = load_predictor(str(tmp_path), device="cpu")
    got, got_counts = _counted(lambda: loaded.predict(reqs, static=static))
    want, want_counts = _counted(lambda: live.predict(reqs, static=static))
    assert got_counts == want_counts and got_counts["solves"] == 1
    jax_rows = JaxPredictor(jm, jparams, coeff_fn=jax_fn, **kw).predict(reqs, static=static)
    for g, w, j in zip(got, want, jax_rows):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, np.asarray(j), rtol=RTOL, atol=ATOL)
    if case.get("update"):
        jm2, jparams2, tm2 = _pair(solver, case, 1)
        update_params(str(tmp_path), tm2.state_dict())
        rows = load_predictor(str(tmp_path), device="cpu").predict(reqs, static=static)
        jax_rows = JaxPredictor(jm2, jparams2, coeff_fn=jax_fn, **kw).predict(reqs,
                                                                             static=static)
        for g, j in zip(rows, jax_rows):
            np.testing.assert_allclose(g, np.asarray(j), rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_predictor(str(tmp_path))


# ---------------------------------------------------------------- the controller


def _jax_field(t, y, a):
    return jnp.sin(t) * y @ a


def _torch_field(t, y, a):
    return torch.sin(t) * y @ a


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 4)) * 0.5, rng.normal(size=(3, 4)),
            np.array([0.0, 0.3, 1.0, 2.5]))


def _cond(pred, true_fn, false_fn, operands):
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


@contextlib.contextmanager
def _tensor_controller(monkeypatch):
    """The traced controller run eagerly, as a loaded program runs it:
    ``is_exporting()`` true (the one switch), ``scan`` / ``while_loop`` /
    ``cond`` as the loaded programs' Python loops."""
    with monkeypatch.context() as m:
        m.setattr(torch.compiler, "is_exporting", lambda: True)
        m.setattr(sys.modules["torch._higher_order_ops.scan"], "scan",
                  lambda f, init, xs: _python_scan(f, init, xs))
        m.setattr(sys.modules["torch._higher_order_ops.while_loop"], "while_loop",
                  lambda c, b, carried: serving_export._while_loop(c, b, carried, ()))
        m.setattr(torch, "cond", _cond)
        yield


def _python_scan(combine, init, xs):
    flat = (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)

    def fn(*args):
        carry, out = combine(list(args[:len(init)]), args[len(init)]
                             if isinstance(xs, torch.Tensor) else args[len(init):])
        return (*carry, *out)

    res = serving_export._scan_loop(fn, list(init), flat, ())
    return list(res[:len(init)]), list(res[len(init):])


CONTROLLER_CASES = {
    "first_step": ("dopri5", {"first_step": 0.05}),
    "min_step": ("bosh3", {"min_step": 0.2}),
    "max_step": ("fehlberg2", {"max_step": 0.1}),
    "step_jump": ("bosh3", {"step_t": [0.7], "jump_t": [1.5]}),
    "exhausted": ("dopri5", {"max_num_steps": 5}),
    "dop853_landings": ("dop853", {}),
    "heun_jump": ("adaptive_heun", {"jump_t": [0.5, 2.0]}),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_tensor_controller_matches_jax(case, monkeypatch):
    method, opts = CONTROLLER_CASES[case]
    A, y0, t = _problem()
    want, wstats = jax.jit(lambda y, tt, a: jax_solvers.odeint(
        _jax_field, y, tt, a, method=method, rtol=1e-6, atol=1e-8, options=dict(opts),
        return_stats=True))(jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))
    solvers.reset_counts()
    with _tensor_controller(monkeypatch):
        got, gstats = solvers.odeint(_torch_field, torch.from_numpy(y0), t,
                                     torch.from_numpy(A), method=method, rtol=1e-6,
                                     atol=1e-8, options=dict(opts), return_stats=True)
    assert not solvers.COUNTS.get("forward", {}).get("reads")   # no host controller ran
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert {k: int(gstats[k]) for k in wstats} == {k: int(v) for k, v in wstats.items()}
    if case == "exhausted":
        assert np.isnan(got[-1].numpy()).all() and np.isnan(np.asarray(want[-1])).all()


class _Odeint(torch.nn.Module):
    def __init__(self, method, opts, t):
        super().__init__()
        self.method, self.opts, self.t = method, opts, t

    def forward(self, y0, a):
        ys, st = solvers.odeint(_torch_field, y0, self.t, a, method=self.method, rtol=1e-6,
                                atol=1e-8, options=dict(self.opts), return_stats=True)
        return ys, st["nfe"], st["accepted"], st["rejected"]


def test_exported_odeint_takes_the_tensor_controller():
    """``odeint`` under ``torch.export`` (the ``step_t`` / ``jump_t`` case:
    the clamp and the reseed's ``cond``) serves JAX's outputs and counts
    from the exported program, and the live host solve's to the bit."""
    method, opts = CONTROLLER_CASES["step_jump"]
    A, y0, t = _problem(1)
    want, wstats = jax.jit(lambda y, tt, a: jax_solvers.odeint(
        _jax_field, y, tt, a, method=method, rtol=1e-6, atol=1e-8, options=dict(opts),
        return_stats=True))(jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))
    args = (torch.from_numpy(y0), torch.from_numpy(A))
    program = torch.export.export(_Odeint(method, opts, t), args, strict=False)
    ys, nfe, accepted, rejected = serving_export._loop_scans(program.module())(*args)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert [int(nfe), int(accepted), int(rejected)] == [
        int(wstats[k]) for k in ("nfe", "accepted", "rejected")]
    assert torch.equal(ys, _Odeint(method, opts, t)(*args)[0])


def test_the_controller_is_chosen_by_is_exporting_alone(monkeypatch):
    """The live solve runs the host controller (one read an attempt);
    with ``is_exporting()`` true the tensor controller runs, and when it
    fails the solve fails: there is no fallback to the host controller."""
    A, y0, t = _problem()
    solvers.reset_counts()
    solvers.odeint(_torch_field, torch.from_numpy(y0), t, torch.from_numpy(A))
    assert solvers.COUNTS["forward"]["reads"] > 0

    def broken(*args, **kwargs):
        raise RuntimeError("the tensor controller ran")

    monkeypatch.setattr(solvers, "_adaptive_integrate_traced", broken)
    monkeypatch.setattr(solvers, "_adams_scan", broken)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    for method in ("dopri5", "implicit_adams"):
        with pytest.raises(RuntimeError, match="the tensor controller ran"):
            solvers.odeint(_torch_field, torch.from_numpy(y0), np.linspace(0.0, 1.0, 5),
                           torch.from_numpy(A), method=method)
