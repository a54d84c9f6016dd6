"""Waves over the interval adjoint, ``odeint_adjoint`` and the adaptive and
Adams solvers, on the CPU: the solves' vmap rules against K serial solves
of the port and against the JAX package's vmapped ones, and
``run_trials_vmapped`` lanes of those models against their serial runs and
against the JAX wave.

Module tests run in float64 at rtol 1e-9, with weights made by the JAX
``init`` (K keys) and carried across with ``params_from_jax``: the K-lane
interval adjoint (plain and paired) against K serial ``_FixedCDEAdjoint``
backwards and JAX's vmapped ``_fixed_cde_adjoint``; the K-lane search's
accepted grids and counts against each lane's serial ``_Controller`` and
JAX's vmapped solve; ``odeint_adjoint``'s K-lane gradients against JAX's.
Slice tests: the JAX sweep test's toy model (``adjoint: true``, rk4) as a
seed wave against the JAX wave at float32 rtol 1e-5; the adjoint and
adaptive lanes against their serial runs in float64 at rtol 1e-9; a dopri5
wave's NFE within the JAX test's 5% of its sequential run and each lane's
``val.loss`` at float32 rtol 1e-4 (two epochs of Adam); the sweep and the search waving such
groups in one ``run_trials_vmapped`` call (the search's in
``test_torch_port_hyperopt.py``); ``scipy_solver`` refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops import cdeint as jax_cdeint
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import solvers as jax_solvers
from online_neural_cdes_tpu.training import harness as jax_harness
from online_neural_cdes_tpu.training import wave as jax_wave
from online_neural_cdes_tpu_torch import NeuralCDE, params_from_jax
from online_neural_cdes_tpu_torch.ops import cdeint as torch_cdeint
from online_neural_cdes_tpu_torch.ops import solvers
from online_neural_cdes_tpu_torch.training import experiment, sweep, wave
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree
from test_torch_port_wave import (  # noqa: F401  (fixtures)
    _assert_lane_is_run, _by_seed, _jax_tree_from_port, _toy_cfg, _write_config_dir,
    f64_setup, toy_dataset,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11        # module tests and lanes against serial runs, f64
SLICE_RTOL = 1e-5               # against the JAX wave and f32 runs
GRID_RTOL = 1e-6                # accepted step times, K lanes against serial
F32_TRAIN_RTOL = 1e-4           # float32 lanes after two epochs of Adam
K = 3
B, C, H, HH = 5, 3, 4, 6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=err_msg)


# -------------------------------------------------- the models' K lanes


def _lanes(**kw):
    """A JAX model, its K inits stacked, and the port's model with each
    lane's weights (f64)."""
    kw = dict(dict(input_dim=C, hidden_dim=H, output_dim=1, hidden_hidden_dim=HH,
                   num_layers=2), **kw)
    jm = JaxNeuralCDE(**kw)
    inits = [jax.tree.map(lambda a: a.astype(jnp.float64), jm.init(jax.random.PRNGKey(s)))
             for s in range(K)]
    tm = NeuralCDE(**kw, device="cpu", dtype=torch.float64)
    states = []
    for p in inits:
        params_from_jax(jax.tree.map(np.asarray, p), tm)
        states.append({n: v.detach().clone() for n, v in tm.named_parameters()})
    return jm, jax.tree.map(lambda *xs: jnp.stack(xs), *inits), tm, states


def _coeffs(interp, L, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C))
    x[..., 0] = np.arange(L)
    if interp == "hermite":
        c = jax_interp.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x))
    elif interp == "rectilinear":
        c = jax_interp.linear_interpolation_coeffs(jnp.asarray(x), rectilinear=0)
    else:
        c = jax_interp.linear_interpolation_coeffs(jnp.asarray(x))
    c = np.array(c)
    return jnp.asarray(c), torch.from_numpy(c)


def _wave_grads(tm, states, tc):
    """Each lane's loss and gradients through ``torch.func.vmap`` of the
    loss and plain autograd of the losses' sum (the wave's step)."""
    names = [n for n, _ in tm.named_parameters()]
    stacked = {n: torch.stack([s[n] for s in states]).requires_grad_() for n in names}
    losses = torch.func.vmap(
        lambda p: torch.sum(torch.func.functional_call(tm, p, (tc,)) ** 2))(stacked)
    grads = torch.autograd.grad(losses.sum(), list(stacked.values()))
    return losses.detach(), dict(zip(names, grads))


def _serial_grads(tm, state, tc):
    params = {n: v.clone().requires_grad_() for n, v in state.items()}
    loss = torch.sum(torch.func.functional_call(tm, params, (tc,)) ** 2)
    return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _spy(monkeypatch, cls, name):
    """Count the calls of a Function's static method."""
    calls = []
    real = getattr(cls, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(cls, name, staticmethod(counted))
    return calls


@pytest.mark.parametrize("interp", ["linear", "rectilinear"])
def test_lane_interval_adjoint_matches_serial_backwards_and_jax(interp, monkeypatch):
    """K lanes through the interval adjoint's vmap rule (the paired scan
    for the rectilinear model): each lane's loss and gradients against its
    serial ``_FixedCDEAdjoint`` backward and against ``jax.vmap`` of
    ``jax.grad`` through JAX's ``_fixed_cde_adjoint``."""
    jm, jstack, tm, states = _lanes(interpolation=interp, return_sequences=True,
                                    adjoint=True)
    jc, tc = _coeffs(interp, 7)
    backwards = _spy(monkeypatch, torch_cdeint._FixedCDEAdjointLanes, "backward")
    losses, grads = _wave_grads(tm, states, tc)
    assert backwards == [1]
    want = jax.vmap(jax.value_and_grad(lambda p: jnp.sum(jm.apply(p, jc) ** 2)))(jstack)
    want_grads = flatten_tree(jax.tree.map(np.asarray, want[1]))
    close(losses, want[0])
    for name, g in grads.items():
        close(g, want_grads[name], err_msg=name)
    serial = _spy(monkeypatch, torch_cdeint._FixedCDEAdjoint if interp == "linear"
                  else torch_cdeint._FixedCDEAdjointPaired, "backward")
    for j, state in enumerate(states):
        loss, g_j = _serial_grads(tm, state, tc)
        close(losses[j], loss)
        for name, g in g_j.items():
            close(grads[name][j], g, err_msg=name)
    assert len(serial) == K


def test_lane_interval_adjoint_launches_the_multi_field_only(monkeypatch):
    """The K-lane forward scan and every reverse stage call the fused
    field's K-replica forms: 4 forward calls an RK4 interval forward, and
    4 forward and 4 backward calls each reverse interval."""
    from online_neural_cdes_tpu_torch.ops import kernels

    calls = {"forward": 0, "backward": 0, "multi_forward": 0, "multi_backward": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    for key, name in (("forward", "_forward"), ("backward", "_backward"),
                      ("multi_forward", "fused_matmul_field_multi"),
                      ("multi_backward", "fused_field_backward_multi")):
        monkeypatch.setattr(kernels, name, counting(key, getattr(kernels, name)))
    _, _, tm, states = _lanes(interpolation="linear", return_sequences=True, adjoint=True)
    _, tc = _coeffs("linear", 7)
    _wave_grads(tm, states, tc)
    intervals = 6
    assert calls == {"forward": 0, "backward": 0, "multi_forward": 8 * intervals,
                     "multi_backward": 4 * intervals}


# ------------------------------------------------ the K-lane controller


def _jax_field(t, y, a):
    return jnp.tanh(y @ a) + 0.1 * jnp.sin(t)


def _torch_field(t, y, a):
    return torch.tanh(y @ a) + 0.1 * torch.sin(t)


def _linear_lanes(seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, 4, 4)) * np.asarray([0.6, 1.1, 1.7])[:, None, None]
    y0 = rng.normal(size=(K, 3, 4))
    t = np.linspace(0.0, 2.0, 6)
    return A, y0, t


def _record_steps(monkeypatch):
    """Every accepted step of the serial controllers and of the K-lane
    controller, in order: ``serial`` a list of steps, ``lanes`` one list a
    lane."""
    seen = {"serial": [], "lanes": [[] for _ in range(K)]}
    real_attempt, real_lanes = solvers._Controller.attempt, solvers._LaneController.attempt

    def attempt(self, s):
        new, step = real_attempt(self, s)
        if step is not None:
            seen["serial"].append(tuple(float(v) for v in step[:3]))
        return new, step

    def lanes(self, st, active, fits=False):
        steps, fit = real_lanes(self, st, active, fits)
        for j, step in enumerate(steps):
            if step is not None:
                seen["lanes"][j].append(tuple(float(v) for v in step[:3]))
        return steps, fit

    monkeypatch.setattr(solvers._Controller, "attempt", attempt)
    monkeypatch.setattr(solvers._LaneController, "attempt", lanes)
    return seen


LANE_METHODS = ["dopri5", "bosh3", "adaptive_heun", "fehlberg2", "dopri8"]


@pytest.mark.parametrize("differentiable", [True, False])
@pytest.mark.parametrize("method", LANE_METHODS)
def test_lane_search_grids_match_serial_controllers_and_jax(method, differentiable,
                                                            monkeypatch):
    """K lanes (each its own field matrix and start) of one adaptive solve
    under ``torch.func.vmap``: each lane's accepted grid is its serial
    controller's (the same steps, their times at rtol 1e-6), its nfe /
    accepted / rejected are the serial solve's and JAX's vmapped solve's,
    and its outputs and gradients (the replay's, or autograd through the
    plain solve) are both."""
    A, y0, t = _linear_lanes()
    opts = {"differentiable": True} if differentiable else {}
    w = np.random.default_rng(4).normal(size=(len(t), 3, 4))

    def jsolve(y, a):
        return jax_solvers.odeint(_jax_field, y, jnp.asarray(t), a, method=method,
                                  rtol=1e-6, atol=1e-8, options=dict(opts), return_stats=True)

    def jloss(y, a):
        ys, stats = jsolve(y, a)
        return jnp.nansum(ys * w), (ys, stats)

    if differentiable:
        # Under differentiation JAX's solve records its steps (its fwd), as
        # the port's replay does, with the same step budget.
        (_, (wys, wstats)), wgrads = jax.vmap(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(y0), jnp.asarray(A))
    else:
        (wys, wstats), wgrads = jax.vmap(jsolve)(jnp.asarray(y0), jnp.asarray(A)), None
    seen = _record_steps(monkeypatch)
    ty, tA = torch.from_numpy(y0).requires_grad_(), torch.from_numpy(A).requires_grad_()

    def tsolve(y, a):
        return solvers.odeint(_torch_field, y, torch.from_numpy(t), a, method=method,
                              rtol=1e-6, atol=1e-8, options=dict(opts), return_stats=True)

    solvers.reset_counts()
    gys, gstats = torch.func.vmap(tsolve)(ty, tA)
    assert solvers.COUNTS["forward"]["lane_solves"] == 1
    close(gys, wys)
    for key in ("nfe", "accepted", "rejected"):
        assert gstats[key].tolist() == np.asarray(wstats[key]).tolist(), key
    gy, gA = torch.autograd.grad(torch.nansum(gys * torch.from_numpy(w)), (ty, tA),
                                 allow_unused=True)
    gA = torch.zeros_like(tA) if gA is None else gA      # every output past the budget
    if wgrads is not None:
        close(gy, wgrads[0], rtol=1e-8)
        close(gA, wgrads[1], rtol=1e-8)
    for j in range(K):
        seen["serial"].clear()
        yj, Aj = (torch.from_numpy(x[j]).requires_grad_() for x in (y0, A))
        sy, sstats = tsolve(yj, Aj)
        # The same steps; their times agree to the round-off of the field
        # evaluated under vmap (a batched matmul, not the serial one), which
        # the error estimate's cancellation magnifies (most for DOP853).
        assert len(seen["lanes"][j]) == len(seen["serial"]), j
        close(np.asarray(seen["lanes"][j]), np.asarray(seen["serial"]), rtol=GRID_RTOL,
              err_msg=str(j))
        for key in ("nfe", "accepted", "rejected"):
            assert int(gstats[key][j]) == int(sstats[key]), key
        close(gys[j], sy)
        want = torch.autograd.grad(torch.nansum(sy * torch.from_numpy(w)), (yj, Aj),
                                   allow_unused=True)
        want = [torch.zeros_like(x) if g is None else g for g, x in zip(want, (yj, Aj))]
        close(gy[j], want[0], rtol=1e-8)
        close(gA[j], want[1], rtol=1e-8)


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams"])
def test_lane_adams_solves_match_serial_and_jax(method):
    """Adams under ``torch.func.vmap``: each lane's corrector tests its own
    convergence; outputs against the serial solves and JAX's vmapped."""
    A, y0, _ = _linear_lanes(5)
    t = np.linspace(0.0, 2.0, 5)

    def jsolve(y, a):
        return jax_solvers.odeint(_jax_field, y, jnp.asarray(t), a, method=method,
                                  rtol=1e-3, atol=1e-4, options={"step_size": 0.25})

    want = jax.vmap(jsolve)(jnp.asarray(y0), jnp.asarray(A))

    def tsolve(y, a):
        return solvers.odeint(_torch_field, y, torch.from_numpy(t), a, method=method,
                              rtol=1e-3, atol=1e-4, options={"step_size": 0.25})

    got = torch.func.vmap(tsolve)(torch.from_numpy(y0), torch.from_numpy(A))
    close(got, want)
    for j in range(K):
        close(got[j], tsolve(torch.from_numpy(y0[j]), torch.from_numpy(A[j])))


@pytest.mark.parametrize("adjoint_options", [None, {"norm": "seminorm"},
                                             {"method": "bosh3", "rtol": 1e-8},
                                             {"method": "rk4", "substeps": 4}])
def test_lane_odeint_adjoint_matches_jax(adjoint_options, monkeypatch):
    """K lanes of ``odeint_adjoint`` (through its vmap rule's K-lane
    Function): y0 and the field matrix per lane, the output times shared
    (their gradient summed over the lanes), against ``jax.vmap`` of
    ``jax.grad`` and against K serial adjoints."""
    A, y0, t = _linear_lanes(7)
    w = np.random.default_rng(7).normal(size=(len(t), 3, 4))

    def jloss(y, tt, a):
        ys = jax_cdeint.odeint_adjoint(_jax_field, y, tt, a, rtol=1e-7, atol=1e-9,
                                       adjoint_options=adjoint_options)
        return jnp.sum(ys * w)

    wl, wg = jax.vmap(jax.value_and_grad(jloss, argnums=(0, 1, 2)),
                      in_axes=(0, None, 0))(jnp.asarray(y0), jnp.asarray(t), jnp.asarray(A))
    ty, tt, tA = (torch.from_numpy(a).requires_grad_() for a in (y0, t, A))

    def tloss(y, tt, a):
        ys = torch_cdeint.odeint_adjoint(_torch_field, y, tt, a, rtol=1e-7, atol=1e-9,
                                         adjoint_options=adjoint_options)
        return torch.sum(ys * torch.from_numpy(w))

    backwards = _spy(monkeypatch, torch_cdeint._OdeintAdjointLanes, "backward")
    solvers.reset_counts()
    losses = torch.func.vmap(tloss, in_dims=(0, None, 0))(ty, tt, tA)
    gy, gt, gA = torch.autograd.grad(losses.sum(), (ty, tt, tA))
    assert backwards == [1]
    if (adjoint_options or {}).get("method") != "rk4":    # a fixed grid takes no controller
        assert solvers.COUNTS["reverse"]["lane_solves"] == len(t) - 1
    close(losses, wl)
    close(gy, wg[0], rtol=1e-8)
    close(gA, wg[2], rtol=1e-8)
    close(gt, np.asarray(wg[1]).sum(0), rtol=1e-8)


# ------------------------------------------------------------ the waves


WAVE_VARIANTS = {
    "adjoint-rectilinear": dict(adjoint=True),
    "adjoint-linear": dict(adjoint=True, interpolation="linear"),
    "dopri5-hermite": dict(solver="dopri5", interpolation="hermite"),
    "dopri5-adjoint": dict(solver="dopri5", interpolation="hermite", adjoint=True),
    "bosh3-hermite": dict(solver="bosh3", interpolation="hermite"),
    "implicit-adams": dict(solver="implicit_adams", interpolation="linear"),
    "odernn-dopri5": dict(model="odernn", solver="dopri5"),
    "odernn-bosh3": dict(model="odernn", solver="bosh3"),
}


def _variant_cfg(variant, **trainer):
    spec = dict(WAVE_VARIANTS[variant])
    cfg = _toy_cfg(spec.pop("model", "ncde"), **trainer)
    interpolation = spec.pop("interpolation", None)
    if interpolation is not None:
        cfg["dataset"]["interpolation"] = interpolation
    cfg["model"].update(spec)
    return cfg


@pytest.mark.parametrize("variant", sorted(WAVE_VARIANTS))
def test_adjoint_and_adaptive_lanes_equal_their_serial_runs(variant, toy_dataset, f64_setup):
    """Seeds 0, 1 and 2 as one wave, each lane against the port's serial
    ``train`` of its config, in float64 (an adaptive lane's NFE is its own
    run's, re-probed every epoch)."""
    cfgs = [{**_variant_cfg(variant, max_epochs=2), "seed": s} for s in range(K)]
    lanes = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    for cfg, lane in zip(cfgs, lanes):
        run = experiment.run_experiment(cfg, toy_dataset, device="cpu")
        _assert_lane_is_run(lane, run, RTOL, 1e-12)
        for key, v in run["best_params"].items():
            torch.testing.assert_close(lane["best_params"][key], v, rtol=RTOL, atol=1e-12)
    if "dopri5" in variant and "odernn" not in variant:
        assert len({lane["nfe"] for lane in lanes}) > 1     # each lane its own


JAX_TOY_MODEL = {"hidden_dim": 8, "hidden_hidden_dim": 16, "num_layers": 2, "adjoint": True,
                 "solver": "rk4"}


def _jax_init_from_port(monkeypatch, port_bundle):
    real_init = jax_harness.ModelBundle.init

    def init(self, key, dtype=jnp.float32):
        seed = int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])
        return _jax_tree_from_port(real_init(self, key, dtype), port_bundle.init(seed), dtype)

    monkeypatch.setattr(jax_harness.ModelBundle, "init", init)


def test_toy_adjoint_wave_matches_the_jax_wave(toy_dataset, monkeypatch):
    """The JAX sweep test's toy model (``adjoint: true``, rk4, the
    rectilinear paired adjoint) as a seed wave of three, in float32, against
    the JAX wave from the same initial weights."""
    base = _toy_cfg("ncde")
    base["model"].update(JAX_TOY_MODEL)
    cfgs = [{**base, "seed": s} for s in range(K)]
    port_bundle, _ = experiment.load_and_setup(cfgs[0], toy_dataset, "cpu")
    _jax_init_from_port(monkeypatch, port_bundle)
    want = jax_wave.run_trials_vmapped(cfgs, data_root=toy_dataset)
    got = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    for lane, ref in zip(got, want):
        _assert_lane_is_run(lane, ref, SLICE_RTOL, 1e-4)


def test_dopri5_wave_nfe_tracks_sequential(toy_dataset):
    """The JAX test's contract (``tests/test_harness.py``): a dopri5 wave
    of two learning rates re-probes each lane's NFE every epoch, within 5%
    of its sequential run; each lane's ``val.loss`` is its serial run's
    (float32: the lanes' batched field rounds otherwise than the serial
    one, and Adam magnifies a near-zero gradient's round-off to ~lr, so
    two epochs hold it at rtol 1e-4; the float64 lanes are held at 1e-9
    above)."""
    base = _variant_cfg("dopri5-hermite", max_epochs=2)
    cfgs = [{**base, "trainer": {**base["trainer"], "lr": lr}} for lr in (1e-3, 1e-2)]
    lanes = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    for cfg, lane in zip(cfgs, lanes):
        assert lane["nfe_per_epoch"] is not None and lane["nfe_per_epoch"] > 0
        seq = experiment.run_experiment(cfg, toy_dataset, device="cpu")
        assert abs(lane["nfe"] - seq["nfe"]) / seq["nfe"] < 0.05, (lane["nfe"], seq["nfe"])
        np.testing.assert_allclose(lane["val.loss"], seq["val.loss"], rtol=F32_TRAIN_RTOL)


# ------------------------------------------------------ sweep, hyperopt


def _suite(model, **dataset):
    return {"hyperparameters": ["set"], "seed": [0, 1], "dataset_name": ["ToyBM"],
            "dataset": {"interpolation": ["rectilinear"], "batch_size": [128],
                        **{k: [v] for k, v in dataset.items()}},
            "model": {"model_string": ["ncde"], "hidden_dim": [8], "hidden_hidden_dim": [16],
                      "num_layers": [2], **{k: [v] for k, v in model.items()}},
            "trainer": {"max_epochs": [2]}}


SWEEP_GROUPS = {
    "adjoint": _suite({"adjoint": True, "solver": "rk4"}),
    "hermite-dopri5": _suite({"adjoint": False, "solver": "dopri5"}, interpolation="hermite"),
}


@pytest.mark.parametrize("group", sorted(SWEEP_GROUPS))
def test_an_adjoint_or_adaptive_seed_group_waves(group, toy_dataset, tmp_path, monkeypatch):
    """An adjoint seed group and a ``hermite-dopri5``-style one each train
    as one ``run_trials_vmapped`` call, equal to their serial runs."""
    config_dir = _write_config_dir(tmp_path, {group: SWEEP_GROUPS[group]})
    calls = []
    real = wave.run_trials_vmapped

    def counting(cfgs, **kw):
        calls.append(sorted(c["seed"] for c in cfgs))
        return real(cfgs, **kw)

    monkeypatch.setattr(wave, "run_trials_vmapped", counting)
    kw = dict(data_root=toy_dataset, config_dir=config_dir, device="cpu")
    completed = sweep.run(group, ledger_path=str(tmp_path / "l.jsonl"), **kw)
    assert calls == [[0, 1]]
    serial = sweep.run(group, ledger_path=str(tmp_path / "s.jsonl"), co_schedule=False, **kw)
    assert calls == [[0, 1]]
    for seed, res in _by_seed(serial).items():
        got = _by_seed(completed)[seed]
        for key in ("test.loss", "val.loss"):
            np.testing.assert_allclose(got[key], res[key], rtol=SLICE_RTOL)


# ------------------------------------------------------------- refusals


def test_scipy_solver_refuses_to_wave_and_says_why(toy_dataset):
    """``scipy_solver`` is a host callback the JAX package cannot trace
    under ``jax.vmap`` either: ``WaveUnsupported`` says so."""
    cfg = _toy_cfg("ncde")
    cfg["model"].update(solver="scipy_solver", adjoint=False)
    with pytest.raises(wave.WaveUnsupported, match="host callback.*cannot trace"):
        wave.run_trials_vmapped([cfg, {**cfg, "seed": 1}], data_root=toy_dataset,
                                device="cpu")
    assert issubclass(wave.WaveUnsupported, ValueError)


def test_a_scipy_seed_group_runs_its_members_serially(toy_dataset, tmp_path, monkeypatch):
    """The sweep's serial path stays for a group that cannot wave: the
    wave refuses with ``WaveUnsupported`` and each member goes to the
    serial runner (stubbed here: a ``scipy_solver`` model has no gradient
    to train with, in either package)."""
    suite = _suite({"adjoint": False, "solver": "scipy_solver"}, interpolation="hermite")
    config_dir = _write_config_dir(tmp_path, {"scipy": suite})
    waves, serial = [], []
    real = wave.run_trials_vmapped

    def counting(cfgs, **kw):
        waves.append(sorted(c["seed"] for c in cfgs))
        return real(cfgs, **kw)

    def one(cfg, **kw):
        serial.append(cfg["seed"])
        return {"test.loss": float(cfg["seed"]), "val.loss": 0.5}

    monkeypatch.setattr(wave, "run_trials_vmapped", counting)
    monkeypatch.setattr(sweep, "run_experiment", one)
    completed = sweep.run("scipy", ledger_path=str(tmp_path / "l.jsonl"), data_root=toy_dataset,
                          config_dir=config_dir, device="cpu")
    assert waves == [[0, 1]] and serial == [0, 1]
    assert {seed: res["test.loss"] for seed, res in _by_seed(completed).items()} == {
        0: 0.0, 1: 1.0}
