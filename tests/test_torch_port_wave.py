"""The PyTorch port's waves on the CPU: the fused field's Functions under
``torch.func.vmap`` (of the op and of its gradient) against K separate
calls, the K-replica forms against one replica at a time, ``StackedAdam``
against ``torch.optim.Adam``, the grouping rules against the JAX
package's, ``run_trials_vmapped`` lanes against the port's serial
``train`` (f64, rtol 1e-9) and against the JAX wave from the same initial
weights (rtol 1e-5), and the co-scheduled sweep against
``co_schedule=False`` with the wave-size cap, partial completion and an
isolated wave child.  The waves over the adjoint and the adaptive and
Adams solvers, and what still refuses to wave, are in
``test_torch_port_wave_adjoint.py``."""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.training import harness as jax_harness
from online_neural_cdes_tpu.training import wave as jax_wave
from online_neural_cdes_tpu_torch.data.builders import build_toy_bm
from online_neural_cdes_tpu_torch.ops import kernels
from online_neural_cdes_tpu_torch.training import experiment, harness, sweep, wave
from online_neural_cdes_tpu_torch.training.config import (
    DEFAULT_CONFIG_DIR, parse_configuration_json,
)
from online_neural_cdes_tpu_torch.training.ledger import Ledger

torch.set_num_threads(1)

RTOL = 1e-9          # module tests, f64
SLICE_RTOL = 1e-5    # slice tests, f32 (and the JAX wave's f32 data)
RECURRENT = ("odernn", "gru-d", "gru", "gru-dt", "gru-intensity", "gru-dt-intensity")


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("processed"))
    build_toy_bm(root=root, num_paths=160, n_points=8, seed=0)
    return root


# ------------------------------------------------ the fused field's vmap


def _operands(k, batch=5, hidden=4, hh=6, n_in=3, n_trunk=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    trunk = [{"w": mk(k, hidden if l == 0 else hh, hh), "b": mk(k, hh)}
             for l in range(n_trunk)]
    return trunk, mk(k, hh, n_in * hidden), mk(k, n_in * hidden), mk(k, batch, hidden), \
        mk(k, batch, n_in)


def _flat(trunk, head_w, head_b):
    return (*kernels._flat_trunk(trunk), head_w, head_b)


def _field(flat, z, dx, hidden, n_in):
    *tr, head_w, head_b = flat
    return kernels.fused_matmul_field(kernels._unflat_trunk(tr), head_w, head_b, z, dx,
                                      hidden, n_in)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("batched", ["all", "shared_dx", "shared_weights", "shared_z"])
def test_vmap_of_grad_equals_separate_calls(k, batched):
    """vmap(grad(loss)) through both Functions' vmap rules (the plain K
    versions on the CPU) equals K separate autograd calls, for every
    operand batched or shared (stride 0)."""
    hidden, n_in = 4, 3
    trunk, head_w, head_b, z, dx = _operands(k)
    flat = _flat(trunk, head_w, head_b)
    w_dim = None if batched == "shared_weights" else 0
    if w_dim is None:
        flat = tuple(t[0] for t in flat)
    z_dim = None if batched == "shared_z" else 0
    if z_dim is None:
        z = z[0]
    dx_dim = None if batched == "shared_dx" else 0
    if dx_dim is None:
        dx = dx[0]
    cot = torch.randn(k, 5, hidden, generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)

    def loss(flat, z, dx, c):
        return (_field(flat, z, dx, hidden, n_in) * c).sum()

    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                          in_dims=(w_dim, z_dim, dx_dim, 0))(flat, z, dx, cot)
    for r in range(k):
        pick = lambda t, d: t if d is None else t[r]
        leaves = [pick(t, w_dim).clone().requires_grad_() for t in flat]
        zr = pick(z, z_dim).clone().requires_grad_()
        dxr = pick(dx, dx_dim).clone().requires_grad_()
        want = torch.autograd.grad(loss(tuple(leaves), zr, dxr, cot[r]), (*leaves, zr, dxr))
        for g_stack, w in zip((*got[0], got[1], got[2]), want):
            torch.testing.assert_close(g_stack[r], w, rtol=RTOL, atol=1e-12)

    with torch.no_grad():
        out = torch.func.vmap(functools.partial(_field, hidden=hidden, n_in=n_in),
                              in_dims=(w_dim, z_dim, dx_dim))(flat, z, dx)
    for r in range(k):
        want = _field(tuple(t if w_dim is None else t[r] for t in flat),
                      z if z_dim is None else z[r], dx if dx_dim is None else dx[r],
                      hidden, n_in)
        torch.testing.assert_close(out[r], want, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("batched", ["all", "shared_dx", "shared_weights"])
def test_autograd_through_vmap_equals_separate_calls(batched):
    """The wave's form: plain ``autograd.grad`` of the sum over a vmapped
    loss, through the vmap rule's K-replica Function; a shared operand's
    gradient is the sum of the replicas' (the ``expand``'s backward)."""
    k, hidden, n_in = 3, 4, 3
    trunk, head_w, head_b, z, dx = _operands(k)
    flat = tuple(t.clone() for t in _flat(trunk, head_w, head_b))
    w_dim = None if batched == "shared_weights" else 0
    if w_dim is None:
        flat = tuple(t[0].clone() for t in flat)
    dx_dim = None if batched == "shared_dx" else 0
    if dx_dim is None:
        dx = dx[0].clone()
    leaves = [t.requires_grad_() for t in (*flat, z, dx)]

    def loss(flat, z, dx):
        return (_field(flat, z, dx, hidden, n_in) ** 2).sum()

    losses = torch.func.vmap(loss, in_dims=(w_dim, 0, dx_dim))(tuple(leaves[:-2]), leaves[-2],
                                                              leaves[-1])
    got = torch.autograd.grad(losses.sum(), leaves)
    want = [torch.zeros_like(t) for t in leaves]
    for r in range(k):
        pick = lambda t, d: t if d is None else t[r]
        sub = [pick(t, w_dim).detach().requires_grad_() for t in flat]
        zr, dxr = z[r].detach().requires_grad_(), pick(dx, dx_dim).detach().requires_grad_()
        torch.testing.assert_close(losses[r], loss(tuple(sub), zr, dxr), rtol=RTOL, atol=0)
        grads = torch.autograd.grad(loss(tuple(sub), zr, dxr), (*sub, zr, dxr))
        for i, (g, d) in enumerate(zip(grads, [w_dim] * len(sub) + [0, dx_dim])):
            if d is None:
                want[i] += g
            else:
                want[i][r] = g
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=1e-12)


def test_multi_forms_equal_one_replica_at_a_time():
    """The K-replica forms on stacked operands, dX shared at stride 0, equal
    the single op and its VJP on each replica."""
    k, hidden, n_in = 3, 4, 3
    trunk, head_w, head_b, z, dx = _operands(k)
    shared_dx = dx[0].expand(k, *dx.shape[1:])
    assert shared_dx.stride(0) == 0
    g = torch.randn_like(z)
    out = kernels.fused_matmul_field_multi(trunk, head_w, head_b, z, shared_dx, hidden, n_in)
    dtrunk, dhw, dhb, dz, ddx = kernels.fused_field_backward_multi(
        trunk, head_w, head_b, z, shared_dx, g, hidden, n_in)
    for r in range(k):
        tr, hw, hb = kernels._replica(trunk, head_w, head_b, r)
        torch.testing.assert_close(out[r], kernels._forward_reference(
            tr, hw, hb, z[r], dx[0], hidden, n_in), rtol=RTOL, atol=1e-12)
        want = kernels._backward_reference(tr, hw, hb, z[r], dx[0], g[r], hidden, n_in)
        got = ([{"w": l["w"][r], "b": l["b"][r]} for l in dtrunk], dhw[r], dhb[r], dz[r],
               ddx[r])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=1e-12)


def test_the_kernel_wrappers_refuse_functorch_wrappers():
    """No path hands a torch.func wrapper to a kernel: the check that
    guards every launch refuses one (checked here through the plain
    operands' validation, which the card's launchers share)."""
    trunk, head_w, head_b, z, dx = _operands(1)
    seen = []

    def probe(z):
        with pytest.raises(TypeError, match="torch.func wrapper"):
            kernels._check_operands("probe", [("z", z, tuple(z.shape))], z.device, 1,
                                    (torch.float64,))
        seen.append(True)
        return z

    torch.func.vmap(probe)(z)
    assert seen


# ------------------------------------------------------------ StackedAdam


def test_stacked_adam_is_torch_adam_per_lane():
    """Each lane's trajectory is torch.optim.Adam's with that lane's rates
    (the readout group at lr * final_mult), to the bit in f64."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"field.w": (4, 3), "final.w": (3, 2), "final.b": (2,)}
    k, lrs, mults = 3, [1e-2, 3e-3, 5e-2], [10.0, 1.0, 4.0]
    init = {n: torch.randn(k, *s, generator=gen, dtype=torch.float64) for n, s in shapes.items()}
    grads = [{n: torch.randn(k, *s, generator=gen, dtype=torch.float64)
              for n, s in shapes.items()} for _ in range(4)]
    stacked = {n: v.clone() for n, v in init.items()}
    adam = wave.StackedAdam(stacked)
    for step, gr in enumerate(grads):
        scale = 0.5 ** step
        adam.step(gr, [lr * scale for lr in lrs], [lr * m * scale for lr, m in zip(lrs, mults)])
    for r in range(k):
        params = {n: torch.nn.Parameter(v[r].clone()) for n, v in init.items()}
        opt = torch.optim.Adam([{"params": [params["field.w"]], "lr": lrs[r]},
                                {"params": [params["final.w"], params["final.b"]],
                                 "lr": lrs[r]}], lr=lrs[r])
        for step, gr in enumerate(grads):
            scale = 0.5 ** step
            opt.param_groups[0]["lr"] = lrs[r] * scale
            opt.param_groups[1]["lr"] = lrs[r] * mults[r] * scale
            for n, p in params.items():
                p.grad = gr[n][r].clone()
            opt.step()
        for n, p in params.items():
            assert torch.equal(stacked[n][r], p.detach()), n


# --------------------------------------------------------------- grouping


POINT_GRID = [
    [{"model__hidden_dim": 8, "trainer__lr": 1e-3}, {"model__hidden_dim": 8, "trainer__lr": 1e-2},
     {"model__hidden_dim": 16, "trainer__lr": 1e-3}],
    [{"trainer__lr": 0.1, "trainer__max_epochs": 3}, {"trainer__lr": 0.2},
     {"trainer__final_lr_multiplier": 1.0, "trainer__plateau_factor": 0.5}],
    [{"model__solver": "rk4"}, {"model__solver": "dopri5"}, {"model__solver": "rk4",
                                                             "trainer__early_stop_patience": 2}],
    [],
]


@pytest.mark.parametrize("points", POINT_GRID)
def test_vmappable_groups_match_jax(points):
    assert wave.vmappable_groups(points) == jax_wave.vmappable_groups(points)
    assert wave.WAVEABLE_TRAINER_KEYS == jax_wave.WAVEABLE_TRAINER_KEYS


def _cfg(seed=0, **trainer):
    return {"dataset_name": "ToyBM", "seed": seed, "dataset": {"batch_size": 128},
            "model": {"model_string": "ncde", "hidden_dim": 8},
            "trainer": {"max_epochs": 3, **trainer}}


CONFIG_GRID = [
    [_cfg(0), _cfg(1), _cfg(2)],
    [_cfg(0), _cfg(1, lr=1e-2), _cfg(2, checkpoint_dir="/tmp/x"), _cfg(3, prefetch=2)],
    [_cfg(0), {**_cfg(1), "model": {"model_string": "gru"}}, _cfg(2, loss_str="ce")],
    [_cfg(0, max_epochs=5), _cfg(1, max_epochs=2, plateau_patience=0), _cfg(2, profile_dir="p")],
]


@pytest.mark.parametrize("configs", CONFIG_GRID)
def test_config_wave_groups_match_jax(configs):
    assert wave.config_wave_groups(configs) == jax_wave.config_wave_groups(configs)
    assert wave.WAVE_UNSUPPORTED_TRAINER_KEYS == jax_wave.WAVE_UNSUPPORTED_TRAINER_KEYS


# ---------------------------------------------- lanes against serial runs


def _toy_cfg(model_string, **trainer):
    cfg = parse_configuration_json("toy")[0][0]
    cfg["model"].update(model_string=model_string, hidden_dim=6, hidden_hidden_dim=8,
                        num_layers=1, adjoint=False)
    if model_string != "ncde":
        cfg["dataset"]["interpolation"] = None
    cfg["trainer"].update({"metrics": ["loss", "auc"], "max_epochs": 3, **trainer})
    return cfg


@pytest.fixture
def f64_setup(monkeypatch):
    """Every bundle of the port's experiment layer at float64."""
    monkeypatch.setattr(experiment, "setup_model",
                        functools.partial(harness.setup_model, dtype=torch.float64))


def _assert_lane_is_run(lane, run, rtol, auc_atol):
    for key in ("epochs_run", "best_epoch", "num_params", "nfe_per_epoch", "nfe"):
        assert lane[key] == run[key], key
    assert [h["lr_scale"] for h in lane["history"]] == [h["lr_scale"] for h in run["history"]]
    np.testing.assert_allclose([h["loss"] for h in lane["history"]],
                               [h["loss"] for h in run["history"]], rtol=rtol)
    for split in ("train", "val", "test"):
        np.testing.assert_allclose(lane[f"{split}.loss"], run[f"{split}.loss"], rtol=rtol)
        np.testing.assert_allclose(lane[f"{split}.auc"], run[f"{split}.auc"], atol=auc_atol)


@pytest.mark.parametrize("model_string", ("ncde",) + RECURRENT)
def test_lanes_equal_their_serial_runs(model_string, toy_dataset, f64_setup):
    """Seeds 0 and 1 as one wave, each lane against the port's serial
    ``train`` of its config, in f64; the best weights are each lane's own
    detached snapshot (the test metrics are theirs)."""
    cfgs = [{**_toy_cfg(model_string), "seed": s} for s in (0, 1)]
    lanes = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    for cfg, lane in zip(cfgs, lanes):
        run = experiment.run_experiment(cfg, toy_dataset, device="cpu")
        assert set(lane) == set(run)
        assert lane["memory_usage"] is None
        _assert_lane_is_run(lane, run, RTOL, 1e-12)
        for key, v in run["best_params"].items():
            torch.testing.assert_close(lane["best_params"][key], v, rtol=RTOL, atol=1e-12)


def test_per_lane_trainer_scalars_follow_their_serial_runs(toy_dataset, f64_setup):
    """Lanes that differ in lr, the readout boost, the plateau knobs and
    the epoch budget: each lane's schedule, epochs and losses are its
    serial run's, and a lane frozen early is billed its own epochs."""
    trainers = [dict(lr=1e-3, final_lr_multiplier=10.0, max_epochs=4),
                dict(lr=1e-2, final_lr_multiplier=1.0, max_epochs=4),
                dict(lr=1.0, plateau_patience=0, plateau_factor=0.5, max_epochs=3,
                     early_stop_patience=2)]
    cfgs = [_toy_cfg("ncde", **tr) for tr in trainers]
    lanes = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    for cfg, lane in zip(cfgs, lanes):
        _assert_lane_is_run(lane, experiment.run_experiment(cfg, toy_dataset, device="cpu"),
                            RTOL, 1e-12)
    assert lanes[2]["epochs_run"] <= 3 < lanes[0]["epochs_run"]
    assert lanes[0]["time_per_epoch"] == lanes[2]["time_per_epoch"]
    assert lanes[2]["elapsed_time"] == pytest.approx(
        lanes[2]["time_per_epoch"] * lanes[2]["epochs_run"])
    assert any(h["lr_scale"] < 1.0 for h in lanes[2]["history"])


def _jax_tree_from_port(template, state, dtype):
    """The port's state dict in the JAX bundle's parameter tree."""
    def leaf(path, _):
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        return jnp.asarray(state[key].numpy(), dtype)

    return jax.tree_util.tree_map_with_path(leaf, template)


@pytest.mark.parametrize("model_string", ("ncde",) + RECURRENT)
def test_wave_matches_the_jax_wave(model_string, toy_dataset, f64_setup, monkeypatch):
    """The port's wave (f64) against the JAX package's (f32, its data's
    dtype) from the same initial weights: the JAX bundle's ``init`` returns
    the port's ``init(seed)`` for the seed its key was made from."""
    cfgs = [{**_toy_cfg(model_string), "seed": s} for s in (0, 1)]
    port_bundle, _ = experiment.load_and_setup(cfgs[0], toy_dataset, "cpu")
    real_init = jax_harness.ModelBundle.init

    def init(self, key, dtype=jnp.float32):
        seed = int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])
        return _jax_tree_from_port(real_init(self, key, dtype), port_bundle.init(seed), dtype)

    monkeypatch.setattr(jax_harness.ModelBundle, "init", init)
    want = jax_wave.run_trials_vmapped(cfgs, data_root=toy_dataset)
    got = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    for lane, ref in zip(got, want):
        assert set(lane) == set(ref) | {"best_params"}
        # AUC is a rank statistic: one pair of near-tied scores ranked the
        # other way at f32 round-off moves it by 1 / (positives x
        # negatives), about 5e-6 on the toy's training split.
        _assert_lane_is_run(lane, ref, SLICE_RTOL, 1e-4)


# ------------------------------------------------------------- refusals


def test_mismatched_or_unsupported_configs_raise(toy_dataset):
    cfg = _toy_cfg("ncde")
    other = {**cfg, "model": {**cfg["model"], "hidden_dim": 9}}
    with pytest.raises(ValueError, match="identical"):
        wave.run_trials_vmapped([cfg, other], data_root=toy_dataset, device="cpu")
    prefetching = {**cfg, "trainer": {**cfg["trainer"], "prefetch": 2}}
    with pytest.raises(ValueError, match="wave-incompatible"):
        wave.run_trials_vmapped([prefetching, {**prefetching, "seed": 1}],
                                data_root=toy_dataset, device="cpu")


# ------------------------------------------------------------ the sweep


def _write_config_dir(tmp_path, suites: dict) -> str:
    config_dir = str(tmp_path / "configurations")
    os.makedirs(config_dir, exist_ok=True)
    shutil.copy(os.path.join(DEFAULT_CONFIG_DIR, "dataset.json5"),
                os.path.join(config_dir, "dataset.json5"))
    with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
        json.dump(suites, fh)
    return config_dir


SEEDS_SUITE = {
    "hyperparameters": ["set"], "seed": [0, 1, 2], "dataset_name": ["ToyBM"],
    "dataset": {"interpolation": ["rectilinear"], "batch_size": [128]},
    "model": {"model_string": ["ncde"], "hidden_dim": [8], "hidden_hidden_dim": [16],
              "num_layers": [2], "adjoint": [False], "solver": ["rk4"]},
    "trainer": {"max_epochs": [2]},
}


def _counting(monkeypatch):
    calls = []
    real = wave.run_trials_vmapped

    def counting(cfgs, **kw):
        calls.append(sorted(c["seed"] for c in cfgs))
        return real(cfgs, **kw)

    monkeypatch.setattr(wave, "run_trials_vmapped", counting)
    return calls


def _by_seed(completed):
    return {cfg["seed"]: res for cfg, res in completed}


def _same_results(a, b):
    assert sorted(a) == sorted(b)
    for seed in a:
        assert a[seed]["best_epoch"] == b[seed]["best_epoch"]
        np.testing.assert_allclose([h["loss"] for h in a[seed]["history"]],
                                   [h["loss"] for h in b[seed]["history"]], rtol=SLICE_RTOL)
        for key in ("test.loss", "val.loss"):
            np.testing.assert_allclose(a[seed][key], b[seed][key], rtol=SLICE_RTOL)


def test_sweep_waves_seeds_under_the_cap(toy_dataset, tmp_path, monkeypatch):
    """Three seeds with ``max_wave_size=2``: a wave of two and a single
    config; each completed entry lands in the ledger on its own and a
    re-run skips them all; the results are ``co_schedule=False``'s."""
    config_dir = _write_config_dir(tmp_path, {"toy3": SEEDS_SUITE})
    calls = _counting(monkeypatch)
    ledger_path = str(tmp_path / "ledger.jsonl")
    kw = dict(data_root=toy_dataset, config_dir=config_dir, device="cpu")
    completed = sweep.run("toy3", ledger_path=ledger_path, max_wave_size=2, **kw)
    assert calls == [[0, 1]]
    done = Ledger(ledger_path).query(lambda e: e.get("status") == "completed")
    assert sorted(e["config"]["seed"] for e in done) == [0, 1, 2]
    assert sweep.run("toy3", ledger_path=ledger_path, **kw) == []
    serial = sweep.run("toy3", ledger_path=str(tmp_path / "serial.jsonl"), co_schedule=False,
                       **kw)
    assert calls == [[0, 1]]
    _same_results(_by_seed(completed), _by_seed(serial))


def test_sweep_partial_completion_waves_only_the_rest(toy_dataset, tmp_path, monkeypatch):
    config_dir = _write_config_dir(tmp_path, {"toy3": SEEDS_SUITE})
    ledger_path = str(tmp_path / "ledger.jsonl")
    ledger = Ledger(ledger_path)
    configs, db = parse_configuration_json("toy3", config_dir=config_dir)
    ledger.save_result(next(c for c in configs if c["seed"] == 1), {"test.loss": 0.0},
                       run_name=db)
    calls = _counting(monkeypatch)
    completed = sweep.run("toy3", ledger_path=ledger_path, data_root=toy_dataset,
                          config_dir=config_dir, device="cpu")
    assert calls == [[0, 2]]
    assert sorted(_by_seed(completed)) == [0, 2]


def test_isolated_wave_child_returns_plain_json(toy_dataset, tmp_path):
    """A wave run in a spawned child: every member completes with plain
    JSON numbers and no weights, equal to the in-process wave."""
    config_dir = _write_config_dir(tmp_path, {"toy3": {**SEEDS_SUITE, "seed": [0, 1]}})
    kw = dict(data_root=toy_dataset, config_dir=config_dir, device="cpu")
    isolated = sweep.run("toy3", ledger_path=str(tmp_path / "iso.jsonl"), isolate=True, **kw)
    inproc = sweep.run("toy3", ledger_path=str(tmp_path / "in.jsonl"), **kw)
    for res in _by_seed(isolated).values():
        assert "best_params" not in res
        assert all(type(res[k]) in (int, float) for k in ("test.loss", "num_params"))
    _same_results(_by_seed(isolated), _by_seed(inproc))


def test_a_wave_error_that_is_not_wave_unsupported_propagates(toy_dataset, tmp_path,
                                                              monkeypatch):
    config_dir = _write_config_dir(tmp_path, {"toy3": SEEDS_SUITE})

    def broken(cfgs, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(wave, "run_trials_vmapped", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        sweep.run("toy3", ledger_path=str(tmp_path / "l.jsonl"), data_root=toy_dataset,
                  config_dir=config_dir, device="cpu")
