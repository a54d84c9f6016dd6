"""Parity of the PyTorch port's experiment harness against the JAX
package, on the CPU: the toy builder's npz files (bit for bit),
``setup_model`` over the nine model strings (batch preparation, forward
and parameter count at f64), ``train`` from the JAX trainer's initial
weights at the trainer oracle's two shapes (epochs, best epoch and the
plateau schedule exactly, the validation losses and test metrics at f64
round-off), the best weights as a snapshot, seeds, resume, the epoch-fused,
accumulating and prefetching trainers, profiling, bf16 compute, and the
refusals."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.data import builders as jax_builders
from online_neural_cdes_tpu.data.loader import LoadedData as JaxLoadedData
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.training import harness as jax_harness
from online_neural_cdes_tpu_torch import params_from_jax
from online_neural_cdes_tpu_torch.data import builders
from online_neural_cdes_tpu_torch.data.loader import Batches, LoadedData
from online_neural_cdes_tpu_torch.training import harness
from online_neural_cdes_tpu_torch.training.config import parse_configuration_json
from online_neural_cdes_tpu_torch.training.experiment import run_experiment

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(jax_params, bundle):
    """A JAX parameter tree as a state dict of the port bundle's model."""
    model = bundle.make_model(torch.Generator().manual_seed(0))
    return params_from_jax(_np_tree(jax_params), model).state_dict()


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("processed"))
    builders.build_toy_bm(root=root, num_paths=160, n_points=8, seed=0)
    return root


# -------------------------------------------------------------- builder


def _same_bits(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == object:
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(np.asarray(x), np.asarray(y), f"{what}[{i}]")
    else:
        assert a.tobytes() == b.tobytes(), what


def test_toy_builder_writes_the_jax_files(tmp_path, toy_dataset):
    jax_builders.build_toy_bm(root=str(tmp_path), num_paths=160, n_points=8, seed=0)
    for name in ("improved-neural-cdes_data.npz", "improved-neural-cdes_data_test.npz"):
        with np.load(os.path.join(tmp_path, "Toy/BM", name), allow_pickle=True) as want, \
                np.load(os.path.join(toy_dataset, "Toy/BM", name), allow_pickle=True) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                _same_bits(got[key], want[key], f"{name}:{key}")


@pytest.mark.parametrize("name", ["character_trajectories", "speech_commands"])
def test_raw_builders_name_their_roadmap_item(name, tmp_path):
    """Item 16b is ported (tests/test_torch_port_raw_builders.py): without
    raw files each builder raises the JAX builder's FileNotFoundError."""
    raw = str(tmp_path / "absent")
    with pytest.raises(FileNotFoundError) as got:
        builders.BUILDERS[name](root=str(tmp_path), raw_dir=raw)
    with pytest.raises(FileNotFoundError) as want:
        jax_builders.BUILDERS[name](root=str(tmp_path), raw_dir=raw)
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError, match="TSR raw file"):
        builders.build_tsr("BeijingPM10", root=str(tmp_path), raw_dir=raw)
    assert set(builders.BUILDERS) == set(jax_builders.BUILDERS)


# ---------------------------------------------------------- setup_model

B, L, C, H, HH, S = 4, 7, 3, 5, 6, 2


def _raw_series(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, L, C))
    x[..., 0] = np.arange(L)
    x[0, 2:4, 1] = np.nan
    x[1, :2, 2] = np.nan
    x[2, 3, 1:] = np.nan
    return x


@pytest.mark.parametrize("model_string", jax_harness.MODEL_STRINGS)
def test_setup_model_matches_jax(model_string):
    """Each model string at f64: the batch preparation (with the training
    set's feature means), the forward at JAX's initial weights, and the
    parameter count."""
    online = model_string != "ncde-attention"
    train_raw = _raw_series(1, n=6)
    kw = dict(input_dim=C, output_dim=2, static_dim=S, hidden_dim=H, hidden_hidden_dim=HH,
              num_layers=2, interpolation="linear", adjoint=False, return_sequences=online)
    jax_train = JaxLoadedData(None, train_raw, None, C, 2, S, "linear", online)
    port_train = LoadedData(None, train_raw, None, C, 2, S, "linear", online)
    jb = jax_harness.setup_model(model_string, train_data=jax_train, **kw)
    tb = harness.setup_model(model_string, train_data=port_train, device="cpu",
                             dtype=torch.float64, **kw)
    assert tb.model_string == model_string and tb.device == torch.device("cpu")
    jp = jax.tree.map(lambda a: a.astype(jnp.float64), jb.init(jax.random.PRNGKey(3)))
    params = _port_params(jp, tb)
    assert sum(t.numel() for t in params.values()) == jax_harness.count_params(jp)

    x = _raw_series(2)
    static = np.random.default_rng(2).normal(size=(B, S))
    if model_string.startswith("ncde"):
        raw = np.asarray(jax_interp.linear_interpolation_coeffs(jnp.asarray(x)))
    else:
        raw = x
    jin = jb.prepare_batch((jnp.asarray(static), jnp.asarray(raw)))
    tin = tb.prepare_batch((static, raw))
    np.testing.assert_allclose(
        np.asarray(tin[1] if isinstance(tin, tuple) else tin),
        np.asarray(jin[1] if isinstance(jin, tuple) else jin), rtol=0, atol=0)
    want = np.asarray(jb.apply_fn(jp, jin))
    got = tb.apply_fn(params, tin)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if tb.feature_means is not None:
        np.testing.assert_array_equal(tb.feature_means, jb.feature_means)

    model = tb.model
    model.load_state_dict(params)
    np.testing.assert_allclose(model(tin).detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_setup_model_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="one-shot"):
        harness.setup_model("ncde-attention", input_dim=3, output_dim=1,
                            return_sequences=True, device="cpu")
    with pytest.raises(ValueError, match="unknown model_string"):
        harness.setup_model("lstm", input_dim=3, output_dim=1, device="cpu")


def test_concat_ragged_time_matches_jax():
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=(2, n, 1)) for n in (4, 6, 5)]
    np.testing.assert_array_equal(harness._concat_ragged_time(chunks),
                                  jax_harness._concat_ragged_time(chunks))


# -------------------------------------------------- train against JAX


def _dataset(rng, n, length, channels, online):
    """The trainer oracle's synthetic series with a learnable-but-noisy
    binary label (tests/test_trainer_oracle.py)."""
    x = rng.normal(size=(n, length, channels)) * 0.5
    x[:, :, 0] = np.linspace(0.0, 1.0, length)
    x[:, :, 1:] = np.cumsum(x[:, :, 1:], axis=1) * 0.5
    if online:
        y = (np.cumsum(x[:, :, 1], axis=1) > 0).astype(np.float64)
        finish = rng.integers(length // 2, length + 1, size=n)
        for i, f in enumerate(finish):
            y[i, f:] = np.nan
    else:
        logits = x[:, -1, 1] + 0.5 * x[:, length // 2, 2]
        y = (logits + rng.normal(size=n) * 0.3 > 0).astype(np.float64)
    return x, y


ORACLE_SHAPES = {
    "oneshot": dict(online=False, n_train=24, n_val=12, n_test=12, L=8, C=3, H=6, HH=8,
                    NL=2, lr=0.01, batch_size=12, plateau_patience=2,
                    early_stop_patience=8, max_epochs=40, seed=7),
    "online": dict(online=True, n_train=18, n_val=9, n_test=9, L=10, C=3, H=6, HH=8,
                   NL=2, lr=0.01, batch_size=9, plateau_patience=2,
                   early_stop_patience=6, max_epochs=25, seed=3),
}


def _run_both(shape):
    """The JAX trainer and the port's over the same f64 natural cubic
    coefficients, from JAX's initial weights."""
    p = ORACLE_SHAPES[shape]
    online = p["online"]
    rng = np.random.default_rng(p["seed"])
    n = p["n_train"] + p["n_val"] + p["n_test"]
    x, y = _dataset(rng, n, p["L"], p["C"], online)
    coeffs = np.asarray(jax_interp.natural_cubic_coeffs(jnp.asarray(x)))
    cuts = np.cumsum([0, p["n_train"], p["n_val"], p["n_test"]])
    kw = dict(input_dim=p["C"], output_dim=1, hidden_dim=p["H"], hidden_hidden_dim=p["HH"],
              num_layers=p["NL"], interpolation="cubic", adjoint=False, solver="rk4",
              return_sequences=online)
    trainer = dict(loss_str="bce", metrics=("loss", "auc"), val_metric_to_monitor="loss",
                   lr=p["lr"], final_lr_multiplier=10.0, max_epochs=p["max_epochs"],
                   batch_size=p["batch_size"], plateau_patience=p["plateau_patience"],
                   early_stop_patience=p["early_stop_patience"])

    def splits(cls):
        return [cls(None, coeffs[a:b], y[a:b], p["C"], 1, None, "cubic", online)
                for a, b in zip(cuts[:-1], cuts[1:])]

    jb = jax_harness.setup_model("ncde", **kw)
    jp = jb.init(jax.random.PRNGKey(0), dtype=jnp.float64)
    want = jax_harness.train(jb, *splits(JaxLoadedData), init_params=jp, **trainer)
    tb = harness.setup_model("ncde", device="cpu", dtype=torch.float64, **kw)
    got = harness.train(tb, *splits(LoadedData), init_params=_port_params(jp, tb), **trainer)
    return want, got, tb, splits(LoadedData), trainer


@pytest.fixture(scope="module")
def oneshot_runs():
    return _run_both("oneshot")


@pytest.fixture(scope="module")
def online_runs():
    return _run_both("online")


@pytest.mark.parametrize("shape", list(ORACLE_SHAPES))
def test_train_matches_jax(shape, request):
    want, got, _, _, _ = request.getfixturevalue(f"{shape}_runs")
    assert got["epochs_run"] == want["epochs_run"]
    assert got["best_epoch"] == want["best_epoch"]
    scales = [h["lr_scale"] for h in got["history"]]
    assert scales == [h["lr_scale"] for h in want["history"]]
    assert any(s < 1.0 for s in scales), scales        # a plateau reduction fired
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], rtol=1e-9)
    np.testing.assert_allclose([h["auc"] for h in got["history"]],
                               [h["auc"] for h in want["history"]], atol=1e-12)
    np.testing.assert_allclose(got["test.loss"], want["test.loss"], rtol=1e-9)
    np.testing.assert_allclose(got["test.auc"], want["test.auc"], atol=1e-12)
    for key in ("num_params", "nfe_per_epoch", "nfe"):
        assert got[key] == want[key], key
    assert got["memory_usage"] is None
    assert set(got) == set(want)


def test_best_params_are_a_snapshot(oneshot_runs):
    """The best epoch came before the last, so its weights differ from the
    model's final ones, and the test metrics are those of the best
    weights: best_params aliasing the live weights fails here."""
    _, got, bundle, (_, _, test), trainer = oneshot_runs
    assert got["best_epoch"] < got["epochs_run"] - 1
    final = bundle.model.state_dict()
    best = got["best_params"]
    assert any(not torch.equal(best[k], final[k]) for k in final)
    batches = Batches(test, trainer["batch_size"])
    at_best = harness._evaluate(bundle, best, batches, "bce", ("loss", "auc"))
    at_final = harness._evaluate(bundle, final, batches, "bce", ("loss", "auc"))
    assert got["test.loss"] == at_best["loss"] and got["test.auc"] == at_best["auc"]
    assert at_final["loss"] != at_best["loss"]


# ------------------------------------------------------- options, seeds


def _toy_config(**trainer):
    cfg = parse_configuration_json("toy")[0][0]
    cfg["model"].update(hidden_dim=6, hidden_hidden_dim=8, num_layers=1, adjoint=False)
    cfg["trainer"].update(trainer)
    return cfg


def _same_run(a, b, exact=True):
    for key in ("epochs_run", "best_epoch"):
        assert a[key] == b[key], key
    if exact:
        assert a["history"] == b["history"]
        for key in ("train.loss", "test.loss", "test.auc"):
            assert a[key] == b[key], key
        for k in a["best_params"]:
            assert torch.equal(a["best_params"][k], b["best_params"][k]), k
    else:
        np.testing.assert_allclose([h["loss"] for h in a["history"]],
                                   [h["loss"] for h in b["history"]], rtol=1e-5)
        np.testing.assert_allclose(a["test.loss"], b["test.loss"], rtol=1e-5)


def test_seed_draws_the_initial_weights(toy_dataset):
    """Two bundles trained with one seed give identical results; another
    seed gives other results."""
    cfg = _toy_config(max_epochs=2)
    first = run_experiment({**cfg, "seed": 3}, toy_dataset, device="cpu")
    again = run_experiment({**cfg, "seed": 3}, toy_dataset, device="cpu")
    other = run_experiment({**cfg, "seed": 4}, toy_dataset, device="cpu")
    _same_run(first, again)
    assert first["test.loss"] != other["test.loss"]


def test_resume_is_bit_identical_to_an_uninterrupted_run(toy_dataset, tmp_path):
    full = run_experiment(_toy_config(max_epochs=4), toy_dataset, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    run_experiment(_toy_config(max_epochs=2, checkpoint_dir=ckpt, checkpoint_every=1),
                   toy_dataset, device="cpu")
    assert os.path.exists(os.path.join(ckpt, "trainer_state.meta.json"))
    resumed = run_experiment(_toy_config(max_epochs=4, checkpoint_dir=ckpt,
                                         checkpoint_every=1, resume=True),
                             toy_dataset, device="cpu")
    assert resumed["epochs_run"] == 4
    _same_run(resumed, full)
    from online_neural_cdes_tpu_torch.utils.checkpoint import load_checkpoint

    saved = load_checkpoint(os.path.join(ckpt, "best_params"), full["best_params"])
    for k, v in saved.items():
        assert torch.equal(v, full["best_params"][k]), k


@pytest.mark.parametrize("batch_size", [32, 40])   # 3 uniform batches; 2 and a tail
def test_epoch_fused_and_prefetch_match_the_default_trainer(toy_dataset, batch_size):
    cfg = _toy_config(max_epochs=2)
    cfg["dataset"]["batch_size"] = batch_size
    default = run_experiment(cfg, toy_dataset, device="cpu")
    for option in ({"epoch_fused": True}, {"prefetch": 2}):
        other = {**cfg, "trainer": {**cfg["trainer"], **option}}
        _same_run(run_experiment(other, toy_dataset, device="cpu"), default)


def test_accum_steps_matches_the_default_trainer(toy_dataset):
    cfg = _toy_config(max_epochs=2)
    cfg["dataset"]["batch_size"] = 32
    default = run_experiment(cfg, toy_dataset, device="cpu")
    accum = run_experiment({**cfg, "trainer": {**cfg["trainer"], "accum_steps": 2}},
                           toy_dataset, device="cpu")
    _same_run(accum, default, exact=False)


def test_profile_dir_writes_a_trace_and_bf16_compute_trains(toy_dataset, tmp_path):
    traces = str(tmp_path / "trace")
    res = run_experiment(_toy_config(max_epochs=2, profile_dir=traces), toy_dataset,
                         device="cpu")
    assert len(glob.glob(os.path.join(traces, "*.json"))) == 1
    bf16 = run_experiment(_toy_config(max_epochs=2, compute_dtype="bfloat16"),
                          toy_dataset, device="cpu")
    assert np.isfinite(bf16["test.loss"]) and np.isfinite(res["test.loss"])
    assert bf16["test.loss"] != res["test.loss"]
    assert bf16["best_params"]["final.w"].dtype == torch.float32


def test_train_refusals(toy_dataset):
    cfg = _toy_config(max_epochs=1)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        run_experiment(cfg, toy_dataset, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="final_lr_multiplier=None"):
        run_experiment({**cfg, "trainer": {**cfg["trainer"], "final_lr_multiplier": None}},
                       toy_dataset, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_experiment({**cfg, "trainer": {**cfg["trainer"], "epoch_fused": True,
                                           "prefetch": 2}}, toy_dataset, device="cpu")


def test_setup_model_needs_a_device_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.setup_model("ncde", input_dim=3, output_dim=1)
