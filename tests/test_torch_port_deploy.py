"""The port's checkpoint -> artifact command line (``deploy``) on the CPU.

Every case of the JAX package's ``tests/test_deploy.py`` has a counterpart
here: a trained config is rebuilt through the port's experiment path
(weights from a seed, written with the port's ``save_checkpoint``),
exported with ``deploy.main`` (``--device cpu``), loaded, and a raw corpus
row served equals the bundle's forward on the stored coefficients for
that row at rtol 1e-5, atol 1e-6 (float32 round-off over the intervals,
the JAX tests' tolerance); ``--verify`` gates bit for bit; the refusals
and the task-metric gate's cases are JAX's.  ``serving_coeff_fn`` equals
the JAX package's for every key it accepts at rtol 1e-9 in float64.  The
corpora (made with the JAX package's preprocessing, as its tests make
them) are 16 long, so each export is one module (``--length-multiple
16``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu import deploy as jax_deploy
from online_neural_cdes_tpu.data.common import (
    add_time, process_all_interpolations, save_processed,
)
from online_neural_cdes_tpu_torch.deploy import (
    _gate_metrics, _rebuild, _task_metric_gate, build_predictor_from_config,
    build_stepper_from_config, main, serving_coeff_fn,
)
from online_neural_cdes_tpu_torch.serving_export import load_predictor, load_stepper, update_params
from online_neural_cdes_tpu_torch.training.experiment import load_and_setup
from online_neural_cdes_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LENGTH = 16
CPU = ["--device", "cpu"]


def _corpus(root, name, n=40, seed=11, static_dim=None, labels=None, online=False):
    rng = np.random.default_rng(seed)
    values = np.cumsum(rng.normal(size=(n, LENGTH, 2)), axis=1) * 0.2
    if static_dim is None:
        drop = rng.uniform(size=values[..., 1].shape) < 0.15
        values[..., 1][drop] = np.nan
    temporal = add_time(values).astype(np.float32)
    static = None if static_dim is None else rng.normal(size=(n, static_dim)).astype(
        np.float32)
    if labels is None:
        labels = (np.nanmean(values[:, :, 0], axis=1) > 0).astype(np.int64)
    strat = labels if not online and np.asarray(labels).dtype != object else None
    processed = process_all_interpolations(static, temporal, strat)
    stored = labels.astype(np.float32) if isinstance(labels, np.ndarray) else labels
    save_processed(processed, stored, os.path.join(root, name))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A one-shot corpus 16 long, 15% NaN in its value channel."""
    return _corpus(str(tmp_path_factory.mktemp("cli_corpus")), "Toy/CLI")


@pytest.fixture(scope="module")
def static_corpus(tmp_path_factory):
    """A corpus with static features (the MIMIC-shaped scenario)."""
    rng = np.random.default_rng(13)
    labels = (rng.normal(size=30) > 0).astype(np.int64)
    return _corpus(str(tmp_path_factory.mktemp("static_corpus")), "Toy/Static", n=30,
                   seed=13, static_dim=3, labels=labels)


def _config(interpolation, model_string="ncde", data_loc="Toy/CLI"):
    return {
        "dataset_name": "toy-cli",
        "seed": 0,
        "dataset": {"data_loc": data_loc, "problem": "oneshot", "use_static": False,
                    "interpolation": interpolation, "batch_size": 16},
        "model": {"model_string": model_string, "hidden_dim": 8, "hidden_hidden_dim": 8,
                  "num_layers": 1, "adjoint": False, "solver": "rk4"},
    }


def _checkpoint(tmp_path, config, root, seed, name="best_params"):
    """(bundle, params, checkpoint path, config path)."""
    bundle, _ = load_and_setup(config, root, device="cpu")
    params = bundle.init(seed)
    ckpt = save_checkpoint(str(tmp_path / name), params)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    return bundle, params, ckpt, str(cfg_path)


def _npz(root, loc="Toy/CLI"):
    return np.load(os.path.join(root, loc, "improved-neural-cdes_data.npz"),
                   allow_pickle=True)


def _close_rows(served, direct):
    for i in range(len(served)):
        np.testing.assert_allclose(served[i], direct[i], rtol=RTOL, atol=ATOL)


def _direct(bundle, params, inputs):
    with torch.inference_mode():
        return bundle.apply_fn(params, bundle.prepare_batch(inputs)).numpy()


def _cli(cfg, ckpt, out, root, *extra):
    main(["--config", cfg, "--checkpoint", ckpt, "--out", out, "--data-root", root,
          "--batch-buckets", "4", "--length-multiple", str(LENGTH), *CPU, *extra])


@pytest.mark.parametrize("interpolation", ["linear", "rectilinear"])
def test_cli_exports_and_serves_corpus_rows(tmp_path, corpus, interpolation):
    """init -> checkpoint -> main() -> load: a raw corpus row served equals
    the bundle's forward on the stored coefficients for that row."""
    config = _config(interpolation)
    bundle, params, ckpt, cfg = _checkpoint(tmp_path, config, corpus, 3)
    out = str(tmp_path / "artifact")
    _cli(cfg, ckpt, out, corpus)
    npz = _npz(corpus)
    idx = npz["test_idxs"][:3]
    served = load_predictor(out, device="cpu").predict(list(npz["temporal_data_raw"][idx]))
    _close_rows(served, _direct(bundle, params, np.asarray(
        npz[f"temporal_data_{interpolation}"][idx], np.float32)))


@pytest.mark.parametrize("model_string", ["ncde-stacked", "ncde-attention"])
def test_composite_ncde_variants_serve_through_builder(tmp_path, corpus, model_string):
    config = _config("linear", model_string=model_string)
    bundle, params, ckpt, _ = _checkpoint(tmp_path, config, corpus, 12)
    predictor, info = build_predictor_from_config(config, ckpt, data_root=corpus,
                                                  batch_buckets=(4,), length_multiple=8,
                                                  device="cpu")
    assert info["model_string"] == model_string
    npz = _npz(corpus)
    idx = npz["test_idxs"][:2]
    served = predictor.predict(list(npz["temporal_data_raw"][idx]))
    _close_rows(served, _direct(bundle, params, np.asarray(
        npz["temporal_data_linear"][idx], np.float32)))


def test_cli_logsig_config_serves_raw_rows(tmp_path, corpus):
    """A log-ODE config serves raw rows through the window transform: equal
    to the forward on the loader's transformed windows."""
    config = _config("logsig-2-8")
    bundle, params, ckpt, _ = _checkpoint(tmp_path, config, corpus, 4)
    _, splits = load_and_setup(config, corpus, device="cpu")
    predictor, info = build_predictor_from_config(config, ckpt, data_root=corpus,
                                                  batch_buckets=(4,), length_multiple=8,
                                                  device="cpu")
    assert info["channels"] == 3   # raw request channels, not logsig width
    npz = _npz(corpus)
    idx = npz["test_idxs"][:2]
    served = predictor.predict(list(npz["temporal_data_raw"][idx]))
    pos = {int(j): k for k, j in enumerate(npz["test_idxs"])}
    rows = np.stack([np.asarray(splits[2].temporal[pos[int(j)]]) for j in idx])
    _close_rows(served, _direct(bundle, params, rows.astype(np.float32)))


@pytest.mark.smoke
def test_cli_update_params_only_rolls_checkpoint(tmp_path, corpus):
    """A retrained checkpoint deploys with --update-params-only: the
    artifact and its nested stepper artifact get the new weights."""
    config = _config("rectilinear")
    bundle, _, ckpt1, cfg = _checkpoint(tmp_path, config, corpus, 20, "ckpt1")
    out = str(tmp_path / "artifact")
    _cli(cfg, ckpt1, out, corpus, "--stepper", "--stream-batch-sizes", "2")
    params_v2 = bundle.init(21)
    ckpt2 = save_checkpoint(str(tmp_path / "ckpt2"), params_v2)
    main(["--config", cfg, "--checkpoint", ckpt2, "--out", out, "--data-root", corpus,
          "--update-params-only", *CPU])
    npz = _npz(corpus)
    idx = npz["test_idxs"][:2]
    served = load_predictor(out, device="cpu").predict(list(npz["temporal_data_raw"][idx]))
    _close_rows(served, _direct(bundle, params_v2, np.asarray(
        npz["temporal_data_rectilinear"][idx], np.float32)))
    with np.load(os.path.join(out, "stepper", "params.npz")) as z, \
            np.load(os.path.join(out, "params.npz")) as p:
        for k in p.files:
            np.testing.assert_array_equal(z[k], p[k])


def _live_stepper(bundle, params, static=None):
    from online_neural_cdes_tpu_torch.serving import OnlineNCDEStepper

    stepper = OnlineNCDEStepper(bundle.model, static=static, device="cpu")
    stepper.params = params
    return stepper


def _ticks(live, loaded, x):
    s_live, s_art = live.init(x[:, 0]), loaded.init(x[:, 0])
    for k in range(1, 5):
        s_live, y_live = live.step(s_live, x[:, k])
        s_art, y_art = loaded.step(s_art, x[:, k])
        assert torch.equal(y_live, y_art)


def test_cli_stepper_flag_exports_streaming_artifact(tmp_path, corpus):
    """--stepper adds a streaming artifact at <out>/stepper that ticks as a
    live stepper at the checkpoint's weights, to the bit."""
    config = _config("rectilinear")
    bundle, params, ckpt, cfg = _checkpoint(tmp_path, config, corpus, 6)
    out = str(tmp_path / "artifact")
    _cli(cfg, ckpt, out, corpus, "--stepper", "--stream-batch-sizes", "2")
    npz = _npz(corpus)
    x = np.asarray(npz["temporal_data_raw"][npz["test_idxs"][:2]], np.float32)
    _ticks(_live_stepper(bundle, params), load_stepper(os.path.join(out, "stepper"),
                                                       device="cpu"), x)


def test_stepper_build_rejects_non_ncde(tmp_path, corpus):
    config = _config("linear", model_string="gru-d")
    config["model"]["return_sequences"] = True
    _, _, ckpt, _ = _checkpoint(tmp_path, config, corpus, 7)
    with pytest.raises(ValueError, match="plain NCDE"):
        build_stepper_from_config(config, ckpt, data_root=corpus, device="cpu")


def test_recurrent_oneshot_config_rejected(tmp_path, corpus):
    """A recurrent one-shot config cannot serve (padding would keep
    mutating the final state): predictor_from_bundle's recipe surfaces."""
    config = _config(None, model_string="gru-dt")
    _, _, ckpt, _ = _checkpoint(tmp_path, config, corpus, 5)
    with pytest.raises(ValueError, match="return_sequences"):
        build_predictor_from_config(config, ckpt, data_root=corpus, device="cpu")


def test_cli_static_featured_config_serves(tmp_path, static_corpus):
    """A static-featured NCDE config exports with statics in the module's
    signature and serves (static, raw rows) requests equal to the bundle's
    forward on the stored data."""
    config = _config("linear", data_loc="Toy/Static")
    config["dataset"]["use_static"] = True
    bundle, params, ckpt, cfg = _checkpoint(tmp_path, config, static_corpus, 14)
    out = str(tmp_path / "artifact")
    _cli(cfg, ckpt, out, static_corpus)
    npz = _npz(static_corpus, "Toy/Static")
    idx = npz["test_idxs"][:3]
    st = npz["static_data"][idx].astype(np.float32)
    served = load_predictor(out, device="cpu").predict(list(npz["temporal_data_raw"][idx]),
                                                       static=st)
    _close_rows(served, _direct(bundle, params, (st, np.asarray(
        npz["temporal_data_linear"][idx], np.float32))))


def test_cli_static_stepper_exports_and_streams(tmp_path, static_corpus):
    """--stepper on a static-featured rectilinear config: the streaming
    artifact binds the streams' statics at load and ticks as a live
    stepper with them."""
    config = _config("rectilinear", data_loc="Toy/Static")
    config["dataset"]["use_static"] = True
    bundle, params, ckpt, cfg = _checkpoint(tmp_path, config, static_corpus, 15)
    out = str(tmp_path / "artifact")
    _cli(cfg, ckpt, out, static_corpus, "--stepper", "--stream-batch-sizes", "3")
    npz = _npz(static_corpus, "Toy/Static")
    idx = npz["test_idxs"][:3]
    x = np.asarray(npz["temporal_data_raw"][idx], np.float32)
    st = npz["static_data"][idx].astype(np.float32)
    _ticks(_live_stepper(bundle, params, st),
           load_stepper(os.path.join(out, "stepper"), static=st, device="cpu"), x)


def test_intensity_coeff_fn_rejected_with_recipe():
    with pytest.raises(ValueError, match="rectilinear-intensity"):
        serving_coeff_fn("rectilinear-intensity")


@pytest.mark.parametrize("key", ["cubic", "hermite"])
def test_global_spline_keys_rejected_with_recipe(key):
    with pytest.raises(ValueError, match="length padding"):
        serving_coeff_fn(key)


def test_missing_interpolation_key_rejected_clearly():
    with pytest.raises(ValueError, match="no dataset interpolation key"):
        serving_coeff_fn(None)


@pytest.mark.parametrize("key", ["linear", "rectilinear", "linear_forward_fill",
                                 "linear_cubic_smoothing", "linear_quintic_smoothing",
                                 "cubic_forward_fill", "logsig-2-4", "logsig-3-5"])
def test_serving_coeff_fn_matches_jax(key):
    """Every key serving_coeff_fn accepts builds what the JAX package's
    builds, in float64, on NaN-holding rows."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 12, 3))
    x[:, :, 0] = np.arange(12)
    x[0, 0, 1] = np.nan
    x[1, 3:5, 2] = np.nan
    got = serving_coeff_fn(key)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_deploy.serving_coeff_fn(key)(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_explicit_coeff_fn_overrides_unsupported_keys(tmp_path, corpus):
    """An explicit coeff_fn suppresses serving_coeff_fn entirely (its
    refusal must not fire) and serves full-length requests exactly."""
    from online_neural_cdes_tpu_torch.ops.interpolation import (
        hermite_cubic_coefficients_with_backward_differences as herm,
    )

    config = _config("hermite")
    bundle, params, ckpt, _ = _checkpoint(tmp_path, config, corpus, 8)

    def herm_fn(x):   # the preprocessing's first-row NaN fill + builder
        first = x[:, :1].masked_fill(torch.isnan(x[:, :1]), 0.0)
        return herm(torch.cat([first, x[:, 1:]], dim=1))

    predictor, _ = build_predictor_from_config(config, ckpt, data_root=corpus,
                                               coeff_fn=herm_fn, batch_buckets=(4,),
                                               length_multiple=LENGTH, device="cpu")
    npz = _npz(corpus)
    idx = npz["test_idxs"][:2]
    served = predictor.predict(list(npz["temporal_data_raw"][idx]))
    _close_rows(served, _direct(bundle, params, np.asarray(
        npz["temporal_data_hermite"][idx], np.float32)))


def test_recurrent_interpolation_escape_hatch_serves(tmp_path, corpus):
    """The refusal's own recipe works: an explicit coeff_fn composing the
    training-time interpolation into the bundle's preparation serves a
    recurrent interpolated config."""
    config = _config("linear", model_string="gru-d")
    config["model"]["return_sequences"] = True
    config["dataset"]["problem"] = "online"
    bundle, params, ckpt, _ = _checkpoint(tmp_path, config, corpus, 10)
    coeff = serving_coeff_fn("linear")
    predictor, _ = build_predictor_from_config(
        config, ckpt, data_root=corpus, coeff_fn=lambda x: bundle.prepare_batch(coeff(x)),
        batch_buckets=(4,), length_multiple=LENGTH, device="cpu")
    npz = _npz(corpus)
    idx = npz["test_idxs"][:2]
    served = predictor.predict(list(npz["temporal_data_raw"][idx]))
    _close_rows(served, _direct(bundle, params, np.asarray(
        npz["temporal_data_linear"][idx], np.float32)))


def test_recurrent_config_with_interpolation_rejected(tmp_path, corpus):
    config = _config("linear", model_string="gru-d")
    config["dataset"]["problem"] = "online"
    _, _, ckpt, _ = _checkpoint(tmp_path, config, corpus, 9)
    with pytest.raises(ValueError, match="interpolation: null"):
        build_predictor_from_config(config, ckpt, data_root=corpus, device="cpu")


def test_cli_params_dtype_bf16_export(tmp_path, corpus):
    """--params-dtype bfloat16 stores bf16 leaves and serves within bf16
    tolerance of the f32 artifact."""
    config = _config("linear")
    _, _, ckpt, cfg = _checkpoint(tmp_path, config, corpus, 3)
    out32, out16 = str(tmp_path / "a32"), str(tmp_path / "a16")
    _cli(cfg, ckpt, out32, corpus)
    _cli(cfg, ckpt, out16, corpus, "--params-dtype", "bfloat16")
    manifest = json.load(open(os.path.join(out16, "manifest.json")))
    assert all(d == "bfloat16" for d in manifest["leaf_dtypes"] if "float" in d)
    npz = _npz(corpus)
    raw = list(npz["temporal_data_raw"][npz["test_idxs"][:3]])
    for a, b in zip(load_predictor(out32, device="cpu").predict(raw),
                    load_predictor(out16, device="cpu").predict(raw)):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05)


def test_cli_verify_gate(tmp_path, corpus, capsys):
    """--verify loads the exported artifact and holds it to the live
    predictor to the bit; it gates --update-params-only rolls too."""
    config = _config("linear")
    _, _, ckpt, cfg = _checkpoint(tmp_path, config, corpus, 3)
    out = str(tmp_path / "a")
    _cli(cfg, ckpt, out, corpus, "--verify")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["verified"] == "bit-exact"
    main(["--config", cfg, "--checkpoint", ckpt, "--out", out, "--data-root", corpus,
          "--update-params-only", "--verify", *CPU])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["leaves_updated"] > 0
    assert summary["verified"] == "bit-exact"


def test_cli_exports_and_verifies_a_hermite_dopri5_config(tmp_path, corpus, capsys):
    """A ``hermite-dopri5`` config (``configurations.json5:157-171``'s model:
    Hermite, dopri5, ``adjoint: false``) exports: its adaptive solve traces
    into the tensor controller, and its global-spline build serves the
    corpus length alone (``exact_length`` in the manifest, one length
    bucket), so ``--verify`` holds the loaded artifact to the live
    predictor to the bit and a corpus row served equals the bundle's
    forward on its stored Hermite coefficients.  A request of another
    length (a partial history, or a longer one) is refused by the live and
    the loaded predictor alike, never padded into the bucket."""
    config = _config("hermite")
    config["model"]["solver"] = "dopri5"
    bundle, params, ckpt, cfg = _checkpoint(tmp_path, config, corpus, 3)
    out = str(tmp_path / "artifact")
    _cli(cfg, ckpt, out, corpus, "--verify")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["verified"] == "bit-exact"
    assert (summary["shapes_exported"], summary["max_length"]) == (1, LENGTH)
    with open(os.path.join(out, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["solve_stats"] is True and manifest["exact_length"] == LENGTH
    npz = _npz(corpus)
    idx = npz["test_idxs"][:3]
    loaded = load_predictor(out, device="cpu")
    served = loaded.predict(list(npz["temporal_data_raw"][idx]))
    live, _ = build_predictor_from_config(config, ckpt, data_root=corpus,
                                          batch_buckets=(4,), device="cpu")
    assert live.exact_length == loaded.exact_length == LENGTH
    # The build reproduces the corpus's coefficients; the adaptive steps
    # are the whole bucket's (the first request again pads it to 4), and a
    # step grid moved by the builds' round-off would move the rows by the
    # solve's tolerance, so the rows are held on the served build.
    bucket = np.concatenate([idx, idx[:1]])
    raw = np.stack(list(npz["temporal_data_raw"][bucket])).astype(np.float32)
    coeffs = live.coeff_fn(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(coeffs, np.asarray(npz["temporal_data_hermite"][bucket]),
                               rtol=RTOL, atol=ATOL)
    _close_rows(served, _direct(bundle, params, coeffs))
    row = np.asarray(npz["temporal_data_raw"][idx[0]], np.float32)
    for pred in (live, loaded):
        for bad in ([row[:LENGTH // 2]], [row, row[:-1]],
                    [np.concatenate([row, row[-1:]])]):
            with pytest.raises(ValueError, match=f"exactly {LENGTH} observations"):
                pred.predict(bad)
    with pytest.raises(ValueError, match="corpus length"):
        _cli(cfg, ckpt, str(tmp_path / "b"), corpus, "--max-length", str(2 * LENGTH))


def test_cli_needs_a_device_when_no_gpu(tmp_path, corpus, monkeypatch):
    """With no --device and no card visible the command raises, never
    drifting to the CPU."""
    config = _config("linear")
    _, _, ckpt, cfg = _checkpoint(tmp_path, config, corpus, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", cfg, "--checkpoint", ckpt, "--out", str(tmp_path / "a"),
              "--data-root", corpus])


def test_bf16_metric_gate_passes_and_fails_by_threshold(tmp_path, corpus, capsys):
    """A bfloat16 export under --verify passes the task-metric gate on the
    val split; an artifact whose weights drifted fails it by threshold."""
    config = _config("linear")
    _, params, ckpt, cfg = _checkpoint(tmp_path, config, corpus, 3)
    out16 = str(tmp_path / "a16")
    _cli(cfg, ckpt, out16, corpus, "--params-dtype", "bfloat16", "--verify")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    gate = summary["metric_gate"]
    assert set(gate["metrics"]) == {"auc", "acc"}, gate
    for vals in gate["metrics"].values():
        assert vals["abs_delta"] <= gate["tol"], gate
    # A drifted checkpoint: the readout's sign flipped, every logit with it.
    update_params(out16, {k: -v if k.startswith("final.") else v for k, v in params.items()})
    rebuilt = _rebuild(config, ckpt, corpus, "cpu")
    predictor, _ = build_predictor_from_config(config, ckpt, _rebuilt=rebuilt,
                                               batch_buckets=(4,), length_multiple=LENGTH)
    with pytest.raises(ValueError, match="task-metric gate"):
        _task_metric_gate(predictor, out16, rebuilt[5], config, 0.01)


def _export_bf16(tmp_path, config, root, seed=3):
    """init -> checkpoint -> bf16 artifact; (out_dir, predictor, rebuilt)."""
    _, _, ckpt, cfg = _checkpoint(tmp_path, config, root, seed)
    out16 = str(tmp_path / "a16")
    main(["--config", cfg, "--checkpoint", ckpt, "--out", out16, "--data-root", root,
          "--batch-buckets", "4", "--length-multiple", str(LENGTH), *CPU,
          "--params-dtype", "bfloat16"])
    rebuilt = _rebuild(config, ckpt, root, "cpu")
    predictor, _ = build_predictor_from_config(config, ckpt, _rebuilt=rebuilt,
                                               batch_buckets=(4,), length_multiple=LENGTH)
    return out16, predictor, rebuilt


def test_metric_gate_regression_n1_labels(tmp_path):
    """Continuous (N, 1) labels (MIMIC LOS/Mortality) gate through the
    inferred rmse without a shape crash."""
    rng = np.random.default_rng(5)
    labels = (rng.normal(size=30)).reshape(-1, 1)
    root = _corpus(str(tmp_path / "root"), "Toy/REG", n=30, seed=5, labels=labels,
                   online=True)
    config = _config("linear", data_loc="Toy/REG")
    out16, predictor, rebuilt = _export_bf16(tmp_path, config, root)
    gate = _task_metric_gate(predictor, out16, rebuilt[5], config, tol=10.0)
    assert set(gate["metrics"]) == {"rmse"}, gate
    assert np.isfinite(gate["metrics"]["rmse"]["live_f32"])


def test_metric_gate_ragged_object_labels(tmp_path):
    """Ragged (L_i, 1) object-array labels (the MIMIC online contract) gate
    without a crash: densified and NaN-padded to the outputs' time axis."""
    rng = np.random.default_rng(7)
    labels = [rng.integers(0, 2, size=(int(L), 1)).astype(np.float32)
              for L in rng.integers(10, 15, size=30)]
    root = _corpus(str(tmp_path / "root"), "Toy/RAG", n=30, seed=7, labels=labels,
                   online=True)
    config = _config("linear", data_loc="Toy/RAG")
    config["dataset"]["problem"] = "online"
    out16, predictor, rebuilt = _export_bf16(tmp_path, config, root)
    gate = _task_metric_gate(predictor, out16, rebuilt[5], config, tol=0.5)
    assert set(gate["metrics"]) == {"auc", "acc"}, gate
    for vals in gate["metrics"].values():
        assert np.isfinite(vals["artifact"]), gate


def test_metric_gate_refuses_unknown_metric(tmp_path, corpus):
    config = _config("linear")
    config["trainer"] = {"metrics": ["loss", "not-a-metric"]}
    out16, predictor, rebuilt = _export_bf16(tmp_path, config, corpus)
    with pytest.raises(ValueError, match="unknown metric"):
        _task_metric_gate(predictor, out16, rebuilt[5], config, tol=0.5)


def test_gate_metrics_follow_training_contract():
    """The config's training contract picks the gate's metrics before the
    label space does."""
    int_regression = np.asarray([3.0, 7.0, 2.0, 9.0])
    assert _gate_metrics({"trainer": {"loss_str": "rmse"}}, int_regression) == ["rmse"]
    assert _gate_metrics({"trainer": {"loss_str": "mse"}}, int_regression) == ["rmse"]
    assert _gate_metrics({"trainer": {"loss_str": "ce"}},
                         np.asarray([0.0, 3.0, 2.0])) == ["acc"]
    assert _gate_metrics({"trainer": {"loss_str": "bce"}},
                         np.asarray([0.0, 1.0])) == ["auc", "acc"]
    assert _gate_metrics({"trainer": {"metrics": ["loss", "auprc"], "loss_str": "rmse"}},
                         int_regression) == ["auprc"]
    assert _gate_metrics({}, np.asarray([0.0, 1.0])) == ["auc", "acc"]
    assert _gate_metrics({}, np.asarray([0.25, 1.75])) == ["rmse"]
    for config, labels in (({"trainer": {"loss_str": "rmse"}}, int_regression),
                           ({}, np.asarray([0.0, 1.0])), ({}, np.asarray([0.25, 1.75]))):
        assert _gate_metrics(config, labels) == jax_deploy._gate_metrics(config, labels)


def test_metric_gate_recurrent_model_with_static_corpus(tmp_path):
    """A recurrent baseline over a corpus that stores statics: the model
    takes none, so the gate does not feed the val split's statics."""
    rng = np.random.default_rng(23)
    values = np.cumsum(rng.normal(size=(30, LENGTH, 2)), axis=1) * 0.2
    labels = (values[:, :, 0] > 0).astype(np.float32)[..., None]   # online
    root = str(tmp_path / "root")
    processed = process_all_interpolations(rng.normal(size=(30, 3)).astype(np.float32),
                                           add_time(values).astype(np.float32), None)
    save_processed(processed, labels, os.path.join(root, "Toy/RS"))
    config = _config(None, model_string="gru", data_loc="Toy/RS")
    config["dataset"]["problem"] = "online"
    config["dataset"]["use_static"] = True
    out16, predictor, rebuilt = _export_bf16(tmp_path, config, root)
    assert not predictor.accept_static
    gate = _task_metric_gate(predictor, out16, rebuilt[5], config, tol=0.5)
    assert set(gate["metrics"]) == {"auc", "acc"}, gate


def test_metric_gate_single_class_val_split(tmp_path):
    """A metric undefined on the val split (one-class AUC) is recorded as
    skipped and the rest are scored; with nothing scoreable the gate
    refuses."""
    root = _corpus(str(tmp_path / "root"), "Toy/ONE", n=30, seed=29,
                   labels=np.ones(30, np.float32), online=True)
    config = _config("linear", data_loc="Toy/ONE")
    config["trainer"] = {"metrics": ["loss", "auc", "acc"]}
    out16, predictor, rebuilt = _export_bf16(tmp_path, config, root)
    gate = _task_metric_gate(predictor, out16, rebuilt[5], config, tol=0.5)
    assert gate["metrics"]["auc"] == {"skipped": "undefined on val split"}
    assert np.isfinite(gate["metrics"]["acc"]["abs_delta"])
    with pytest.raises(ValueError, match="vacuous"):
        _task_metric_gate(predictor, out16, rebuilt[5],
                          dict(config, trainer={"metrics": ["auc"]}), tol=0.5)
