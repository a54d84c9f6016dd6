"""Parity of the port's data pipeline against the JAX package, on the CPU:
the native preprocessing binding, ``data/common.py`` (interpolation, the
numpy helpers, the splits), ``data/loader.py`` (``load_numpy_data``,
``Batches``), ``data/mimic.py`` and the slice as a whole (a synthetic
MIMIC corpus prepared, loaded, batched and trained two steps).

The same numpy inputs (fixed seeds) go through both sides.  The native
library is the same source built with the same flags, so its outputs are
held bit for bit; coefficients from the port's builders against JAX's at
float32 rtol 1e-5; the port's split against scikit-learn's
``train_test_split`` (through the JAX package's function) exactly; the
slice's two Adam steps at float32 |err| <= 1e-5 (|want| + max|want|).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from online_neural_cdes_tpu.data import common as jax_common
from online_neural_cdes_tpu.data import loader as jax_loader
from online_neural_cdes_tpu.data import mimic as jax_mimic
from online_neural_cdes_tpu.data import native as jax_native
from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.training import loop as jax_loop
from online_neural_cdes_tpu_torch import NeuralCDE, params_from_jax
from online_neural_cdes_tpu_torch.data import common, loader, mimic, native
from online_neural_cdes_tpu_torch.models.grud import time_since_last_observation
from online_neural_cdes_tpu_torch.ops import interpolation
from online_neural_cdes_tpu_torch.ops.fill import forward_fill, linear_fill
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL = 1e-5


def _ragged(seed=0, n=6, channels=3, low=3, high=12):
    """``tests/test_native.py``'s ragged corpus: time in channel 0, 30%
    NaN holes elsewhere."""
    rng = np.random.default_rng(seed)
    series = []
    for _ in range(n):
        length = int(rng.integers(low, high))
        s = rng.normal(size=(length, channels)).astype(np.float32)
        s[:, 0] = np.arange(length)
        mask = rng.uniform(size=(length, channels - 1)) < 0.3
        s[:, 1:][mask] = np.nan
        series.append(s)
    return series


def _equal_lists(got, want, exact=True, err_msg=""):
    assert len(got) == len(want), err_msg
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (err_msg, i, g.shape, w.shape)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{err_msg} [{i}]")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * np.nanmax(np.abs(w)),
                                       err_msg=f"{err_msg} [{i}]")


# ------------------------------------------------------------------ native

NATIVE = {
    "forward_fill": lambda m, s: m.forward_fill_ragged([x.copy() for x in s]),
    "linear_fill": lambda m, s: m.linear_fill_ragged([x.copy() for x in s]),
    "linear_fill_times": lambda m, s: m.linear_fill_ragged(
        s, times=[np.cumsum(np.arange(len(x)) % 3 + 0.5) for x in s]),
    "rectilinear": lambda m, s: m.rectilinear_ragged(s, time_index=0),
    "natural_cubic": lambda m, s: m.natural_cubic_ragged(s),
    "hermite": lambda m, s: m.hermite_ragged(s),
    "delta_mask": lambda m, s: [a for pair in zip(*m.delta_mask_ragged(s)) for a in pair],
}


@pytest.mark.parametrize("entry", sorted(NATIVE))
def test_native_entry_points_equal_the_jax_binding(entry):
    series = _ragged(11, n=40, channels=4)
    _equal_lists(NATIVE[entry](native, series), NATIVE[entry](jax_native, series),
                 err_msg=entry)


def _plain(entry, s):
    x = torch.from_numpy(s)
    if entry == "forward_fill":
        return forward_fill(x, axis=-2)
    if entry == "linear_fill":
        return linear_fill(x, axis=-2)
    if entry == "rectilinear":
        return interpolation.prepare_rectilinear_interpolation(x[None], 0)[0]
    if entry == "natural_cubic":
        return interpolation.natural_cubic_coeffs(x[None])[0]
    return interpolation.hermite_cubic_coefficients_with_backward_differences(x[None])[0]


@pytest.mark.parametrize("entry,seed,tol", [
    ("forward_fill", 0, 0.0), ("linear_fill", 1, 1e-6), ("rectilinear", 2, 1e-6),
    ("natural_cubic", 3, 2e-4), ("hermite", 7, 2e-4)])
def test_native_entry_points_match_the_port_plain_ops(entry, seed, tol):
    """``tests/test_native.py``'s comparisons, against the port's ops."""
    series = _ragged(seed)
    for s, g in zip(series, NATIVE[entry](native, series)):
        want = _plain(entry, s).numpy()
        assert g.shape == want.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want))
        np.testing.assert_allclose(g[~np.isnan(g)], want[~np.isnan(want)], atol=tol,
                                   rtol=tol / 2)


def test_native_delta_mask_matches_the_port_grud():
    series = _ragged(4)
    deltas, masks = native.delta_mask_ragged(series)
    for s, d, m in zip(series, deltas, masks):
        ed, em = time_since_last_observation(torch.from_numpy(s)[None])
        np.testing.assert_allclose(d, ed[0].numpy(), atol=1e-5)
        np.testing.assert_array_equal(m, em[0].numpy())


def test_native_rejects_too_short_series_and_mismatched_times():
    with pytest.raises(ValueError, match="at least 1"):
        native.rectilinear_ragged([np.zeros((3, 2), np.float32),
                                   np.zeros((0, 2), np.float32)])
    with pytest.raises(ValueError, match="at least 2"):
        native.natural_cubic_ragged([np.zeros((1, 2), np.float32)])
    with pytest.raises(ValueError, match="at least 2"):
        native.hermite_ragged([np.zeros((1, 2), np.float32)])
    with pytest.raises(ValueError, match="times"):
        native.linear_fill_ragged([np.zeros((4, 2), np.float32)], times=[np.arange(3.0)])
    with pytest.raises(ValueError, match="empty"):
        native.forward_fill_ragged([])


def test_native_builds_under_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The port's library lives under ``build/native/``, never at the JAX
    package's ``csrc/libncde_preprocess.so``; a build that fails raises
    (naming the plain path) instead of falling back."""
    assert native.build() == native.LIBRARY
    assert native.LIBRARY.parent.name == "native"
    assert native.LIBRARY.parent.parent.name == "build"
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "lib.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="use_native=False"):
        native.forward_fill_ragged(_ragged(0))
    assert not (tmp_path / "lib.so").exists()


def test_native_rebuilds_a_library_older_than_its_source(tmp_path, monkeypatch):
    src = tmp_path / "preprocess.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"stale")
    import os
    os.utime(lib, (1, 1))
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "LIBRARY", lib)
    assert native.build() == lib and lib.read_bytes() != b"stale"
    mtime = lib.stat().st_mtime
    assert native.build() == lib and lib.stat().st_mtime == mtime


# ------------------------------------------------------------------ common


@pytest.mark.parametrize("method", common.INTERPOLATION_METHODS)
def test_interpolate_array_matches_jax(method):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5, 9, 4)).astype(np.float32)
    x[..., 0] = np.arange(9)
    x[:, :, 1:][rng.uniform(size=(5, 9, 3)) < 0.3] = np.nan
    got = common.interpolate(x, method, device="cpu")
    want = np.asarray(jax_common.interpolate(x, method))
    assert isinstance(got, np.ndarray)
    _equal_lists([got], [want], exact=False, err_msg=method)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("method", common.INTERPOLATION_METHODS)
def test_interpolate_ragged_matches_jax(method, use_native):
    series = _ragged(9, n=12, channels=4, low=2, high=9)
    got = common.interpolate(series, method, use_native=use_native, device="cpu")
    want = jax_common.interpolate(series, method, use_native=use_native)
    _equal_lists(got, want, exact=use_native, err_msg=method)


def test_interpolate_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.interpolate(np.zeros((2, 3, 2), np.float32), "linear")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.interpolate(_ragged(0), "linear", use_native=False)


def test_numpy_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 7, 3))
    x[rng.uniform(size=x.shape) < 0.2] = np.nan
    static = rng.normal(size=(6, 5))
    static[0, 1] = np.nan
    np.testing.assert_array_equal(common.add_time(x), jax_common.add_time(x))
    for data in (x, list(_ragged(3))):
        _equal_lists(common.normalise(data), jax_common.normalise(data))
    np.testing.assert_array_equal(common.negative_filter(static),
                                  jax_common.negative_filter(static))
    np.testing.assert_array_equal(common.static_pipeline(static),
                                  jax_common.static_pipeline(static))
    _equal_lists(common.reduce_tensor_samples([x, static], 3),
                 jax_common.reduce_tensor_samples([x, static], 3))
    for kw in ({}, {"step_size": 2}, {"return_same_size": False}):
        np.testing.assert_array_equal(common.rolling_window(x, 3, **kw),
                                      jax_common.rolling_window(x, 3, **kw))


def _same_processed(got, want):
    assert list(got) == list(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, list) or getattr(w, "dtype", None) == object:
            _equal_lists(list(g), list(w), err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
            assert np.asarray(g).dtype == np.asarray(w).dtype, key


@pytest.mark.parametrize("ragged", [True, False])
def test_process_all_interpolations_and_save_processed_match_jax(ragged, tmp_path):
    rng = np.random.default_rng(8)
    if ragged:
        temporal = _ragged(8, n=30, channels=4)
    else:
        temporal = rng.normal(size=(30, 6, 4)).astype(np.float32)
        temporal[..., 0] = np.arange(6)
    static = rng.normal(size=(30, 3))
    strat = rng.integers(0, 2, 30)
    got = common.process_all_interpolations(static, temporal, strat)
    want = jax_common.process_all_interpolations(static, temporal, strat)
    _same_processed(got, want)
    labels = rng.integers(0, 2, (30, 1)).astype(np.float32)
    pg = common.save_processed(got, labels, str(tmp_path / "port"))
    pw = jax_common.save_processed(want, labels, str(tmp_path / "jax"))
    _same_npz(pg, pw)


def _same_npz(got_path, want_path):
    got, want = (np.load(p, allow_pickle=True) for p in (got_path, want_path))
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        g, w = got[key], want[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == object:
            _equal_lists(list(g), list(w), err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# ------------------------------------------------------------------ splits


def _labels(kind, n, rng):
    if kind == "none":
        return None
    if kind == "binary":
        return rng.integers(0, 2, n)
    if kind == "multiclass":
        return rng.integers(0, 5, n)
    if kind == "strings":
        return np.array(["sepsis", "ok", "vent"])[rng.integers(0, 3, n)]
    if kind == "rare_class":       # one member: the unstratified fallback
        y = rng.integers(0, 2, n).astype(np.float64)
        y[0] = 7.0
        return y
    if kind == "float_binary":
        return (rng.uniform(size=n) < 0.3).astype(np.float32)
    if kind == "rows":             # 2-D labels, one class per distinct row
        return rng.integers(0, 2, (n, 2))
    if kind == "nan":              # check_array refuses NaN: the fallback
        y = rng.integers(0, 2, n).astype(np.float64)
        y[n // 2] = np.nan
        return y
    raise ValueError(kind)


def _split(fn, n, y, seed, fractions):
    if seed is None:
        np.random.seed(3)
    try:
        return [a.tolist() for a in fn(n, y, fractions=fractions, seed=seed)]
    except (ValueError, TypeError) as exc:
        return type(exc).__name__


LABEL_KINDS = ("none", "binary", "multiclass", "strings", "rare_class", "float_binary",
               "rows", "nan")


@pytest.mark.parametrize("kind", LABEL_KINDS)
@pytest.mark.parametrize("fractions", [(0.70, 0.15, 0.15), (0.8, 0.1, 0.1), (0.5, 0.3, 0.2)])
def test_split_equals_scikit_learn(kind, fractions):
    """Every length 1..40 (the tiny ones raise, or fall back, where
    scikit-learn does) and a few larger, seeds 0, 1, 5 and None."""
    rng = np.random.default_rng(hash((kind, fractions)) % 2**32)
    for n in list(range(1, 41)) + [57, 100, 333, 1001]:
        y = _labels(kind, n, rng)
        for seed in (0, 1, 5, None):
            want = _split(jax_common.train_val_test_indices, n, y, seed, fractions)
            got = _split(common.train_val_test_indices, n, y, seed, fractions)
            assert got == want, (kind, n, seed)


def test_split_of_the_smoke_corpus_is_pinned(tmp_path):
    """The ``data`` phase of ``chip_smoke.py`` splits its Sepsis corpus
    (4,096 synthetic patients, 20 features, seed 0, after the exclusions)
    on the per-series max label, on a machine with no scikit-learn, and
    holds the indices to this digest of scikit-learn's."""
    raw = np.load(jax_mimic.synthesize_reduced_format(
        str(tmp_path / "reduced.npz"), num_patients=chip_smoke.DATA_PATIENTS,
        n_features=chip_smoke.DATA_FEATURES, seed=chip_smoke.DATA_SEED), allow_pickle=True)
    temporal = [np.asarray(t, np.float32) for t in raw["temporal_data"]]
    labels = [np.asarray(lab, np.float32) for lab in raw["sepsis_data"]]
    _, _, labels = mimic.perform_exclusions("Sepsis", np.asarray(raw["static_data"]),
                                            temporal, labels)
    strat = np.array([lab.max() for lab in labels])
    want = jax_common.train_val_test_indices(len(strat), strat)
    got = common.train_val_test_indices(len(strat), strat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert chip_smoke.split_digest(want) == chip_smoke.SEPSIS_SPLIT_SHA256
    assert chip_smoke.split_digest(got) == chip_smoke.SEPSIS_SPLIT_SHA256


def test_split_digest_separates_the_parts():
    a = [np.arange(3), np.arange(3, 5), np.arange(5, 6)]
    b = [np.arange(2), np.arange(2, 5), np.arange(5, 6)]
    assert chip_smoke.split_digest(a) != chip_smoke.split_digest(b)
    assert chip_smoke.split_digest(a) == hashlib.sha256(
        b"".join(np.int64(len(p)).tobytes() + p.astype("<i8").tobytes() for p in a)
    ).hexdigest()


# ----------------------------------------------------------------- loader


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """Sepsis (online) and Mortality (one-shot) npz files written by the
    JAX package from one synthetic corpus."""
    root = tmp_path_factory.mktemp("mimic")
    raw = jax_mimic.synthesize_reduced_format(str(root / "reduced.npz"),
                                              num_patients=48, seed=3)
    return {name: jax_mimic.prepare_task(name, raw, str(root / "jax"))
            for name in ("Sepsis", "Mortality")}


def _same_loaded(got, want, exact=True):
    for field in ("input_dim", "output_dim", "static_dim", "model_interpolation",
                  "return_sequences"):
        assert getattr(got, field) == getattr(want, field), field
    if want.static is None:
        assert got.static is None
    else:
        np.testing.assert_array_equal(got.static, want.static)
    tg, tw = got.temporal, want.temporal
    assert isinstance(tg, list) == isinstance(tw, list)
    _equal_lists(list(tg), list(tw), exact=exact, err_msg="temporal")
    lg, lw = got.labels, want.labels
    assert isinstance(lg, list) == isinstance(lw, list)
    _equal_lists(list(lg), list(lw), err_msg="labels")


LOAD_CASES = [("Sepsis", "rectilinear", "online"), ("Sepsis", "rectilinear-intensity", "online"),
              ("Sepsis", "hermite", "online"), ("Sepsis", "cubic", "online"),
              ("Sepsis", "linear_forward_fill", "online"), ("Mortality", "logsig-2-8", None)]


@pytest.mark.parametrize("use_static", [True, False])
@pytest.mark.parametrize("task,key,problem", LOAD_CASES)
def test_load_numpy_data_matches_jax(processed, task, key, problem, use_static):
    got = loader.load_numpy_data(processed[task], key, use_static=use_static,
                                 problem=problem, device="cpu")
    want = jax_loader.load_numpy_data(processed[task], key, use_static=use_static,
                                      problem=problem)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_loaded(g, w, exact=not key.startswith("logsig"))


def test_load_numpy_data_refuses_logsig_for_online_labels(processed):
    with pytest.raises(ValueError, match="one-shot"):
        loader.load_numpy_data(processed["Sepsis"], "logsig-2-8", problem="online",
                               device="cpu")


@pytest.mark.parametrize("task,key,problem", [
    ("Sepsis", "rectilinear", "online"), ("Sepsis", "hermite", "online"),
    ("Sepsis", "linear_forward_fill", "online"), ("Mortality", "rectilinear", None),
    ("Mortality", "cubic", None)])
def test_batches_match_jax(processed, task, key, problem):
    got_split = loader.load_numpy_data(processed[task], key, problem=problem, device="cpu")[0]
    want_split = jax_loader.load_numpy_data(processed[task], key, problem=problem)[0]
    got = list(loader.Batches(got_split, batch_size=7))
    want = list(jax_loader.Batches(want_split, batch_size=7))
    assert len(got) == len(want) == len(loader.Batches(got_split, batch_size=7))
    for (gi, gl), (wi, wl) in zip(got, want):
        for g, w in zip(gi, wi):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert gl.dtype == wl.dtype
        np.testing.assert_array_equal(gl, wl)


def test_loader_helpers_match_jax():
    for key in ("linear", "rectilinear", "cubic", "rectilinear-intensity",
                "linear_cubic_smoothing", "linear_quintic_smoothing",
                "linear_forward_fill", "cubic_forward_fill", "hermite", "logsig-3-4", None):
        assert loader.parse_interpolation_string(key) == \
            jax_loader.parse_interpolation_string(key)
    with pytest.raises(NotImplementedError):
        loader.parse_interpolation_string("quartic")
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(5, 3)).astype(np.float32)
    raw[:, 0] = np.arange(5)
    raw[2, 1] = np.nan
    rect = rng.normal(size=(9, 3)).astype(np.float32)
    np.testing.assert_array_equal(loader.add_rectilinear_intensity(rect, raw),
                                  jax_loader.add_rectilinear_intensity(rect, raw))
    series = _ragged(2)
    static = rng.normal(size=(len(series), 2))
    labels = list(range(len(series)))
    got = loader.sort_unequal_lengths(static, series, labels)
    want = jax_loader.sort_unequal_lengths(static, series, labels)
    np.testing.assert_array_equal(got[0], want[0])
    _equal_lists(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]


# ------------------------------------------------------------------ mimic


def test_synthesize_reduced_format_matches_jax(tmp_path):
    got = np.load(mimic.synthesize_reduced_format(str(tmp_path / "p.npz"), 30, 4, seed=2),
                  allow_pickle=True)
    want = np.load(jax_mimic.synthesize_reduced_format(str(tmp_path / "j.npz"), 30, 4,
                                                       seed=2), allow_pickle=True)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        if want[key].dtype == object:
            _equal_lists(list(got[key]), list(want[key]), err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("task", ["Sepsis", "Mortality", "LOS", "Ventilation"])
def test_prepare_task_writes_the_jax_npz(task, tmp_path):
    raw = mimic.synthesize_reduced_format(str(tmp_path / "reduced.npz"), 40, seed=1)
    got = mimic.prepare_task(task, raw, str(tmp_path / "port"))
    want = jax_mimic.prepare_task(task, raw, str(tmp_path / "jax"))
    assert got.replace(str(tmp_path / "port"), "") == want.replace(str(tmp_path / "jax"), "")
    _same_npz(got, want)


def test_mimic_exclusions_match_jax():
    rng = np.random.default_rng(4)
    times = np.arange(0.0, 40.0)
    temporal = [np.stack([times, rng.normal(size=40)], 1) for _ in range(3)]
    vent = np.zeros(40)
    vent[30:] = 2.0
    sep = np.zeros(40)
    sep[20:] = 1.0
    for name, labels in (("Ventilation", [np.stack([times, vent], 1)] * 3),
                         ("Sepsis", [np.stack([times, sep], 1)] * 3),
                         ("LOS", np.array([3.0, 4.0, 5.0])),
                         ("Mortality", np.array([0.0, 1.0, 1.0]))):
        got = mimic.perform_exclusions(name, np.zeros((3, 2)), list(temporal),
                                       list(labels) if isinstance(labels, list) else labels)
        want = jax_mimic.perform_exclusions(name, np.zeros((3, 2)), list(temporal),
                                            list(labels) if isinstance(labels, list)
                                            else labels)
        np.testing.assert_array_equal(got[0], want[0])
        _equal_lists(got[1], want[1], err_msg=name)
        _equal_lists(list(got[2]), list(want[2]), err_msg=name)


# ------------------------------------------------------------ the slice

SLICE_H = 16


def test_slice_prepared_sepsis_trains_like_jax(tmp_path):
    """Synthesize a corpus, prepare Sepsis, load it rectilinear with
    statics, batch it, and take two Adam steps of a narrow flagship-shaped
    NCDE on each side from the same weights."""
    raw = mimic.synthesize_reduced_format(str(tmp_path / "reduced.npz"), 48, n_features=20,
                                          seed=0)
    got_path = mimic.prepare_task("Sepsis", raw, str(tmp_path / "port"))
    want_path = jax_mimic.prepare_task("Sepsis", raw, str(tmp_path / "jax"))
    _same_npz(got_path, want_path)
    train = loader.load_numpy_data(got_path, "rectilinear", use_static=True,
                                   problem="online", device="cpu")[0]
    jtrain = jax_loader.load_numpy_data(want_path, "rectilinear", use_static=True,
                                        problem="online")[0]
    assert (train.input_dim, train.static_dim) == (21, 7)
    batches = list(loader.Batches(train, batch_size=8))[:2]
    jbatches = list(jax_loader.Batches(jtrain, batch_size=8))[:2]

    kw = dict(input_dim=21, hidden_dim=SLICE_H, output_dim=1, static_dim=7,
              hidden_hidden_dim=SLICE_H, num_layers=2, interpolation="rectilinear",
              solver="rk4", return_sequences=True)
    jm = JaxNeuralCDE(**kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = NeuralCDE(**kw, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    jstep = jax_loop.make_train_step(jm, loss="bce", lr=5e-4, donate=False)
    jstate = jax_loop.init_adam_state(jparams)
    tstep = loop.make_train_step(tm, loss="bce", lr=5e-4)
    for ((static, coeffs), labels), ((jstatic, jcoeffs), jlabels) in zip(batches, jbatches):
        np.testing.assert_array_equal(coeffs, jcoeffs)
        np.testing.assert_array_equal(labels, jlabels)
        jparams, jstate, want = jstep(jparams, jstate, (jnp.asarray(jstatic),
                                                        jnp.asarray(jcoeffs)),
                                      jnp.asarray(jlabels), 1.0)
        got = tstep((torch.from_numpy(static), torch.from_numpy(coeffs)),
                    torch.from_numpy(labels), 1.0)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        flat = flatten_tree(jax.tree.map(np.asarray, jparams))
        for name, p in tm.state_dict().items():
            w = flat[name]
            np.testing.assert_allclose(p.numpy(), w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max(), err_msg=name)
