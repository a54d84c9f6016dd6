"""Parity of the port's raw-archive builders (ROADMAP item 16b) against the
JAX package, on the CPU: the ``.ts`` reader, the MFCC front end, the MIMIC
BigQuery-export pipeline (numpy and ``csv`` in the port, pandas in the
JAX package), the builders' npz files, the download helpers under a mocked
transport and the missing-file refusals.

The same seeded fixtures go through both sides: the JAX package's own
pandas fixture (``tests/test_raw_builders.py``) and ``chip_smoke.py``'s
standard-library writers, which the smoke run's ``raw_data`` phase uses.
Tolerances: the ``.ts`` reader, every MIMIC stage and array, and the
CharacterTrajectories and TSR npz files exactly (equal bits, NaN where
NaN); the MFCC stages in float64 at rtol 1e-9 (pocketfft through
``torch.stft`` against numpy's rfft), its float32 output at rtol 1e-6, and
the SpeechCommands npz's coefficients at float32 rtol 1e-5 (its labels and
splits exactly).
"""

import io
import os
import tarfile
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from online_neural_cdes_tpu.data import audio as jax_audio
from online_neural_cdes_tpu.data import builders as jax_builders
from online_neural_cdes_tpu.data import mimic as jax_mimic
from online_neural_cdes_tpu.data import mimic_raw as jax_raw
from online_neural_cdes_tpu.data import ts_format as jax_ts
from online_neural_cdes_tpu_torch.data import audio, builders, download, mimic, mimic_raw
from online_neural_cdes_tpu_torch.data import ts_format
from test_raw_builders import _synthetic_bigquery_csv

torch.set_num_threads(1)

MFCC_STAGE_RTOL = 1e-9
MFCC_RTOL, MFCC_ATOL = 1e-6, 1e-6
SPEECH_RTOL, SPEECH_ATOL = 1e-5, 1e-6


def _same(got, want, what=""):
    """Equal arrays (NaN where NaN), object arrays element by element."""
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == object:
        assert got.dtype == object and got.shape == want.shape, what
        for i, (g, w) in enumerate(zip(got.reshape(-1), want.reshape(-1))):
            _same(g, w, f"{what}[{i}]")
        return
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)


# ----------------------------------------------------------------- ts_format

TS_CASES = {
    "plain_classification_ragged_missing": (
        "@problemName X\n@classLabel true a b\n@data\n"
        "1.0,2.0,?:5.0,6.0,7.0:a\n# a comment\n\n0.5:?,1.25,-3e-2,4:b\n"),
    "plain_regression": (
        "@targetLabel true\n@data\n1,2:3,4:12.5\n?,?:0.25,1e3:-7\n"),
    "plain_unlabelled": "@data\n1,2,3\n4,5\n",
    "timestamped_epoch_scale": (
        "@timestamps true\n@classLabel true x y\n@data\n"
        "(1700000000,1.0),(1700000077,2.0):(1700000013,?),(1700000077,6.0):x\n"
        "(1700000100.5,3.0):(1700000100.5,4.0),(1700000230,5.0):y\n"),
    "timestamped_dates_empty_dimension": (
        "@timestamps true\n@classLabel true p q\n@data\n"
        "(2020-01-01 00:00:00,1.0),(2020-01-01 00:01:30,2.0)::"
        "(2020-01-01 00:00:45,5.0):p\n"
        "('2020-01-02 10:00:00',?)::(2020-01-02 10:00:00,1.5):q\n"),
}


@pytest.mark.parametrize("case", sorted(TS_CASES))
def test_ts_reader_matches_jax(case, tmp_path):
    path = tmp_path / f"{case}.ts"
    path.write_text(TS_CASES[case])
    got_series, got_labels = ts_format.load_ts_file(str(path))
    want_series, want_labels = jax_ts.load_ts_file(str(path))
    assert got_labels == want_labels
    assert len(got_series) == len(want_series)
    for i, (g, w) in enumerate(zip(got_series, want_series)):
        _same(g, w, f"{case} case {i}")


def test_ts_reader_keeps_empty_dimensions_and_rebases_epoch_stamps(tmp_path):
    """The two fixes of the JAX reader: an empty '::' dimension is its own
    all-NaN column, and epoch-scale stamps are rebased in float64 before
    the float32 cast (so 77 s steps stay distinct knots)."""
    path = tmp_path / "stamped.ts"
    chip_smoke.write_timestamped_ts(str(path), cases=6, seed=3)
    series, labels = ts_format.load_ts_file(str(path))
    want, want_labels = jax_ts.load_ts_file(str(path))
    assert labels == want_labels == ["a", "b"] * 3
    for s, w in zip(series, want):
        _same(s, w)
        assert s.shape[1] == 4 and np.isnan(s[:, 2]).all()
        assert s[0, 0] == 0.0 and (np.diff(s[:, 0]) > 0).all()


def test_ts_reader_refuses_a_timestamped_case_without_its_label(tmp_path):
    path = tmp_path / "bad.ts"
    path.write_text("@timestamps true\n@classLabel true a\n@data\n(0,1.0),(1,2.0)\n")
    with pytest.raises(ValueError, match="missing label field"):
        ts_format.load_ts_file(str(path))


# --------------------------------------------------------------------- audio


@pytest.mark.parametrize("shape", [(1000,), (3, 1000), (2, 2, 777)])
def test_stft_power_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape)
    got = audio._stft_power(torch.from_numpy(x), 360, 180).numpy()
    want = jax_audio._stft_power(x, 360, 180)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=MFCC_STAGE_RTOL, atol=1e-10)


@pytest.mark.parametrize("n_freqs,n_mels,rate", [(181, 32, 16000), (201, 40, 8000)])
def test_mel_filterbank_matches_jax(n_freqs, n_mels, rate):
    got = audio.mel_filterbank(n_freqs, n_mels, rate, device="cpu").numpy()
    want = jax_audio.mel_filterbank(n_freqs, n_mels, rate)
    np.testing.assert_allclose(got, want, rtol=MFCC_STAGE_RTOL, atol=1e-12)


@pytest.mark.parametrize("n_mfcc,n_mels", [(10, 32), (13, 40), (32, 32)])
def test_dct_matches_jax(n_mfcc, n_mels):
    got = audio._dct2_ortho(n_mfcc, n_mels, device="cpu").numpy()
    np.testing.assert_allclose(got, jax_audio._dct2_ortho(n_mfcc, n_mels), atol=1e-14)


@pytest.mark.parametrize("log_mels", [True, False])
def test_mfcc_matches_jax_in_float64_and_float32(log_mels):
    """Every stage composed in float64 against the JAX module's stages at
    rtol 1e-9; the float32 result at rtol 1e-6 (a float64 difference of
    ~1e-13 may round to the neighbouring float32)."""
    x = np.random.default_rng(1).normal(size=(4, 16000)) * 0.3
    feats = audio._features(x, 16000, 360, 180, 32, 10, log_mels, "cpu",
                            torch.float64).numpy()
    mels = np.einsum("...ft,fm->...mt", jax_audio._stft_power(x, 360, 180),
                     jax_audio.mel_filterbank(181, 32, 16000))
    logs = np.log(mels + 1e-6) if log_mels else 10.0 * np.log10(np.maximum(mels, 1e-10))
    want64 = np.einsum("km,...mt->...kt", jax_audio._dct2_ortho(10, 32), logs)
    np.testing.assert_allclose(feats, want64, rtol=MFCC_STAGE_RTOL, atol=1e-9)
    got = audio.mfcc(x, log_mels=log_mels, device="cpu")
    want = jax_audio.mfcc(x, log_mels=log_mels)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (4, 89, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=MFCC_RTOL, atol=MFCC_ATOL)


def test_mfcc_needs_a_device_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        audio.mfcc(np.zeros(16000))


# ----------------------------------------------------------------- mimic_raw


def test_mimic_query_sql_ships_with_the_port():
    """The port carries the extraction SQL its MIMIC reader documents,
    byte for byte the JAX package's."""
    port = os.path.join(os.path.dirname(mimic_raw.__file__), "mimic_query.sql")
    with open(port, "rb") as fh:
        got = fh.read()
    with open(os.path.join(os.path.dirname(jax_raw.__file__), "mimic_query.sql"), "rb") as fh:
        assert got == fh.read()


def _export(tmp_path, kind):
    """A raw directory holding one BigQuery export: the JAX test's pandas
    fixture (nanosecond stamps) or chip_smoke's writer (microsecond stamps,
    bursts, nearby readings, readings before admission)."""
    raw = tmp_path / f"raw_{kind}"
    raw.mkdir()
    if kind == "pandas":
        _synthetic_bigquery_csv(str(raw / "export_0.csv"), n_patients=30, seed=4)
        _synthetic_bigquery_csv(str(raw / "export_1.csv"), n_patients=12, seed=5)
    else:
        chip_smoke.write_bigquery_export(str(raw / "export_0.csv"), 48, seed=6)
    return str(raw)


def _same_frame(got: dict, want: pd.DataFrame, what=""):
    """A port frame (dict of columns) against a pandas frame: the same
    column names in order; numbers as float64 or int64 exactly, strings
    with missing values as NaN, timestamps to the nanosecond."""
    assert list(got) == list(want.columns), what
    for col in want.columns:
        w = want[col]
        g = got[col]
        assert len(g) == len(w), f"{what}{col}"
        if pd.api.types.is_datetime64_any_dtype(w):
            np.testing.assert_array_equal(g.astype("datetime64[ns]"),
                                          w.to_numpy().astype("datetime64[ns]"),
                                          err_msg=f"{what}{col}")
        elif pd.api.types.is_numeric_dtype(w) and not pd.api.types.is_bool_dtype(w):
            _same(g, w.to_numpy(), f"{what}{col}")
        else:
            assert [None if pd.isna(v) else v for v in g] == \
                [None if pd.isna(v) else v for v in w], f"{what}{col}"


@pytest.mark.parametrize("kind", ["pandas", "stdlib"])
def test_mimic_stages_match_jax(kind, tmp_path):
    """Each stage of build_reduced_format on both sides' previous output:
    read_csv's types, to_datetime and total_seconds, the time filter, the
    ventilation codes, factorize, the stable time sort, the continuous-
    monitoring and nearby-vitals windows, groupby.first's statics."""
    raw = _export(tmp_path, kind)
    want = jax_raw.combine_csvs(raw)
    got = mimic_raw.combine_csvs(raw)
    _same_frame(got, want, "combine: ")

    renames = {"stay_id": "id", "hospital_expire_flag": "mortality"}
    want = jax_raw.build_times(want.rename(columns=renames))
    got = mimic_raw.build_times({renames.get(k, k): v for k, v in got.items()})
    _same_frame(got, want, "times: ")

    want = want[want["time"] > 0]
    with np.errstate(invalid="ignore"):
        got = {k: v[got["time"] > 0] for k, v in got.items()}
    want["ventilation"] = want["ventilation_status"].map(
        lambda v: jax_raw.VENT_CODES.get(v, 0) if isinstance(v, str) else 0).astype(float)
    got["ventilation"] = np.asarray([mimic_raw.VENT_CODES.get(v, 0) if isinstance(v, str)
                                     else 0 for v in got["ventilation_status"]], float)
    want = jax_raw.encode_categoricals(want.copy())
    got = mimic_raw.encode_categoricals(got)
    _same_frame(got, want, "categoricals: ")

    order = np.argsort(got["time"], kind="stable")
    want = want.sort_values("time", kind="stable")
    got = {k: v[order] for k, v in got.items()}
    _same_frame(got, want, "sorted: ")
    want = jax_raw.remove_continuously_monitored(want)
    got = mimic_raw.remove_continuously_monitored(got)
    _same_frame(got, want, "monitored: ")
    if kind == "stdlib":   # the writer's bursts are dropped
        assert len(np.unique(got["id"])) < 48

    static_want = want[["id"] + jax_raw.STATIC_FEATURES].groupby("id", as_index=True).first()
    static_got = mimic_raw._static_frame(got)
    _same_frame(static_got, static_want.reset_index(), "statics: ")

    cols = ["id"] + jax_raw.TEMPORAL_FEATURES
    merged_want = jax_raw.merge_nearby_vitals(want[cols])
    merged_got = mimic_raw.merge_nearby_vitals({c: got[c] for c in cols})
    _same_frame(merged_got, merged_want, "merged: ")
    if kind == "stdlib":   # the writer's nearby readings are merged
        assert len(merged_got["id"]) < len(got["id"])


def test_merge_and_monitoring_rules_match_jax_at_their_window_edges():
    """The JAX package's unit cases and the windows' edges: gaps of 2
    minutes exactly (not merged, not close) and just under, NaN features
    (mean skips them), an all-NaN sepsis run (last is NaN), and a mean
    whose plain sum differs from pandas' compensated one."""
    frame = pd.DataFrame({
        "id": [1, 1, 1, 2, 2, 2, 2],
        "time": [1.0, 1.016, 2.0, 0.5, 0.5 + 2.0 / 60, 0.5 + 3.9 / 60, 9.0],
        "heart_rate": [80.0, 90.0, 100.0, 0.1, 0.2, 0.3, np.nan],
        "sbp": [np.nan, 120.0, np.nan, np.nan, np.nan, 1.0, 2.0],
        "ventilation": [0.0, 1.0, 0.0, 2.0, np.nan, np.nan, 1.0],
        "sepsis": [np.nan, np.nan, np.nan, 3.0, np.nan, np.nan, np.nan],
    })
    want = jax_raw.merge_nearby_vitals(frame)
    got = mimic_raw.merge_nearby_vitals({c: frame[c].to_numpy() for c in frame.columns})
    _same_frame(got, want)
    assert got["heart_rate"][0] == 85.0 and got["time"][0] == 1.016

    minutes = np.r_[np.arange(6) * 1.999, 20.0]
    for gap_rule in (minutes, np.arange(7) * 2.0, np.arange(5) * 1.0):
        times = np.concatenate([gap_rule / 60.0, np.arange(10.0)])
        ids = [1] * len(gap_rule) + [2] * 10
        frame = pd.DataFrame({"id": ids, "time": times})
        want = jax_raw.remove_continuously_monitored(frame)
        got = mimic_raw.remove_continuously_monitored({"id": np.asarray(ids),
                                                       "time": times})
        _same_frame(got, want)


def _same_npz(got_path, want_path, rtol=None, atol=0.0, exact=()):
    with np.load(got_path, allow_pickle=True) as got, \
            np.load(want_path, allow_pickle=True) as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            g, w = got[key], want[key]
            if rtol is None or key in exact or w.dtype.kind not in "fO":
                _same(g, w, key)
            elif w.dtype == object:
                assert g.shape == w.shape, key
                for i, (a, b) in enumerate(zip(g, w)):
                    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                               err_msg=f"{key}[{i}]")
            else:
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("kind", ["pandas", "stdlib"])
def test_build_reduced_format_and_prepare_all_match_jax(kind, tmp_path):
    """The whole pipeline: the reduced format bit for bit, then every MIMIC
    task prepared from each side's file bit for bit."""
    raw = _export(tmp_path, kind)
    got = mimic_raw.build_reduced_format(raw, out_path=str(tmp_path / "port.npz"))
    want = jax_raw.build_reduced_format(raw, out_path=str(tmp_path / "jax.npz"))
    _same_npz(got, want)
    with np.load(got, allow_pickle=True) as npz:
        # DataFrame.to_numpy's layout, which the corpus statistics sum over.
        assert all(t.flags["F_CONTIGUOUS"] for t in npz["temporal_data"])
    got_tasks = mimic.prepare_all(got, out_root=str(tmp_path / "port"))
    want_tasks = jax_mimic.prepare_all(want, out_root=str(tmp_path / "jax"))
    assert sorted(got_tasks) == sorted(want_tasks)
    for task in want_tasks:
        _same_npz(got_tasks[task], want_tasks[task])


def test_mimic_refuses_a_directory_without_exports(tmp_path):
    with pytest.raises(FileNotFoundError) as got:
        mimic_raw.build_reduced_format(str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jax_raw.build_reduced_format(str(tmp_path))
    assert str(got.value) == str(want.value)


def test_read_csv_infers_pandas_types(tmp_path):
    path = tmp_path / "types.csv"
    path.write_text('i,g,f,s,e,b,q\n1,1,1.5,x,,True,"a,b"\n-2,,2e3,NA,,False,\n'
                    '3,4,nan,y,,True,c\n')
    got = mimic_raw.read_csv(str(path))
    want = pd.read_csv(str(path))
    _same_frame(got, want)
    assert got["i"].dtype == np.int64 and got["g"].dtype == np.float64
    assert got["b"].dtype == bool


# ------------------------------------------------------------------ builders


def test_character_trajectories_builder_matches_jax(tmp_path):
    raw = str(tmp_path / "UEA")
    chip_smoke.write_character_trajectories(raw, (30, 26), seed=1)
    got = builders.build_character_trajectories(root=str(tmp_path / "port"), raw_dir=raw)
    want = jax_builders.build_character_trajectories(root=str(tmp_path / "jax"), raw_dir=raw)
    _same_npz(got, want)
    with np.load(got, allow_pickle=True) as npz:
        assert npz["temporal_data_raw"].shape[0] == 56
        assert set(np.unique(npz["labels"])) <= set(range(20))
        assert npz["temporal_data_raw"][0].shape[1] == 4   # time + 3 dimensions


@pytest.mark.parametrize("name", ["BeijingPM2pt5", "BeijingPM10"])
def test_tsr_builder_and_cli_match_jax(name, tmp_path):
    raw = str(tmp_path / "TSR")
    chip_smoke.write_tser(raw, name, 40, seed=2)
    got = builders.main([name, "--root", str(tmp_path / "port"), "--raw-dir", raw])
    want = jax_builders.build_tsr(name, root=str(tmp_path / "jax"), raw_dir=raw)
    assert got.endswith(f"TSR/{name}/improved-neural-cdes_data.npz")
    _same_npz(got, want)


def test_speech_commands_builder_matches_jax(tmp_path):
    """Short clips are dropped; the MFCCs (port on the CPU) against numpy's
    at float32 rtol 1e-5 after normalisation and interpolation; the labels
    and splits exactly."""
    raw = str(tmp_path / "SpeechCommands")
    chip_smoke.write_speech_commands(raw, per_class=3, short_per_class=1, seed=3)
    got = builders.build_speech_commands(root=str(tmp_path / "port"), raw_dir=raw,
                                         device="cpu")
    want = jax_builders.build_speech_commands(root=str(tmp_path / "jax"), raw_dir=raw)
    _same_npz(got, want, rtol=SPEECH_RTOL, atol=SPEECH_ATOL,
              exact=("labels", "train_idxs", "val_idxs", "test_idxs"))
    with np.load(got, allow_pickle=True) as npz:
        assert npz["temporal_data_linear"].shape[:1] == (30,)
        assert npz["temporal_data_raw"].shape[1:] == (89, 11)   # time + 10 MFCC
        assert set(np.unique(npz["labels"])) == set(range(10))


@pytest.mark.parametrize("name", ["character_trajectories", "speech_commands", "BeijingPM10"])
def test_builders_refuse_missing_raw_files_with_the_jax_wording(name, tmp_path):
    raw = str(tmp_path / "absent")

    def build(module):
        if name.startswith("Beijing"):
            return module.build_tsr(name, root=str(tmp_path), raw_dir=raw)
        return module.BUILDERS[name](root=str(tmp_path), raw_dir=raw)

    with pytest.raises(FileNotFoundError) as got:
        build(builders)
    with pytest.raises(FileNotFoundError) as want:
        build(jax_builders)
    assert str(got.value) == str(want.value)
    assert set(builders.BUILDERS) == set(jax_builders.BUILDERS)


# ------------------------------------------------------------------ download


def test_download_helpers_with_mocked_transport(monkeypatch, tmp_path):
    """The JAX test's protocol on the port's helpers: urlretrieve is mocked
    to write a real zip; extraction, the already-present short-circuit and
    untar's data filter run for real.  Nothing touches the network."""
    calls = []

    def fake_urlretrieve(url, loc):
        calls.append(url)
        with zipfile.ZipFile(loc, "w") as zf:
            zf.writestr("Data_TRAIN.ts", "@classLabel true a\n@data\n1.0:a\n")

    monkeypatch.setattr("urllib.request.urlretrieve", fake_urlretrieve)
    folder = str(tmp_path / "uea")
    loc = download.download_zip(folder, "Data", download.UEA_URL.format(name="Data"))
    assert loc and calls == [download.UEA_URL.format(name="Data")]
    series, labels = ts_format.load_ts_file(os.path.join(folder, "Data_TRAIN.ts"))
    assert labels == ["a"] and series[0].shape == (1, 1)
    assert download.download_zip(folder, "Data", "http://never-hit") is None
    assert calls == [download.UEA_URL.format(name="Data")]

    tar_path = str(tmp_path / "sc.tar.gz")
    payload = io.BytesIO(b"audio")
    with tarfile.open(tar_path, "w:gz") as tf:
        info = tarfile.TarInfo("speech/yes/a.wav")
        info.size = len(payload.getvalue())
        tf.addfile(info, payload)
        evil = tarfile.TarInfo("../escape.wav")
        evil.size = 0
        tf.addfile(evil, io.BytesIO(b""))
    out = str(tmp_path / "sc")
    with pytest.raises(tarfile.OutsideDestinationError):
        download.untar(tar_path, out)
    assert not os.path.exists(tmp_path / "escape.wav")

    assert download.mkdir_if_not_exists(str(tmp_path / "new")) is False
    assert download.mkdir_if_not_exists(str(tmp_path / "new")) is True
    assert download.SPEECH_COMMANDS_URL == \
        "http://download.tensorflow.org/data/speech_commands_v0.02.tar.gz"
