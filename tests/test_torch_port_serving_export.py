"""The port's exported serving artifacts (``serving_export``) against the
live port servers and the JAX package's artifacts, on the CPU.

Every case of the JAX package's ``tests/test_serving_export.py`` has a
counterpart here: a loaded predictor or stepper artifact serves the live
server's outputs to the bit (float32), and the same requests through the
port's loaded artifact and JAX's loaded artifact, for the same weights
(JAX ``init`` crossed with ``params_from_jax``), agree at rtol 1e-5,
atol 1e-6 (float32 round-off over the RK intervals).  ``params.npz``
equals JAX's leaf for leaf and bit for bit, float32 and bfloat16, and the
manifests have JAX's keys.  The mesh cases run over two gloo ranks, one
spawn for the module (``chip_smoke.export_mesh_checks``, which the smoke
run's ``parallel`` phase runs on the card): served rows over a mesh equal
one process's at rtol 1e-6 (JAX's sharded-serving tolerance).  Artifacts
are shared between tests through module fixtures and copied before a test
changes one.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops.interpolation import (
    linear_interpolation_coeffs as jax_coeffs,
)
from online_neural_cdes_tpu.serving import OnlineNCDEStepper as JaxStepper
from online_neural_cdes_tpu.serving import Predictor as JaxPredictor
from online_neural_cdes_tpu import serving_export as jax_export
from online_neural_cdes_tpu_torch import (
    NeuralCDE, OnlineNCDEStepper, Predictor, linear_interpolation_coeffs, params_from_jax,
)
from online_neural_cdes_tpu_torch.serving_export import (
    export_predictor, export_stepper, load_predictor, load_stepper, update_params,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6          # against JAX's artifact
MESH_RTOL, MESH_ATOL = 1e-6, 1e-6
BF16_RTOL, BF16_ATOL = 0.05, 0.05
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRED_KW = dict(input_dim=3, hidden_dim=6, output_dim=2, num_layers=1, interpolation="linear",
               adjoint=False, solver="rk4")
STEP_KW = dict(input_dim=3, hidden_dim=8, output_dim=2, hidden_hidden_dim=12, num_layers=1,
               interpolation="rectilinear", return_sequences=True, adjoint=False,
               solver="rk4")
B, ODD = 4, 3                     # stream counts: one divides two ranks, one does not


def _pair(kw, seed=0):
    """A JAX model and its init, and the port's model with those weights."""
    jm = JaxNeuralCDE(**kw)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = NeuralCDE(**kw, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    return jm, jparams, tm


def _predictor(return_sequences=False, static_dim=None, seed=0, buckets=(2, 4)):
    jm, jparams, tm = _pair(dict(PRED_KW, return_sequences=return_sequences,
                                 static_dim=static_dim), seed)
    kw = dict(batch_buckets=buckets, length_multiple=8)
    return (Predictor(tm, coeff_fn=linear_interpolation_coeffs, device="cpu", **kw),
            JaxPredictor(jm, jparams, coeff_fn=lambda x: jax_coeffs(x), **kw))


def _requests(n, seed=0, max_len=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(4, max_len))
        s = rng.normal(size=(L, 3)).astype(np.float32)
        s[:, 0] = np.arange(L)
        out.append(s)
    return out


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _copy(src, tmp_path, name="art"):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


@pytest.fixture(scope="module")
def pred_art(tmp_path_factory):
    """The basic predictor (buckets (2, 4), length 8) exported by the port
    and by JAX from the same weights."""
    pred, jpred = _predictor()
    root = tmp_path_factory.mktemp("pred")
    n = export_predictor(pred, str(root / "port"), channels=3, max_length=8)
    jax_export.export_predictor(jpred, str(root / "jax"), channels=3, max_length=8,
                                platforms=("cpu",))
    return {"pred": pred, "jpred": jpred, "path": str(root / "port"),
            "jax": str(root / "jax"), "n": n}


@pytest.fixture(scope="module")
def bf16_art(tmp_path_factory, pred_art):
    root = tmp_path_factory.mktemp("bf16")
    export_predictor(pred_art["pred"], str(root / "port"), channels=3, max_length=8,
                     params_dtype="bfloat16")
    jax_export.export_predictor(pred_art["jpred"], str(root / "jax"), channels=3,
                                max_length=8, platforms=("cpu",), params_dtype="bfloat16")
    return {"path": str(root / "port"), "jax": str(root / "jax")}


def _stepper(static_dim=None, n=B, seed=0):
    jm, jparams, tm = _pair(dict(STEP_KW, static_dim=static_dim), seed)
    static = (None if static_dim is None else
              np.random.default_rng(7).normal(size=(n, static_dim)).astype(np.float32))
    return (OnlineNCDEStepper(tm, static=static, device="cpu"),
            JaxStepper(jm, jparams, static=None if static is None else jnp.asarray(static)),
            static)


@pytest.fixture(scope="module")
def step_art(tmp_path_factory):
    """The stepper (stream counts 3 and 4, catch-up blocks of 4) exported by
    the port, and by JAX at 4 streams."""
    stepper, jstepper, _ = _stepper()
    root = tmp_path_factory.mktemp("step")
    n = export_stepper(stepper, str(root / "port"), batch_sizes=(ODD, B), channels=3,
                       block_sizes=(4,))
    jax_export.export_stepper(jstepper, str(root / "jax"), batch_sizes=(B,), channels=3,
                              platforms=("cpu",), block_sizes=(4,))
    return {"stepper": stepper, "jstepper": jstepper, "path": str(root / "port"),
            "jax": str(root / "jax"), "n": n}


@pytest.fixture(scope="module")
def static_step_art(tmp_path_factory):
    stepper, _, static = _stepper(static_dim=2)
    root = tmp_path_factory.mktemp("static_step")
    export_stepper(stepper, str(root), batch_sizes=(B,), channels=3)
    return {"stepper": stepper, "static": static, "path": str(root)}


def _stream(n, L, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, L, 3)).astype(np.float32)
    x[:, :, 0] = np.arange(L)
    x[1, 2, 1] = np.nan  # held value mid-stream
    return x


# ---------------------------------------------------------------------------
# The predictor
# ---------------------------------------------------------------------------


@pytest.mark.smoke
def test_roundtrip_matches_live_predictor(pred_art):
    """The loaded artifact serves what the live predictor serves, to the
    bit: ragged, batch-padded and chunked requests, predict and
    predict_many."""
    assert pred_art["n"] == 2   # batch buckets (2, 4) x length 8
    pred, loaded = pred_art["pred"], load_predictor(pred_art["path"], device="cpu")
    reqs = _requests(5, seed=1)  # 5 > top bucket 4: chunked
    _same(loaded.predict(reqs), pred.predict(reqs))
    for a, b in zip(loaded.predict_many([reqs[:2], reqs[2:]]),
                    pred.predict_many([reqs[:2], reqs[2:]])):
        _same(a, b)


def test_loaded_artifact_matches_jax_artifact(pred_art):
    """The port's loaded artifact against JAX's loaded artifact, the same
    weights and requests."""
    reqs = _requests(5, seed=1)
    got = load_predictor(pred_art["path"], device="cpu").predict(reqs)
    want = jax_export.load_predictor(pred_art["jax"]).predict(reqs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_params_npz_equals_jax_leaf_for_leaf(pred_art, bf16_art, kind):
    """params.npz holds JAX's leaves in JAX's order, bit for bit (bfloat16
    as its uint16 bit pattern), and the manifests name the same dtypes."""
    art = pred_art if kind == "float32" else bf16_art
    with np.load(os.path.join(art["path"], "params.npz")) as got, \
            np.load(os.path.join(art["jax"], "params.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    m_got = json.load(open(os.path.join(art["path"], "manifest.json")))
    m_want = json.load(open(os.path.join(art["jax"], "manifest.json")))
    assert m_got["leaf_dtypes"] == m_want["leaf_dtypes"]
    assert m_got["n_leaves"] == m_want["n_leaves"]


def test_manifests_have_jax_keys(pred_art, step_art):
    for art in (pred_art, step_art):
        got = json.load(open(os.path.join(art["path"], "manifest.json")))
        want = json.load(open(os.path.join(art["jax"], "manifest.json")))
        assert set(got) == set(want)
        assert got["platforms"] == ["cuda", "cpu"]
        assert got["treedef"] == [
            "field.out.b", "field.out.w", "field.trunk.0.b", "field.trunk.0.w",
            "final.b", "final.w", "initial.b", "initial.w"]


def test_roundtrip_sequence_outputs_and_manifest(tmp_path):
    """Sequence outputs come back truncated per request, and the manifest
    records the padding policy the loader reproduces."""
    pred, _ = _predictor(return_sequences=True, buckets=(4,))
    export_predictor(pred, str(tmp_path), channels=3, max_length=8)
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert manifest["return_sequences"] is True
    assert manifest["batch_buckets"] == [4]
    assert manifest["pad_forward_fill"] is True
    loaded = load_predictor(str(tmp_path), device="cpu")
    reqs = _requests(3, seed=2)
    for a, b in zip(pred.predict(reqs), loaded.predict(reqs)):
        assert b.shape == a.shape   # (L_i, 2) per request
        np.testing.assert_array_equal(a, b)


def test_an_exact_length_predictor_refuses_other_lengths_live_and_loaded(tmp_path):
    """``Predictor(exact_length=)`` (a global-spline build, which a length
    pad would change) has the one length bucket, whatever
    ``length_multiple`` says; the manifest records it, so the loaded
    predictor serves that length to the bit and, as the live one, refuses
    a shorter or a longer request instead of padding it."""
    _, _, tm = _pair(dict(PRED_KW, return_sequences=True))
    pred = Predictor(tm, coeff_fn=linear_interpolation_coeffs, batch_buckets=(2, 4),
                     length_multiple=8, exact_length=6, device="cpu")
    assert pred.bucket_grid(50) == [(2, 6), (4, 6)]
    assert export_predictor(pred, str(tmp_path), channels=3, max_length=6) == 2
    manifest = json.load(open(tmp_path / "manifest.json"))
    assert (manifest["exact_length"], manifest["max_length"]) == (6, 6)
    loaded = load_predictor(str(tmp_path), device="cpu")
    assert (loaded.exact_length, loaded.length_multiple) == (6, 6)
    rng = np.random.default_rng(4)
    reqs = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(3)]
    _same(loaded.predict(reqs), pred.predict(reqs))
    for p in (pred, loaded):
        for bad in ([reqs[0][:5]], [reqs[0], reqs[1][:4]],
                    [np.concatenate([reqs[0], reqs[0][-1:]])]):
            with pytest.raises(ValueError, match="exactly 6 observations"):
                p.predict(bad)


def test_static_features_roundtrip(tmp_path):
    pred, _ = _predictor(static_dim=4, buckets=(1, 4))
    export_predictor(pred, str(tmp_path), channels=3, max_length=8, static_dim=4)
    loaded = load_predictor(str(tmp_path), device="cpu")
    reqs = _requests(3, seed=3)
    static = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    _same(loaded.predict(reqs, static=static), pred.predict(reqs, static=static))
    # Bucket 1 runs the program traced at bucket 4 (its batch axis is dynamic).
    _same(loaded.predict(reqs[:1], static=static[:1]),
          pred.predict(reqs[:1], static=static[:1]))
    with pytest.raises(ValueError, match="static"):
        loaded.predict(reqs)


def test_out_of_grid_request_raises_with_recipe(pred_art):
    """The artifact has no model to trace again: an over-length request
    fails with the re-export recipe."""
    loaded = load_predictor(pred_art["path"], device="cpu")
    with pytest.raises(ValueError, match="re-export"):
        loaded.predict([np.zeros((12, 3), np.float32)])   # pads to 16 > 8


def test_mesh_predictor_rejected(pred_art):
    pred = Predictor(pred_art["pred"].model, coeff_fn=linear_interpolation_coeffs,
                     batch_buckets=(2, 4), length_multiple=8, device="cpu")
    pred.mesh = object()   # a mesh-sharded predictor
    with pytest.raises(ValueError, match="mesh"):
        export_predictor(pred, "/nonexistent", channels=3, max_length=8)


def test_update_params_rolls_checkpoint_without_reexport(pred_art, tmp_path):
    """A retrained same-architecture checkpoint rolls in by rewriting
    params.npz; another architecture is refused before anything is
    written."""
    path = _copy(pred_art["path"], tmp_path)
    fresh, _ = _predictor(seed=42)
    update_params(path, fresh.model.state_dict())
    reqs = _requests(2, seed=6)
    _same(load_predictor(path, device="cpu").predict(reqs), fresh.predict(reqs))
    other = NeuralCDE(**dict(PRED_KW, hidden_dim=12), device="cpu")
    with pytest.raises(ValueError, match="re-export"):
        update_params(path, other.state_dict())
    _same(load_predictor(path, device="cpu").predict(reqs), fresh.predict(reqs))


def test_reexport_removes_stale_shape_modules(tmp_path):
    """Exporting a smaller grid into the same directory leaves none of the
    old grid's modules to be served."""
    pred = Predictor(_TinyLinear(torch.ones(3, 2), torch.zeros(2)), batch_buckets=(2,),
                     length_multiple=8, device="cpu")
    export_predictor(pred, str(tmp_path), channels=3, max_length=16)
    export_predictor(pred, str(tmp_path), channels=3, max_length=8)
    assert os.listdir(tmp_path / "modules") == ["b2_l8.pt2"]
    with pytest.raises(ValueError, match="re-export"):
        load_predictor(str(tmp_path), device="cpu").predict([np.zeros((12, 3), np.float32)])


class _TinyLinear(torch.nn.Module):
    """A model for the weights-structure tests: two tensors, no NCDE."""

    return_sequences = False

    def __init__(self, w, b, names=("w", "b")):
        super().__init__()
        self.names = names
        self.params = torch.nn.ParameterDict({names[0]: w, names[1]: b})

    def forward(self, x):
        w, b = (self.params[n] for n in self.names)
        return x[:, -1] @ w.float() + b.float()


def test_update_params_rejects_renamed_tree_same_shapes(tmp_path):
    """The manifest's leaf names guard the structure: the same count,
    shapes and dtypes under other names are refused."""
    model = _TinyLinear(torch.ones(3, 2), torch.zeros(2))
    pred = Predictor(model, batch_buckets=(2,), length_multiple=8, device="cpu")
    export_predictor(pred, str(tmp_path), channels=3, max_length=8)
    renamed = {"params.weight": torch.ones(3, 2), "params.bias": torch.zeros(2)}
    with pytest.raises(ValueError, match="structure"):
        update_params(str(tmp_path), renamed)


def test_bfloat16_params_roundtrip(tmp_path):
    """Leaves numpy has no dtype for survive the artifact: stored as bit
    patterns, the manifest names the dtype, the loader views them back."""
    model = _TinyLinear(torch.ones(3, 2, dtype=torch.bfloat16) * 0.5, torch.zeros(2))
    pred = Predictor(model, batch_buckets=(2,), length_multiple=8, device="cpu")
    export_predictor(pred, str(tmp_path), channels=3, max_length=8)
    loaded = load_predictor(str(tmp_path), device="cpu")
    # The leaves in JAX order: [params.b (f32), params.w (bf16)].
    assert loaded.model._flat[1].dtype == torch.bfloat16
    reqs = [np.ones((8, 3), np.float32)] * 2
    _same(loaded.predict(reqs), pred.predict(reqs))


def test_recurrent_bundle_exports(tmp_path):
    """The zoo's serving path survives export: a gru-d bundle's
    prepare_batch (masks and deltas) is traced into the artifact."""
    from online_neural_cdes_tpu_torch.serving import predictor_from_bundle
    from online_neural_cdes_tpu_torch.training.harness import setup_model

    bundle = setup_model("gru-d", input_dim=3, output_dim=2, hidden_dim=6,
                         return_sequences=True, device="cpu")
    pred = predictor_from_bundle(bundle, bundle.init(0), batch_buckets=(2,),
                                 length_multiple=8)
    export_predictor(pred, str(tmp_path), channels=3, max_length=8)
    loaded = load_predictor(str(tmp_path), device="cpu")
    assert loaded.pad_forward_fill is False   # the NaN padding policy survived
    reqs = _requests(2, seed=4)
    _same(loaded.predict(reqs), pred.predict(reqs))


def test_bf16_params_export_roundtrip(pred_art, bf16_art, tmp_path):
    """params_dtype='bfloat16' halves the weight payload; the loaded
    predictor matches the float32 one to reduced-precision tolerance, and
    a float32 checkpoint rolls into the bf16 artifact."""
    def payload(d):
        with np.load(os.path.join(d, "params.npz")) as z:
            return sum(z[k].nbytes for k in z.files)

    assert payload(bf16_art["path"]) == payload(pred_art["path"]) // 2
    assert os.path.getsize(os.path.join(bf16_art["path"], "params.npz")) < \
        os.path.getsize(os.path.join(pred_art["path"], "params.npz"))
    reqs = _requests(3, seed=9)
    outs_f32 = load_predictor(pred_art["path"], device="cpu").predict(reqs)
    outs_bf16 = load_predictor(bf16_art["path"], device="cpu").predict(reqs)
    for a, b in zip(outs_bf16, outs_f32):
        np.testing.assert_allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL)
        assert not np.array_equal(a, b)   # really reduced precision
    jax_outs = jax_export.load_predictor(bf16_art["jax"]).predict(reqs)
    for a, b in zip(outs_bf16, jax_outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=BF16_RTOL, atol=BF16_ATOL)
    path = _copy(bf16_art["path"], tmp_path)
    assert update_params(path, pred_art["pred"].model.state_dict()) > 0
    _same(load_predictor(path, device="cpu").predict(reqs), outs_bf16)


def test_bf16_params_export_rejects_non_float_dtype(pred_art, tmp_path):
    with pytest.raises(ValueError, match="floating"):
        export_predictor(pred_art["pred"], str(tmp_path), channels=3, max_length=8,
                         params_dtype="int8")


def test_v1_artifact_still_loads_and_v2_is_stamped(pred_art, bf16_art, tmp_path):
    """The reader takes v1 artifacts (bfloat16 stored float32-upcast) and
    serves them alike; exports stamp v2; update_params of a v1 artifact
    with bfloat16 leaves stamps v2."""
    path = _copy(bf16_art["path"], tmp_path)
    manifest_path = os.path.join(path, "manifest.json")
    manifest = json.load(open(manifest_path))
    assert manifest["format_version"] == 2
    reqs = _requests(2, seed=21)
    v2_outs = load_predictor(path, device="cpu").predict(reqs)
    with np.load(os.path.join(path, "params.npz")) as z:
        f32up = {k: torch.from_numpy(z[k].view(np.int16).copy()).view(torch.bfloat16)
                 .float().numpy() for k in z.files}
    np.savez(os.path.join(path, "params.npz"), **f32up)
    manifest["format_version"] = 1
    manifest.pop("params_sha256", None)   # v1 predates the digests
    manifest.pop("module_sha256", None)
    json.dump(manifest, open(manifest_path, "w"))
    _same(load_predictor(path, device="cpu").predict(reqs), v2_outs)
    update_params(path, pred_art["pred"].model.state_dict())
    assert json.load(open(manifest_path))["format_version"] == 2
    load_predictor(path, device="cpu").predict(reqs)


def test_artifact_integrity_check_refuses_corruption(pred_art, tmp_path):
    """A flipped byte in params.npz or in a module is refused; a re-export
    replaces a corrupted artifact and update_params stamps the digest."""
    path = _copy(pred_art["path"], tmp_path)
    load_predictor(path, device="cpu")
    params_path = os.path.join(path, "params.npz")
    blob = bytearray(open(params_path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(params_path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="integrity"):
        load_predictor(path, device="cpu")
    export_predictor(pred_art["pred"], path, channels=3, max_length=8)
    update_params(path, pred_art["pred"].model.state_dict())
    load_predictor(path, device="cpu")
    mod_dir = os.path.join(path, "modules")
    victim = os.path.join(mod_dir, sorted(os.listdir(mod_dir))[0])
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="integrity"):
        load_predictor(path, device="cpu")


def test_update_params_two_phase_commit_crash_window(pred_art, tmp_path):
    """update_params publishes a manifest accepting the old and the new
    digest before it replaces params.npz: a load in that window sees the
    old params accepted; anything else is refused."""
    path = _copy(pred_art["path"], tmp_path)
    params_path = os.path.join(path, "params.npz")
    old_bytes = open(params_path, "rb").read()
    update_params(path, _predictor(seed=9)[0].model.state_dict())
    assert json.load(open(os.path.join(path, "manifest.json")))["params_sha256_prev"]
    load_predictor(path, device="cpu")
    open(params_path, "wb").write(old_bytes)   # the crash window
    load_predictor(path, device="cpu")
    blob = bytearray(old_bytes)
    blob[len(blob) // 2] ^= 0xFF
    open(params_path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="integrity"):
        load_predictor(path, device="cpu")


def test_artifact_serves_in_a_fresh_process(pred_art, tmp_path):
    """A fresh process given only the artifact directory serves the live
    predictor's outputs, with no model class imported (and no JAX)."""
    reqs = _requests(2, seed=5)
    np.save(tmp_path / "req0.npy", reqs[0])
    np.save(tmp_path / "req1.npy", reqs[1])
    np.save(tmp_path / "expected.npy", pred_art["pred"].predict(reqs)[0])
    script = f"""
import sys
import numpy as np
from online_neural_cdes_tpu_torch.serving_export import load_predictor
pred = load_predictor({pred_art['path']!r}, device="cpu")
reqs = [np.load({str(tmp_path / 'req0.npy')!r}), np.load({str(tmp_path / 'req1.npy')!r})]
out = pred.predict(reqs)
np.testing.assert_array_equal(out[0], np.load({str(tmp_path / 'expected.npy')!r}))
bad = [m for m in sys.modules if m.startswith("online_neural_cdes_tpu_torch.models")
       or m.split(".")[0] in ("jax", "online_neural_cdes_tpu")]
assert not bad, bad
print("SERVED_OK")
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SERVED_OK" in res.stdout


def test_load_needs_a_device_when_no_gpu(pred_art, step_art, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_predictor(pred_art["path"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_stepper(step_art["path"])


def test_platforms_bind_the_load_device(pred_art, tmp_path):
    path = _copy(pred_art["path"], tmp_path)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    json.dump(dict(manifest, platforms=["cuda"]), open(os.path.join(path, "manifest.json"), "w"))
    with pytest.raises(ValueError, match="platforms"):
        load_predictor(path, device="cpu")


def test_adaptive_solver_is_refused_by_the_exporter(tmp_path):
    """A ``scipy_solver`` model steps in scipy on the host: the exporter
    refuses it by name rather than tracing it into a wrong program (the
    JAX package's exporter cannot trace it either).  The Runge-Kutta and
    Adams solvers export (``test_torch_port_export_adaptive.py``)."""
    model = NeuralCDE(**dict(PRED_KW, solver="scipy_solver"), device="cpu")
    pred = Predictor(model, coeff_fn=linear_interpolation_coeffs, batch_buckets=(2,),
                     length_multiple=8, device="cpu")
    with pytest.raises(ValueError, match="'scipy_solver' solve cannot be exported"):
        export_predictor(pred, str(tmp_path), channels=3, max_length=8)


def test_fused_field_op_opcheck():
    """The op ``oncde::fused_field_forward`` passes torch.library's checks
    (schema, fake version, dispatch) on the CPU."""
    from online_neural_cdes_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(0)
    H, HH, I, n = 6, 8, 3, 2
    trunk = [torch.randn(H, HH, generator=gen), torch.randn(HH, generator=gen),
             torch.randn(HH, HH, generator=gen), torch.randn(HH, generator=gen)]
    args = (torch.randn(5, H, generator=gen), torch.randn(5, I, generator=gen),
            torch.randn(HH, I * H, generator=gen), torch.randn(I * H, generator=gen),
            trunk, H, I, "float32")
    torch.library.opcheck(kernels.fused_field_forward_op, args,
                          test_utils=("test_schema", "test_faketensor"))
    got = kernels.fused_field_forward_op(*args)
    want = kernels._forward_reference(kernels._unflat_trunk(trunk), *args[2:4], *args[:2],
                                      H, I)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The stepper
# ---------------------------------------------------------------------------


def _ticks(stepper, loaded, x):
    s_live, s_art = stepper.init(x[:, 0]), loaded.init(x[:, 0])
    assert torch.equal(stepper.readout(s_live["z"]), loaded.readout(s_art["z"]))
    for k in range(1, x.shape[1]):
        s_live, y_live = stepper.step(s_live, x[:, k])
        s_art, y_art = loaded.step(s_art, x[:, k])
        assert torch.equal(y_live, y_art)
        assert torch.equal(s_live["last_obs"], s_art["last_obs"])


def test_stepper_roundtrip_matches_live(step_art):
    """The streaming artifact advances as the live stepper does, to the
    bit: init, every step's output and the readout, with a held (NaN)
    observation; and matches JAX's streaming artifact."""
    assert step_art["n"] == 2 * 4   # step + init + readout + stepblock4, two counts
    loaded = load_stepper(step_art["path"], device="cpu")
    x = _stream(B, 5)
    _ticks(step_art["stepper"], loaded, x)
    jloaded = jax_export.load_stepper(step_art["jax"])
    s_art, s_jax = loaded.init(x[:, 0]), jloaded.init(x[:, 0])
    for k in range(1, 5):
        s_art, y_art = loaded.step(s_art, x[:, k])
        s_jax, y_jax = jloaded.step(s_jax, x[:, k])
        np.testing.assert_allclose(y_art.numpy(), np.asarray(y_jax), rtol=RTOL, atol=ATOL)


def test_stepper_static_roundtrip_and_guards(static_step_art):
    static = static_step_art["static"]
    loaded = load_stepper(static_step_art["path"], static=static, device="cpu")
    _ticks(static_step_art["stepper"], loaded, _stream(B, 4, seed=1))
    with pytest.raises(ValueError, match="static"):
        load_stepper(static_step_art["path"], device="cpu").init(_stream(B, 4)[:, 0])
    with pytest.raises(ValueError, match="re-export"):
        loaded.init(np.zeros((5, 3), np.float32))


def test_stepper_and_predictor_artifacts_are_distinguished(pred_art, step_art):
    with pytest.raises(ValueError, match="load_stepper"):
        load_predictor(step_art["path"], device="cpu")
    with pytest.raises(ValueError, match="load_predictor"):
        load_stepper(pred_art["path"], device="cpu")


def test_bf16_stepper_export_ticks_within_tolerance(tmp_path):
    """params_dtype='bfloat16' on the streaming artifact: ticks track the
    float32 live stepper within reduced-precision tolerance."""
    stepper, _, _ = _stepper(n=ODD)
    export_stepper(stepper, str(tmp_path), batch_sizes=(ODD,), channels=3,
                   params_dtype="bfloat16")
    loaded = load_stepper(str(tmp_path), device="cpu")
    x = _stream(ODD, 5, seed=23)
    s_live, s_art = stepper.init(x[:, 0]), loaded.init(x[:, 0])
    for k in range(1, 5):
        s_live, y_live = stepper.step(s_live, x[:, k])
        s_art, y_art = loaded.step(s_art, x[:, k])
        np.testing.assert_allclose(y_art.float().numpy(), y_live.numpy(), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
        assert not torch.equal(y_art.float(), y_live)


def test_exported_step_blocks_catch_up_backlog(step_art):
    """A backlog runs the largest exported blocks, then single steps, and
    equals the live ticks to the bit; an empty backlog is (0, B, out); a
    (B, K, C) backlog is refused."""
    stepper, K = step_art["stepper"], 7   # one block of 4 and 3 single steps
    loaded = load_stepper(step_art["path"], device="cpu")
    x = _stream(B, K + 1, seed=29)
    s_live = stepper.init(x[:, 0])
    ys_live = []
    for k in range(1, K + 1):
        s_live, y = stepper.step(s_live, x[:, k])
        ys_live.append(y)
    s_art = loaded.init(x[:, 0])
    s_art, ys_empty = loaded.step_many(s_art, np.zeros((0, B, 3), np.float32))
    assert ys_empty.shape == (0, B, 2)
    with pytest.raises(ValueError, match="time-major"):
        loaded.step_many(s_art, x[:, 1:])
    s_art, ys_art = loaded.step_many(s_art, np.ascontiguousarray(np.swapaxes(x[:, 1:], 0, 1)))
    assert torch.equal(ys_art, torch.stack(ys_live))
    assert torch.equal(s_art["z"], s_live["z"])


def test_stepper_precompile_warms_all_modules(step_art):
    """precompile() runs every module (init, step, readout and the block,
    at both stream counts); the live stepper's warms its programs too."""
    assert step_art["stepper"].precompile(B, block_sizes=(4,)) == 3
    assert load_stepper(step_art["path"], device="cpu").precompile() == 2 * 4


# ---------------------------------------------------------------------------
# Over a mesh: two gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_ranks(pred_art, step_art, static_step_art, tmp_path_factory):
    spec = dict(world=2, device="cpu", C=3, S=2, L=8, requests=6, streams=B, ticks=7,
                checks="export", out=str(tmp_path_factory.mktemp("mesh")),
                artifacts={"predictor": pred_art["path"],
                           "steppers": {"plain": (step_art["path"], False),
                                        "static": (static_step_art["path"], True)},
                           "B": B, "odd": ODD})
    return chip_smoke.par_spawn(spec, 240)


def _mesh_close(got, want):
    if isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _mesh_close(g, w)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=MESH_RTOL,
                               atol=MESH_ATOL)


def test_loaded_artifact_shards_over_mesh(mesh_ranks):
    """load_predictor(path, mesh=) splits every bucket batch over the data
    axis and serves one process's outputs."""
    for r in mesh_ranks:
        _mesh_close(r["predict"], r["ref"]["predict"])


def test_mesh_sharded_stepper_matches_single_device(mesh_ranks):
    """A stream population over the mesh ticks as on one process, and the
    state holds this rank's streams only."""
    for r in mesh_ranks:
        assert r["stream"]["rows"] == B // 2 and r["ref"]["stream"]["rows"] == B
        _mesh_close(r["stream"]["ys"], r["ref"]["stream"]["ys"])


def test_mesh_sharded_stepper_rejects_indivisible_batch(mesh_ranks):
    for r in mesh_ranks:
        assert "does not divide" in r["refusal_plain"]


def test_mesh_sharded_static_stepper_matches_single_device(mesh_ranks):
    """Static features shard with the streams."""
    for r in mesh_ranks:
        assert r["stream_static"]["rows"] == B // 2
        _mesh_close(r["stream_static"]["ys"], r["ref"]["stream_static"]["ys"])


def test_multi_axis_mesh_stepper_divides_by_data_axis(mesh_ranks):
    """On an (ensemble, data) = (2, 1) mesh a stream count of 3 divides the
    data axis and serves, though it does not divide the ranks."""
    for r in mesh_ranks:
        assert r["ensemble_stream"]["rows"] == ODD
        _mesh_close(r["ensemble_stream"]["ys"], r["ref"]["ensemble_stream"]["ys"])
