"""The port's checkpoints, input prefetching and profiling utilities, on
the CPU: the counterparts of ``tests/test_checkpoint.py`` and
``tests/test_prefetch.py``, held against the JAX package where both take
the same inputs (weights made by the JAX ``init`` and carried across with
``params_from_jax``), and a resumed Adam run and a prefetched epoch held
to the bit against uninterrupted, plainly fed ones.
"""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.data import prefetch as jax_prefetch
from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.utils import checkpoint as jax_checkpoint
from online_neural_cdes_tpu.utils import profiling as jax_profiling
from online_neural_cdes_tpu_torch import NeuralCDE, params_from_jax
from online_neural_cdes_tpu_torch.data.prefetch import prefetch_to_device
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.utils import checkpoint, profiling
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

KW = dict(input_dim=3, hidden_dim=4, output_dim=1, hidden_hidden_dim=5, num_layers=2,
          interpolation="rectilinear", solver="rk4", return_sequences=True, static_dim=2)


def _pair(seed=0):
    jm = JaxNeuralCDE(**KW)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = NeuralCDE(**KW, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    return jparams, tm


def _fresh(seed):
    return NeuralCDE(**KW, device="cpu", generator=torch.Generator().manual_seed(seed))


def _batches(n=5, b=4, length=6, seed=0):
    """Rectilinear (static, coeffs) batches with NaN-padded labels."""
    from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(b, length, 3)).astype(np.float32)
        x[..., 0] = np.arange(length)
        coeffs = linear_interpolation_coeffs(torch.from_numpy(x), rectilinear=0).numpy()
        labels = rng.integers(0, 2, (b, length)).astype(np.float32)
        labels[0, -2:] = np.nan
        out.append(((rng.normal(size=(b, 2)).astype(np.float32), coeffs), labels))
    return out


def _tensors(batch):
    (static, coeffs), labels = batch
    return (torch.from_numpy(static), torch.from_numpy(coeffs)), torch.from_numpy(labels)


def _same_state(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].device == want[k].device, k
        assert torch.equal(got[k], want[k]), k


# -------------------------------------------------------------- checkpoint


def test_npz_roundtrip_of_jax_weights(tmp_path):
    """The port's model, carrying the JAX ``init``'s weights, round-trips
    through a checkpoint into a model of another seed: every tensor equals
    the JAX parameter it came from."""
    jparams, tm = _pair()
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), tm.state_dict(),
                                      use_orbax=False)
    assert path.endswith(".npz") and os.path.exists(path)
    other = _fresh(5)
    other.load_state_dict(checkpoint.load_checkpoint(path, other.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jparams))
    for name, p in other.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want[name])


def test_npz_structure_mismatch_raises_naming_both(tmp_path):
    state = {"w": torch.ones(2, 3), "b": torch.zeros(3)}
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    with pytest.raises(ValueError, match="structure") as info:
        checkpoint.load_checkpoint(path, {"weights": torch.ones(2, 3), "bias": torch.zeros(3)})
    assert '"w"' in str(info.value) and '"weights"' in str(info.value)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_checkpoint(path, {"w": torch.ones(2, 3), "b": 0.0})
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_checkpoint(path, [torch.ones(2, 3), torch.zeros(3)])


def test_default_format_roundtrip(tmp_path):
    """``use_orbax=None`` (the JAX default, which writes orbax where it is
    installed) writes the port's npz and reads it back."""
    _, tm = _pair(1)
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt_default"), tm.state_dict())
    _same_state(checkpoint.load_checkpoint(path, _fresh(3).state_dict()), tm.state_dict())


def test_npz_roundtrip_bfloat16(tmp_path):
    """bf16 leaves are stored as f32 and come back bf16, like the JAX
    package's."""
    import jax.numpy as jnp

    values = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    state = {"w": torch.from_numpy(values).to(torch.bfloat16)}
    path = checkpoint.save_checkpoint(str(tmp_path / "bf16_ckpt"), state, use_orbax=False)
    with np.load(path) as npz:
        assert npz["leaf_0"].dtype == np.float32
    restored = checkpoint.load_checkpoint(path, state)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], state["w"])
    jstate = {"w": jnp.asarray(values, jnp.bfloat16)}
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax_bf16"), jstate, use_orbax=False)
    jrestored = jax_checkpoint.load_checkpoint(jpath, jstate)
    np.testing.assert_array_equal(restored["w"].float().numpy(),
                                  np.asarray(jrestored["w"], np.float32))


def test_explicit_orbax_request_does_not_silently_fall_back(tmp_path):
    with pytest.raises(RuntimeError, match="orbax"):
        checkpoint.save_checkpoint(str(tmp_path / "x"), {"a": torch.zeros(2)},
                                   use_orbax=True)
    assert not os.listdir(tmp_path)
    os.makedirs(tmp_path / "orbax_dir")
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_checkpoint(str(tmp_path / "orbax_dir"), {"a": torch.zeros(2)})


def test_leaves_take_the_dtype_and_device_of_like(tmp_path):
    state = {"f": torch.arange(4.0), "i": torch.arange(3), "n": np.arange(2.0),
             "s": np.float32(1.5), "scalars": [True, 3, 0.1, "adam"], "none": None,
             "pair": (0.9, 0.999), 7: torch.ones(())}
    path = checkpoint.save_checkpoint(str(tmp_path / "mixed"), state)
    like = {"f": torch.zeros(4, dtype=torch.float64), "i": torch.zeros(3, dtype=torch.int32),
            "n": np.zeros(2, np.float32), "s": np.float64(0), "scalars": [False, 0, 0.0, ""],
            "none": None, "pair": (0.0, 0.0), 7: torch.zeros(())}
    got = checkpoint.load_checkpoint(path, like)
    assert got["f"].dtype == torch.float64 and got["f"].tolist() == [0, 1, 2, 3]
    assert got["i"].dtype == torch.int32 and got["i"].tolist() == [0, 1, 2]
    assert got["n"].dtype == np.float32 and got["s"] == 1.5 and got["s"].dtype == np.float64
    assert got["scalars"] == [True, 3, 0.1, "adam"] and type(got["scalars"][1]) is int
    assert got["none"] is None and got["pair"] == (0.9, 0.999) and got[7].item() == 1.0
    with pytest.raises(TypeError, match="keys"):
        checkpoint.save_checkpoint(str(tmp_path / "bad"), {(1, 2): torch.ones(1)})


def test_adam_state_roundtrips_and_like_has_the_stepped_structure(tmp_path):
    model = _fresh(0)
    opt = loop.make_optimizer(model, 1e-2)
    like = checkpoint.optimizer_state_like(opt)
    inputs, labels = _tensors(_batches(1)[0])
    step = loop.make_train_step(model, opt)
    step(inputs, labels)
    saved = opt.state_dict()
    structure = lambda tree: json.dumps(checkpoint._flatten(tree, []))  # noqa: E731
    assert structure(like) == structure(saved)
    path = checkpoint.save_checkpoint(str(tmp_path / "adam"), saved)
    restored = checkpoint.load_checkpoint(path, like)
    assert restored["param_groups"] == saved["param_groups"]
    for k, entry in saved["state"].items():
        _same_state(restored["state"][k], entry)
    with pytest.raises(TypeError, match="Adam"):
        checkpoint.optimizer_state_like(torch.optim.SGD(model.parameters(), lr=0.1))


def test_resumed_adam_run_is_bit_identical(tmp_path):
    """3 steps, a checkpoint of model, Adam and the best loss, 2 more;
    a model and Adam of another seed restored from the checkpoint take the
    same 2 steps to the same bits."""
    batches = [_tensors(b) for b in _batches(5)]
    model = _fresh(0)
    step = loop.make_train_step(model, loss="bce", lr=1e-2)
    head = [step(x, y, 1.0) for x, y in batches[:3]]
    path = checkpoint.save_checkpoint(str(tmp_path / "trainer_state"), {
        "model": model.state_dict(), "optimizer": step.optimizer.state_dict(),
        "best": {"loss": float(min(head)), "step": 3}})
    tail = torch.stack([step(x, y, 0.5) for x, y in batches[3:]])

    fresh = _fresh(1)
    fresh_step = loop.make_train_step(fresh, loss="bce", lr=1e-2)
    restored = checkpoint.load_checkpoint(path, {
        "model": fresh.state_dict(), "optimizer": checkpoint.optimizer_state_like(
            fresh_step.optimizer), "best": {"loss": 0.0, "step": 0}})
    fresh.load_state_dict(restored["model"])
    fresh_step.optimizer.load_state_dict(restored["optimizer"])
    assert restored["best"] == {"loss": float(min(head)), "step": 3}
    resumed = torch.stack([fresh_step(x, y, 0.5) for x, y in batches[3:]])
    assert torch.equal(resumed, tail)
    _same_state(fresh.state_dict(), model.state_dict())


# ---------------------------------------------------------------- prefetch


def test_prefetch_preserves_order_and_values():
    batches = [(np.full((4, 3), i, np.float32), np.full((4,), i, np.float32))
               for i in range(7)]
    out = list(prefetch_to_device(iter(batches), size=3, device="cpu"))
    want = list(jax_prefetch.prefetch_to_device(iter(batches), size=3))
    assert len(out) == len(want) == 7
    for (x, y), (wx, wy) in zip(out, want):
        assert isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(wy))


def test_prefetch_keeps_nesting_and_non_array_leaves():
    item = {"inputs": (np.ones((2, 3), np.float32), [np.arange(2)]), "lr": 0.5, "tag": None}
    (out,) = prefetch_to_device(iter([item]), device="cpu")
    assert out["lr"] == 0.5 and out["tag"] is None
    assert isinstance(out["inputs"], tuple) and isinstance(out["inputs"][1], list)
    assert out["inputs"][1][0].dtype == torch.int64


def test_prefetch_sharding_raises_naming_item_18():
    """Item 18's sharding is ported (tests/test_torch_port_parallel.py runs
    it over a process group); anything but a parallel.mesh.Sharding is
    refused before a copy."""
    with pytest.raises(TypeError, match="parallel.mesh.Sharding"):
        next(prefetch_to_device(iter([np.zeros(2)]), sharding=object(), device="cpu"))


def test_prefetch_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter([np.zeros(2)])))


def test_prefetch_reraises_producer_exception():
    def gen():
        yield np.zeros((2,), np.float32)
        raise RuntimeError("boom")

    it = prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_abandoned_prefetch_releases_producer_thread():
    batches = [np.full((2,), i, np.float32) for i in range(100)]
    it = prefetch_to_device(iter(batches), size=2, device="cpu")
    next(it)
    it.close()  # what GC does when the consumer's frame unwinds
    deadline = time.time() + 5.0
    while time.time() < deadline and any(
            t.name == "prefetch" and t.is_alive() for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())


def test_prefetch_rejects_bad_size():
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter([]), size=0, device="cpu"))


def test_train_with_prefetch_is_bit_identical():
    """An epoch from prefetched batches takes the same steps, to the bit,
    as one from batches converted in the loop."""
    batches = _batches(5)
    plain, pre = _fresh(0), _fresh(0)
    plain_step = loop.make_train_step(plain, loss="bce", lr=1e-2)
    pre_step = loop.make_train_step(pre, loss="bce", lr=1e-2)
    want = torch.stack([plain_step(*_tensors(b), 1.0) for b in batches])
    got = torch.stack([pre_step(x, y, 1.0)
                       for x, y in prefetch_to_device(iter(batches), size=2, device="cpu")])
    assert torch.equal(got, want)
    _same_state(pre.state_dict(), plain.state_dict())


# --------------------------------------------------------------- profiling


def test_device_timer_and_sync_on_the_cpu():
    profiling.device_sync({"a": [torch.ones(2)], "b": 3})
    profiling.device_sync([None, 1.0])
    with profiling.DeviceTimer() as t:
        out = torch.ones(64, 64) @ torch.ones(64, 64)
        t.sync(out)
    assert t.elapsed is not None and t.elapsed >= 0
    with profiling.DeviceTimer() as t2:
        pass
    assert t2.elapsed >= 0


def test_device_memory_is_none_on_the_cpu():
    assert profiling.device_memory_mb("cpu") is None
    assert profiling.device_memory_mb(torch.device("cpu")) is None


def test_nfe_per_second_matches_jax():
    for nfe, seconds in ((100, 2.0), (7, 0.0), (0, 1.5)):
        assert profiling.nfe_per_second(nfe, seconds) == \
            jax_profiling.nfe_per_second(nfe, seconds)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(log_dir)
    assert log_dir == str(tmp_path / "trace") and len(files) == 1
    with open(os.path.join(log_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


def test_trace_defaults_under_the_temporary_directory(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with profiling.trace() as log_dir:
        torch.ones(2) + 1
    assert log_dir == str(tmp_path / "torch-trace") and os.listdir(log_dir)
