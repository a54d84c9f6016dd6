"""Parity of the port's log-ODE transform (``ops/logsig.py`` and the
loader's ``parse_logsig_string`` / ``apply_logsig_transform``) against
the JAX package, on the CPU, and a small log-ODE ``NeuralCDE`` train step.

The same numpy inputs (fixed seeds) go through both sides.  The transform
is held in float64 at rtol=1e-9 over depths 1-4 (the channel order is
Duval's order of the Lyndon words: a permuted order fails every depth >= 2
case), with the JAX package's oracles (``tests/test_logsig.py``) on the
port: Lyndon counts against the necklace formula, a two-segment window
against Baker-Campbell-Hausdorff, ragged series against per-series
transforms.  The loader's float32 transform and the model slice run at
|err| <= 1e-5 (|want| + max|want|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.data import loader as jax_loader
from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.ops import logsig as jax_logsig
from online_neural_cdes_tpu.training import loop as jax_loop
from online_neural_cdes_tpu_torch import NeuralCDE, linear_interpolation_coeffs, params_from_jax
from online_neural_cdes_tpu_torch.data import loader
from online_neural_cdes_tpu_torch.ops import logsig
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-10
RTOL32 = 1e-5


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def close32(got, want, err_msg=""):
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, RTOL32, RTOL32 * scale, err_msg)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_lyndon_words_and_channel_counts_match_jax(channels):
    for depth in range(1, 6):
        assert logsig.lyndon_words(channels, depth) == jax_logsig.lyndon_words(channels,
                                                                              depth)
        assert (logsig.logsignature_channels(channels, depth)
                == jax_logsig.logsignature_channels(channels, depth))
    for span, window in ((12.0, 4.0), (4095.0, 8.0), (10.0, 3.0), (7.0, 2.5)):
        assert logsig.num_windows(span, window) == jax_logsig.num_windows(span, window)


def test_lyndon_counts_match_the_necklace_formula():
    def mobius(n):
        out, p, m = 1, 2, n
        while p * p <= m:
            if m % p == 0:
                m //= p
                if m % p == 0:
                    return 0
                out = -out
            p += 1
        return -out if m > 1 else out

    for channels in (2, 3):
        words = logsig.lyndon_words(channels, 5)
        for n in range(1, 6):
            want = sum(mobius(d) * channels ** (n // d)
                       for d in range(1, n + 1) if n % d == 0) // n
            assert sum(1 for w in words if len(w) == n) == want


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_window_logsig_matches_jax(depth):
    rng = np.random.default_rng(depth)
    deltas = rng.normal(size=(2, 3, 5, 3)) * 0.5        # (B, W, M, C)
    deltas[:, 1, 3:] = 0.0                             # a ragged window
    widx = jax_logsig._words_index(3, depth)
    want = jax_logsig._window_logsig(jnp.asarray(deltas), depth, widx)
    got = logsig._window_logsig(torch.from_numpy(deltas), depth,
                                logsig._words_index(3, depth))
    close(got, want)


def test_two_segment_window_matches_bch():
    """log(exp(a) exp(b)) to depth 3 by Baker-Campbell-Hausdorff: a + b +
    [a,b]/2 + ([a,[a,b]] + [b,[b,a]])/12."""
    rng = np.random.default_rng(0)
    C = 3
    a, b = rng.normal(size=C), rng.normal(size=C)
    comm = np.einsum("i,j->ij", a, b) - np.einsum("i,j->ij", b, a)

    def bracket(v, m):
        return np.einsum("i,jk->ijk", v, m) - np.einsum("jk,i->jki", m, v)

    l3 = (bracket(a, comm) + bracket(b, -comm)) / 12.0
    widx = logsig._words_index(C, 3)
    got = logsig._window_logsig(torch.from_numpy(np.stack([a, b])[None]), 3, widx)[0]
    want = np.concatenate([a + b, (0.5 * comm).reshape(-1)[widx[2]],
                           l3.reshape(-1)[widx[3]]])
    close(got, want)


CASES = {
    "window4": dict(L=13, window=4.0, t=None),
    "window2.5_nan": dict(L=11, window=2.5, t=None, nan=True),
    "irregular_t": dict(L=9, window=1.5, t="irregular"),
    "one_window": dict(L=5, window=8.0, t=None),
}


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_logsig_windows_matches_jax(case, depth):
    spec = CASES[case]
    rng = np.random.default_rng(depth + 10)
    x = rng.normal(size=(3, spec["L"], 3))
    if spec.get("nan"):
        x[0, 4, 1] = x[1, 0, 2] = x[2, -1, 0] = np.nan
    t = None
    if spec["t"] == "irregular":
        t = np.cumsum(rng.uniform(0.3, 1.2, size=spec["L"]))
    want = jax_logsig.logsig_windows(jnp.asarray(x), depth, spec["window"], t=t)
    got = logsig.logsig_windows(torch.from_numpy(x), depth, spec["window"], t=t)
    assert got.shape == want.shape
    close(got, want)


def test_logsignature_windows_version_0_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 7, 2))
    wv, wt = jax_logsig.logsignature_windows(jnp.asarray(x), 2, 3.0)
    gv, gt = logsig.logsignature_windows(torch.from_numpy(x), 2, 3.0)
    close(gv, wv)
    close(gt, wt)
    close(gt, [0.0, 3.0, 6.0])


@pytest.mark.parametrize("key", ["logsig-2-8", "logsig-3-2.5", "logsig-2", "logsig-0-4",
                                 "logsig-2--1"])
def test_parse_logsig_string_matches_jax(key):
    try:
        want = jax_loader.parse_logsig_string(key)
    except ValueError:
        with pytest.raises(ValueError):
            loader.parse_logsig_string(key)
    else:
        assert loader.parse_logsig_string(key) == want


def test_apply_logsig_transform_dense_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 33, 4)).astype(np.float32)
    x[..., 0] = np.arange(33) / 33
    x[1, 5, 2] = np.nan
    want = jax_loader.apply_logsig_transform(x, 2, 8.0, chunk=3)
    got = loader.apply_logsig_transform(x, 2, 8.0, chunk=3, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (7, 5, 10)
    close32(got, want)


def test_apply_logsig_transform_ragged_matches_jax_and_per_series():
    rng = np.random.default_rng(6)
    series = np.empty(4, dtype=object)
    for i, length in enumerate((9, 14, 5, 14)):
        s = rng.normal(size=(length, 3)).astype(np.float32)
        s[rng.random(size=s.shape) < 0.15] = np.nan
        series[i] = s
    want = jax_loader.apply_logsig_transform(series, 3, 4.0)
    got = loader.apply_logsig_transform(series, 3, 4.0, device="cpu")
    for g, w, s in zip(got, want, series):
        assert g.shape == w.shape == (logsig.num_windows(len(s) - 1, 4.0) + 1, 14)
        close32(g, w)
        alone = logsig.logsig_windows(torch.from_numpy(s), 3, 4.0).numpy()
        close32(g, alone)


def test_apply_logsig_transform_needs_a_device_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.apply_logsig_transform(np.zeros((1, 5, 2), np.float32), 2, 2.0)


def test_logode_neural_cde_train_step_matches_jax():
    """The JAX bench's log-ODE leg at a small size: raw series with time in
    channel 0 -> logsig-2-8 -> linear coefficients -> an RK4 NCDE with the
    interval adjoint, final state, BCE, one Adam step (lr 1e-3)."""
    rng = np.random.default_rng(4)
    B, L, C = 6, 33, 3
    x = (rng.normal(size=(B, L, C)) * 0.1).astype(np.float32)
    x[:, :, 0] = np.arange(L) / L
    labels = (x[:, :, 1].sum(1) > 0).astype(np.float32)
    want_x = jax_loader.apply_logsig_transform(x, 2, 8.0)
    got_x = loader.apply_logsig_transform(x, 2, 8.0, device="cpu")
    close32(got_x, want_x)
    kw = dict(input_dim=got_x.shape[-1], hidden_dim=8, output_dim=1, hidden_hidden_dim=8,
              num_layers=2, interpolation="linear", solver="rk4", adjoint=True,
              return_sequences=False)
    jm = JaxNeuralCDE(**kw)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = NeuralCDE(**kw, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    jc = jax_interp.linear_interpolation_coeffs(jnp.asarray(want_x))
    tc = linear_interpolation_coeffs(torch.from_numpy(np.array(jc)))
    jstep = jax_loop.make_train_step(jm, loss="bce", lr=1e-3, donate=False)
    jparams, _, want = jstep(jparams, jax_loop.init_adam_state(jparams), jc,
                             jnp.asarray(labels), 1.0)
    got = loop.make_train_step(tm, loss="bce", lr=1e-3)(tc, torch.from_numpy(labels), 1.0)
    close32(got, want)
    want_p = flatten_tree(jax.tree.map(np.asarray, jparams))
    for name, p in tm.state_dict().items():
        close32(p, want_p[name], name)
