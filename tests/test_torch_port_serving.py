"""The served slice end to end: the PyTorch port's ``Predictor`` and
``OnlineNCDEStepper`` against the JAX package's, on the CPU.

Both sides get the same ragged, NaN-holding requests (numpy, fixed seed)
and the same weights (JAX ``init``, carried across with
``params_from_jax``).  The slice runs in float32 as the server does, at
rtol=1e-5, atol=1e-6: the JAX package's own stepper-vs-offline tolerance,
for f32 round-off over 2L-2 RK intervals.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops.interpolation import (
    linear_interpolation_coeffs as jax_coeffs,
)
from online_neural_cdes_tpu.serving import OnlineNCDEStepper as JaxStepper
from online_neural_cdes_tpu.serving import Predictor as JaxPredictor
from online_neural_cdes_tpu_torch import (
    NeuralCDE,
    OnlineNCDEStepper,
    Predictor,
    linear_interpolation_coeffs,
    params_from_jax,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
C, S = 3, 2


def close(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _pair(seed=0, **kw):
    kw = dict(dict(input_dim=C, hidden_dim=6, output_dim=2, hidden_hidden_dim=8,
                   num_layers=2, solver="rk4", adjoint=False,
                   interpolation="rectilinear", return_sequences=True), **kw)
    jm = JaxNeuralCDE(**kw)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = NeuralCDE(**kw, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jparams), tm)
    return jm, jparams, tm


def _requests(n, seed, lo=4, hi=12):
    """Ragged requests with NaNs after the first row (time in channel 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(lo, hi))
        s = rng.normal(size=(length, C)).astype(np.float32)
        s[:, 0] = np.arange(length)
        holes = rng.random(size=(length, C)) < 0.2
        holes[0] = False
        holes[:, 0] = False
        s[holes] = np.nan
        out.append(s)
    return out


def _predictors(jm, jparams, tm, rectilinear=True, **kw):
    kw = dict(dict(batch_buckets=(2, 4), length_multiple=8), **kw)
    rect = {"rectilinear": 0} if rectilinear else {}
    jp = JaxPredictor(jm, jparams, coeff_fn=partial(jax_coeffs, **rect), **kw)
    tp = Predictor(tm, coeff_fn=partial(linear_interpolation_coeffs, **rect),
                   device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize("case", ["rect_seq", "rect_static", "linear_final"])
def test_predict_matches_jax(case):
    """Ragged NaN-holding requests, batch-padded (3 -> bucket 4) and
    oversized (9 -> chunked through the top bucket)."""
    kw = {"rect_seq": {}, "rect_static": {"static_dim": S},
          "linear_final": {"interpolation": "linear", "return_sequences": False}}[case]
    jm, jparams, tm = _pair(seed=1, **kw)
    jp, tp = _predictors(jm, jparams, tm,
                         rectilinear=kw.get("interpolation") != "linear")
    for n in (3, 9):
        reqs = _requests(n, seed=n)
        static = (np.random.default_rng(n).normal(size=(n, S)).astype(np.float32)
                  if "static_dim" in kw else None)
        want = jp.predict(reqs, static=static)
        got = tp.predict(reqs, static=static)
        assert len(got) == len(want) == n
        for g, w, r in zip(got, want, reqs):
            assert g.shape == w.shape
            if kw.get("return_sequences", True):
                assert g.shape == (len(r), 2)
            close(g, w)


def test_predict_many_equals_per_batch_predict():
    jm, jparams, tm = _pair(seed=2, static_dim=S)
    _, tp = _predictors(jm, jparams, tm)
    batches = [_requests(n, seed=10 + n) for n in (2, 5, 1)]
    statics = [np.random.default_rng(n).normal(size=(len(b), S)).astype(np.float32)
               for n, b in enumerate(batches)]
    many = tp.predict_many(batches, statics=statics, in_flight=2)
    for b, st, outs in zip(batches, statics, many):
        for got, want in zip(outs, tp.predict(b, static=st)):
            np.testing.assert_array_equal(got, want)


def test_rectilinear_rows_match_filtered_model():
    jm, jparams, tm = _pair(seed=3, return_filtered_rectilinear=False)
    _, _, tm_f = _pair(seed=3)
    jp_u, tp_u = _predictors(jm, jparams, tm, rectilinear_rows=True)
    tp_f = Predictor(tm_f, coeff_fn=partial(linear_interpolation_coeffs, rectilinear=0),
                     batch_buckets=(2, 4), length_multiple=8, device="cpu")
    reqs = _requests(3, seed=4)
    for gu, gf, w, r in zip(tp_u.predict(reqs), tp_f.predict(reqs),
                            jp_u.predict(reqs), reqs):
        assert gu.shape == (len(r), 2)
        close(gu, w)
        close(gu, gf)


def test_padding_does_not_change_results():
    """A request served alone equals the same request in a padded batch
    (forward-fill padding has dX = 0)."""
    jm, jparams, tm = _pair(seed=4, interpolation="linear", return_sequences=False)
    _, tp = _predictors(jm, jparams, tm, rectilinear=False)
    reqs = _requests(4, seed=5)
    close(tp.predict(reqs[:1])[0], tp.predict(reqs)[0])


def test_precompile_counts_bucket_grid():
    jm, jparams, tm = _pair(seed=5, static_dim=S)
    _, tp = _predictors(jm, jparams, tm)
    assert tp.bucket_grid(20) == [(b, L) for b in (2, 4) for L in (8, 16, 24)]
    assert tp.precompile(channels=C, max_length=16, static_dim=S) == 2 * 2


def test_predictor_rejects_model_on_other_device_and_mesh():
    jm, jparams, tm = _pair(seed=6)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        Predictor(tm, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        Predictor(tm, device="meta")


# ----------------------------------------------------------- stepper


def _stream(seed, B=3, L=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, C)).astype(np.float32)
    x[:, :, 0] = np.arange(L)
    x[1, 3, 1] = np.nan
    x[2, 5, 2] = np.nan
    x[0, 4, 1:] = np.nan
    return x


@pytest.mark.parametrize("case", ["plain", "static", "static_no_initial"])
def test_stepper_matches_jax_and_offline(case):
    kw = {"plain": {}, "static": {"static_dim": S},
          "static_no_initial": {"static_dim": S, "use_initial": False}}[case]
    jm, jparams, tm = _pair(seed=7, **kw)
    x = _stream(8)
    static = (np.random.default_rng(8).normal(size=(x.shape[0], S)).astype(np.float32)
              if kw else None)
    js = JaxStepper(jm, jparams, static=None if static is None else jnp.asarray(static))
    ts = OnlineNCDEStepper(tm, static=static, device="cpu")

    jstate, tstate = js.init(jnp.asarray(x[:, 0])), ts.init(x[:, 0])
    want = [np.asarray(js.readout(jstate["z"]))]
    got = [ts.readout(tstate["z"])]
    for k in range(1, x.shape[1]):
        jstate, jy = js.step(jstate, jnp.asarray(x[:, k]))
        tstate, ty = ts.step(tstate, x[:, k])
        want.append(np.asarray(jy))
        got.append(ty)
    got = torch.stack(got, dim=1)
    close(got, np.stack(want, axis=1))

    coeffs = linear_interpolation_coeffs(torch.from_numpy(x), rectilinear=0)
    with torch.inference_mode():
        offline = tm(coeffs if static is None else (torch.from_numpy(static), coeffs))
    close(got, offline)


def test_step_many_equals_step():
    jm, jparams, tm = _pair(seed=9)
    x = _stream(10, L=6)
    ts = OnlineNCDEStepper(tm, device="cpu")
    state = ts.init(x[:, 0])
    block_state, ys = ts.step_many(state, np.swapaxes(x[:, 1:], 0, 1))
    for k in range(1, x.shape[1]):
        state, y = ts.step(state, x[:, k])
        torch.testing.assert_close(ys[k - 1], y, rtol=0, atol=0)
    torch.testing.assert_close(block_state["z"], state["z"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="time-major"):
        ts.step_many(state, x[:2, 1:])  # (B, K, C) with B != K
    assert ts.precompile(n_streams=3, block_sizes=(2, 4)) == 4


def test_stepper_validates_model():
    _, _, linear = _pair(seed=11, interpolation="linear")
    with pytest.raises(ValueError, match="rectilinear"):
        OnlineNCDEStepper(linear, device="cpu")
    _, _, with_static = _pair(seed=11, static_dim=S)
    with pytest.raises(ValueError, match="static"):
        OnlineNCDEStepper(with_static, device="cpu")
