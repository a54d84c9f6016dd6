"""A bfloat16 adaptive wave (ROADMAP item 17d-a) on the CPU: the JAX sweep
test's toy with the ``hermite-dopri5`` suite's model (Hermite cubic
splines, dopri5, no adjoint) and ``trainer.compute_dtype: "bfloat16"``, its
seeds as one ``run_trials_vmapped`` wave of K=3.

Each lane's solves run the K-lane controller on bf16 states, every host
scalar a ``_Bf16`` and every field call the fused field's K-replica form
on bf16 operands (bf16 storage); each lane's nfe is its serial bf16 run's
and its losses that run's at float32 rtol 1e-4 after two epochs (the
lanes' and the serial step's Adam moves a near-zero gradient's round-off
by about lr, as ``test_torch_port_wave_adjoint``'s float32 dopri5 wave
shows).  Against the JAX wave with the same ``compute_dtype``: XLA rounds
a bf16 chain at the end of a fusion where PyTorch rounds after every op,
so a bf16 adaptive run of either takes other steps than the other's (JAX's
lane 1 here: 214 evaluations to the port's 208) and parts from it by about
as much as JAX's bf16 wave parts from its float32 wave; every lane's
validation and test losses are held to twice that distance (its largest
over the lanes and epochs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_neural_cdes_tpu.training import harness as jax_harness
from online_neural_cdes_tpu.training import wave as jax_wave
from online_neural_cdes_tpu_torch.ops import kernels, solvers
from online_neural_cdes_tpu_torch.training import experiment, wave
from test_torch_port_wave import (  # noqa: F401  (fixtures)
    _jax_tree_from_port, _toy_cfg, toy_dataset,
)

torch.set_num_threads(1)

K = 3
EPOCHS = 2
F32_TRAIN_RTOL = 1e-4
JAX_BF16_SHARE = 2.0


def _cfgs(compute_dtype="bfloat16"):
    cfg = _toy_cfg("ncde", compute_dtype=compute_dtype, max_epochs=EPOCHS)
    cfg["model"].update(solver="dopri5")
    cfg["dataset"]["interpolation"] = "hermite"
    return [{**cfg, "seed": s} for s in range(K)]


def _losses(run):
    return [h["loss"] for h in run["history"]] + [run["val.loss"], run["test.loss"]]


def test_bf16_hermite_dopri5_wave_lanes_follow_their_serial_bf16_runs(toy_dataset,
                                                                       monkeypatch):
    """The training steps' solves step bf16 lanes (no float32 lane) on the
    fused field's K-replica form in bf16 storage; the evaluations and the
    NFE probe run at the float32 master weights under no grad, as the JAX
    wave's and the serial harness's do.  Each lane's nfe is its serial bf16
    run's and its losses that run's."""
    dtypes, multi = set(), set()
    real_init, real_multi = solvers._LaneController.__init__, kernels.fused_matmul_field_multi

    def init(self, func_k, y0, k, t, tableau, **kw):
        dtypes.add((torch.is_grad_enabled(), y0[0].dtype))
        real_init(self, func_k, y0, k, t, tableau, **kw)

    def counted(trunk, head_w, head_b, z, dx, *a, **kw):
        multi.add((z.dtype, head_w.dtype))
        return real_multi(trunk, head_w, head_b, z, dx, *a, **kw)

    monkeypatch.setattr(solvers._LaneController, "__init__", init)
    monkeypatch.setattr(kernels, "fused_matmul_field_multi", counted)
    cfgs = _cfgs()
    lanes = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    monkeypatch.undo()
    assert dtypes == {(True, torch.bfloat16), (False, torch.float32)}
    assert multi == {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)}
    for cfg, lane in zip(cfgs, lanes):
        run = experiment.run_experiment(cfg, toy_dataset, device="cpu")
        assert lane["nfe"] == run["nfe"] and lane["epochs_run"] == run["epochs_run"] == EPOCHS
        np.testing.assert_allclose(_losses(lane), _losses(run), rtol=F32_TRAIN_RTOL)
    assert len({lane["nfe"] for lane in lanes}) > 1          # each lane its own


def test_bf16_hermite_dopri5_wave_matches_the_jax_wave(toy_dataset, monkeypatch):
    """The bf16 wave against the JAX wave from the same initial weights, with
    ``compute_dtype`` bfloat16 on both sides: every lane's losses within
    JAX_BF16_SHARE times the JAX wave's own bf16-vs-float32 distance."""
    cfgs = _cfgs()
    port_bundle, _ = experiment.load_and_setup(cfgs[0], toy_dataset, "cpu")
    real_init = jax_harness.ModelBundle.init

    def init(self, key, dtype=jnp.float32):
        seed = int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])
        return _jax_tree_from_port(real_init(self, key, dtype), port_bundle.init(seed), dtype)

    monkeypatch.setattr(jax_harness.ModelBundle, "init", init)
    want16 = jax_wave.run_trials_vmapped(cfgs, data_root=toy_dataset)
    want32 = jax_wave.run_trials_vmapped(_cfgs(None), data_root=toy_dataset)
    got = wave.run_trials_vmapped(cfgs, data_root=toy_dataset, device="cpu")
    gap = max(np.abs(np.subtract(_losses(a), _losses(b))).max()
              for a, b in zip(want16, want32))
    assert gap > 0
    for lane, ref in zip(got, want16):
        assert np.abs(np.subtract(_losses(lane), _losses(ref))).max() <= JAX_BF16_SHARE * gap
