"""Parity of the port's data parallelism and seed ensembles (ROADMAP item
18a) against the JAX package, on the CPU over a two-rank gloo group.

One spawn of two ranks a module (``chip_smoke.par_spawn``, the worker the
smoke run's ``parallel`` phase runs on the card) runs every check: a
sharded train step, forward, gradient accumulation, epoch step, a
cross-entropy step on a padded tail (its NaN masks differ by shard),
prefetched shards, ``Predictor`` and ``OnlineNCDEStepper`` over the mesh
with their divisibility refusals, a (2 ensemble x 1 data) seed ensemble,
and the toy suite through ``run.main --data-parallel 2``; rank 0 also runs
each on one process.  The parent holds the ranks' results against the JAX
package's single-device steps (``make_train_step``, ``make_epoch_step``,
``make_ensemble_step``), whose weights the ranks load through
``params_from_jax``, and against rank 0's single-process runs.

ROADMAP C3 in the same spawn (``chip_smoke.c3_checks``): ``Predictor(mesh=)``
over dopri5, bosh3, implicit Adams (the corrector's max) and dopri8 (the
blended error), the loaded dopri5 artifact over the mesh and a
``make_train_step(mesh=)`` step each, and a dopri5 ``make_ensemble_step``
over (1 ensemble x 2 data) (the K-lane norms), on rows whose second half
is 4x rougher (one rank's shard smooth, the other's rough).  Every rank
decides its steps over the whole batch (``parallel.mesh.data_reductions``):
its nfe / accepted / rejected equal one process's, and its rows, loss and
weights equal the JAX package's single-device ``Predictor``,
``make_train_step`` and ``make_ensemble_step`` at rtol 1e-7 (JAX's own
sharded bosh3 run is 8e-9 from its one-device run).  Without the reductions each rank's controller
steps on its own rows: the bosh3 rows then sit ~1e-2 off.  An adaptive
``odeint_adjoint`` step and a ``scipy_solver`` forward over the mesh are
refused by name.

Tolerances: float64 (the model and batches), losses and forwards at rtol
1e-9 against JAX (the same formulas, sums split by shard), the weights
after an Adam step at rtol 1e-8 (Adam divides by the root of the second
moment); served rows at rtol 1e-10 against one process; the toy suite
(float32, one epoch) against its serial run at rtol 1e-5.  A world of one
rank equals the step without a mesh to the bit.
"""

import copy
import json
import os
import shutil
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
import test_torch_port_workers
from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.ops import interpolation as jax_interp
from online_neural_cdes_tpu.parallel import ensemble as jax_ensemble
from online_neural_cdes_tpu.serving import Predictor as JaxPredictor
from online_neural_cdes_tpu.training import loop as jax_loop
from online_neural_cdes_tpu_torch import Predictor
from online_neural_cdes_tpu_torch.data.builders import build_toy_bm
from online_neural_cdes_tpu_torch.ops import reduce as data_reduce
from online_neural_cdes_tpu_torch.parallel import ensemble, mesh as pm
from online_neural_cdes_tpu_torch.serving_export import export_predictor
from online_neural_cdes_tpu_torch.training import loop
from online_neural_cdes_tpu_torch.training.config import DEFAULT_CONFIG_DIR
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-12
PARAM_RTOL, PARAM_ATOL = 1e-8, 1e-12
SERVE_RTOL, SERVE_ATOL = 1e-10, 1e-12
RUN_RTOL = 1e-5
SPEC = dict(world=2, device="cpu", dtype="float64", B=8, L=6, C=3, H=8, HH=16, layers=2,
            S=2, lr=1e-2, accum=2, classes=3, requests=6, buckets=(2, 8),
            length_multiple=4, streams=4, ticks=6, reference=True,
            seq={"B": 8, "L": 5, "M": 4, "rows": 4, "aux_M": 2, "memory_B": 8,
                 "memory_lengths": (5, 9)})
C3 = dict(B=8, requests=8, L=12, C=3, H=8, HH=16, layers=2, interpolation="linear",
          return_sequences=True, loss="mse", lr=1e-2,
          solvers=("dopri5", "bosh3", "implicit_adams", "dopri8"), ensemble=2,
          adjoint_solvers=("dopri5", "implicit_adams", "bosh3"))
# The adjoint steps: dopri5's preset min_step=0.5 accepts every reverse step
# of these unit knot intervals and implicit Adams steps a fixed grid, so
# their reverse steps do not follow the error ratios; bosh3 (no preset) does,
# the weights' cotangent blocks among those that decide (ROADMAP item 18c).
# DOP853's error estimate on the rough rows is chaotic in round-off: JAX's
# own dopri8 rows move by 1.5e-2 of a value when its weights move by one
# ulp, so dopri8 is held to the port's one-process run, not to JAX's.
C3_JAX_SOLVERS = ("dopri5", "bosh3", "implicit_adams")
C3_RTOL, C3_ATOL = 1e-7, 1e-12
# Against the port's one process: the shards' partial sums round otherwise
# than the whole batch's, and the error estimates magnify that (bosh3's rows
# 1.7e-7 apart, dopri8's 2.8e-7); without the reductions they sit ~1e-3 off.
C3_ONE_PROCESS_RTOL = 1e-6
SPAWN_TIMEOUT_S = 240


def _jax_model(output_dim=1, **kw):
    return JaxNeuralCDE(input_dim=SPEC["C"], hidden_dim=SPEC["H"], output_dim=output_dim,
                        static_dim=SPEC["S"], hidden_hidden_dim=SPEC["HH"],
                        num_layers=SPEC["layers"], interpolation="rectilinear",
                        solver="rk4", return_sequences=True, **kw)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _save(path, tree):
    np.savez(path, **flatten_tree(jax.tree.map(np.asarray, tree)))
    return str(path)


def _jax_batch(seed, rows=None, labels=None):
    x, static, lab = chip_smoke.par_batch(SPEC, seed, rows)
    coeffs = jax_interp.linear_interpolation_coeffs(jnp.asarray(x), rectilinear=0)
    return (jnp.asarray(static), coeffs), jnp.asarray(lab if labels is None else labels)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results and the JAX package's references."""
    tmp = tmp_path_factory.mktemp("parallel")
    jm, jce, jens = _jax_model(), _jax_model(SPEC["classes"]), _jax_model(adjoint=False)
    jparams = _f64(jm.init(jax.random.PRNGKey(1)))
    jce_params = _f64(jce.init(jax.random.PRNGKey(2)))
    jens_params, _ = jax_ensemble.init_ensemble(jens, SPEC["world"],
                                                base_key=jax.random.PRNGKey(3))
    jens_params = _f64(jens_params)

    root = str(tmp / "toy")
    build_toy_bm(root=root, num_paths=160, n_points=8, seed=0)
    config_dir = str(tmp / "configurations")
    os.makedirs(config_dir)
    shutil.copy(os.path.join(DEFAULT_CONFIG_DIR, "dataset.json5"), config_dir)
    with open(os.path.join(config_dir, "configurations.json5"), "w") as fh:
        json.dump({"toy-dp": {
            "hyperparameters": ["set"], "seed": [0], "dataset_name": ["ToyBM"],
            "dataset": {"interpolation": ["rectilinear"], "batch_size": [128]},
            "model": {"model_string": ["ncde"], "hidden_dim": [8],
                      "hidden_hidden_dim": [16], "num_layers": [2], "adjoint": [True],
                      "solver": ["rk4"]},
            "trainer": {"max_epochs": [1]}}}, fh)
    c3, c3_want = _c3_setup(tmp)
    spec = dict(SPEC, out=str(tmp), params=_save(tmp / "params.npz", jparams), c3=c3,
                ce_params=_save(tmp / "ce.npz", jce_params),
                ensemble_params=_save(tmp / "ensemble.npz", jens_params),
                toy={"suite": "toy-dp", "config_dir": config_dir, "root": root,
                     "ledger": str(tmp / "dp.jsonl"), "serial_ledger": str(tmp / "serial.jsonl")})
    results = chip_smoke.par_spawn(spec, SPAWN_TIMEOUT_S)

    inputs, labels = _jax_batch(11)
    inputs2, labels2 = _jax_batch(12)
    lr = SPEC["lr"]
    want = {}
    step = jax_loop.make_train_step(jm, loss="bce", lr=lr, donate=False)
    p, _, v = step(jparams, jax_loop.init_adam_state(jparams), inputs, labels, 1.0)
    want["train_step"] = want["accum_step"] = {"loss": v, "params": p}
    want["forward"] = jm.apply(jparams, inputs)
    stacked_in = jax.tree.map(lambda a, b: jnp.stack([a, b]), inputs, inputs2)
    p, _, v = jax_loop.make_epoch_step(jm, loss="bce", lr=lr, donate=False)(
        jparams, jax_loop.init_adam_state(jparams), stacked_in,
        jnp.stack([labels, labels2]), 1.0)
    want["epoch_step"] = {"loss": v, "params": p}
    rows = SPEC["B"] - 1
    ce_in, ce_lab = _jax_batch(13, rows, chip_smoke.par_class_labels(SPEC, 13, rows))
    p, _, v = jax_loop.make_train_step(jce, loss="ce", lr=lr, donate=False)(
        jce_params, jax_loop.init_adam_state(jce_params), ce_in, ce_lab, 1.0)
    want["ce_step"] = {"loss": v, "params": p}
    opt = jax.vmap(jax_loop.init_adam_state)(jens_params)
    p, _, v = jax_ensemble.make_ensemble_step(jens, loss="bce", lr=lr)(
        jens_params, opt, inputs, labels, 1.0)
    want["ensemble_step"] = {"loss": v, "params": p}
    want["c3"] = c3_want
    return results, want


def _c3_jax(solver, adjoint=False):
    return JaxNeuralCDE(input_dim=C3["C"], hidden_dim=C3["H"], output_dim=1,
                        hidden_hidden_dim=C3["HH"], num_layers=C3["layers"],
                        interpolation=C3["interpolation"],
                        return_sequences=C3["return_sequences"], solver=solver,
                        adjoint=adjoint)


def _c3_jax_coeffs(x):
    return jax_interp.linear_interpolation_coeffs(jnp.asarray(x).astype(jnp.float64))


def _c3_setup(tmp):
    """The C3 spec (JAX weights a solver, the dopri5 artifact, the dopri5
    ensemble's stacked weights) and the JAX package's single-device
    references: each solver's ``Predictor`` rows and ``make_train_step``
    loss and weights, and ``make_ensemble_step``'s losses and weights."""
    c3 = dict(C3, params={}, artifacts={})
    want = {}
    x_req, _ = chip_smoke.c3_batch(C3, C3["requests"], 43)
    requests = [r.astype(np.float32) for r in x_req]
    x, labels = chip_smoke.c3_batch(C3, C3["B"], 41)
    for i, solver in enumerate(C3["solvers"]):
        jm = _c3_jax(solver)
        jparams = _f64(jm.init(jax.random.PRNGKey(7 + i)))
        c3["params"][solver] = _save(tmp / f"c3_{solver}.npz", jparams)
        rows = JaxPredictor(jm, jparams, coeff_fn=_c3_jax_coeffs,
                            batch_buckets=(C3["requests"],),
                            length_multiple=C3["L"]).predict(requests)
        p, _, v = jax_loop.make_train_step(jm, loss=C3["loss"], lr=C3["lr"], donate=False)(
            jparams, jax_loop.init_adam_state(jparams), _c3_jax_coeffs(x),
            jnp.asarray(labels), 1.0)
        want[solver] = {"predict": rows, "step": {"loss": v, "params": p}}
        if solver in C3["adjoint_solvers"]:      # the same weights, adjoint=True (18c)
            p, _, v = jax_loop.make_train_step(_c3_jax(solver, adjoint=True), loss=C3["loss"],
                                               lr=C3["lr"], donate=False)(
                jparams, jax_loop.init_adam_state(jparams), _c3_jax_coeffs(x),
                jnp.asarray(labels), 1.0)
            want[solver]["adjoint_step"] = {"loss": v, "params": p}
    jm = _c3_jax("dopri5")
    jens_params, _ = jax_ensemble.init_ensemble(jm, C3["ensemble"],
                                                base_key=jax.random.PRNGKey(9))
    jens_params = _f64(jens_params)
    c3["ensemble_params"] = _save(tmp / "c3_ensemble.npz", jens_params)
    opt = jax.vmap(jax_loop.init_adam_state)(jens_params)
    p, _, v = jax_ensemble.make_ensemble_step(jm, loss=C3["loss"], lr=C3["lr"])(
        jens_params, opt, _c3_jax_coeffs(x), jnp.asarray(labels), 1.0)
    want["ensemble"] = {"loss": v, "params": p}
    p, _, v = jax_ensemble.make_ensemble_step(_c3_jax("dopri5", adjoint=True), loss=C3["loss"],
                                              lr=C3["lr"])(
        jens_params, opt, _c3_jax_coeffs(x), jnp.asarray(labels), 1.0)
    want["adjoint_ensemble"] = {"loss": v, "params": p}
    model = chip_smoke.c3_model(c3, "dopri5", torch.device("cpu"), torch.float64)
    path = str(tmp / "c3_dopri5_artifact")
    export_predictor(Predictor(model, coeff_fn=chip_smoke.c3_coeffs(C3),
                               batch_buckets=(C3["requests"],), length_multiple=C3["L"],
                               device="cpu"), path, channels=C3["C"], max_length=C3["L"])
    c3["artifacts"]["dopri5"] = path
    return c3, want


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _close_params(got: dict, want_tree, what=""):
    want = flatten_tree(jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for name, w in want.items():
        _close(got[name], w, PARAM_RTOL, PARAM_ATOL, f"{what} {name}")


@pytest.mark.parametrize("name", ["train_step", "accum_step", "epoch_step", "ce_step"])
def test_sharded_steps_match_the_jax_single_device_step(ranks, name):
    """Each rank's loss is the global NaN-masked mean and its weights take
    the whole batch's update: the JAX step on the whole (unpadded) batch;
    accumulation over each rank's 2 microbatches against the full step."""
    results, want = ranks
    for r in results:
        _close(r[name]["loss"], want[name]["loss"], what=f"rank {r['rank']} {name}")
        _close_params(r[name]["params"], want[name]["params"], f"rank {r['rank']} {name}")


@pytest.mark.parametrize("name", ["train_step", "accum_step", "epoch_step", "ce_step",
                                  "forward", "ensemble_step"])
def test_sharded_paths_match_one_process(ranks, name):
    """Rank 0's run of each path on the whole batch in one process."""
    results, _ = ranks
    ref = results[0]["ref"][name]
    for r in results:
        got = r[name]
        if name == "forward":
            _close(got, ref, what=f"rank {r['rank']}")
            continue
        if name == "ensemble_step":
            _close(got["loss"], ref["loss"])
            for k, v in got["params"].items():
                _close(v, ref["params"][k][r["rank"]:r["rank"] + 1], PARAM_RTOL, PARAM_ATOL, k)
            continue
        _close(got["loss"], ref["loss"])
        for k, v in got["params"].items():
            _close(v, ref["params"][k], PARAM_RTOL, PARAM_ATOL, k)


def test_the_smoke_gates_pass_here_and_catch_a_missed_update(ranks):
    """``chip_smoke.par_verify``, the gates the smoke run's parallel phase
    holds the card's ranks to, pass on these ranks; ranks whose epoch left
    its first update's weights where they started fail them."""
    results, _ = ranks
    _, _, failed = chip_smoke.par_verify(results)
    assert failed == []
    broken = copy.deepcopy(results)
    for r in broken:
        r["epoch_step"]["first"]["params"] = dict(results[0]["ref"]["epoch_step"]["init"])
    _, _, failed = chip_smoke.par_verify(broken)
    assert failed and all("epoch_step" in f and "not Adam's update" in f for f in failed)


def test_pipelined_solve_over_the_mesh_matches_one_process(ranks):
    """``chip_smoke.seq_checks`` (the parallel phase's item 18b checks) on
    the CPU: ``ncde_apply_pipelined`` over a two-rank ``seq`` mesh against
    the model in one process (rtol 1e-9), the direct step's gradients and
    weights against one process's, both ranks equal to the bit, and the
    adjoint's gradients on the rows equal to the float64 pipeline's."""
    results, _ = ranks
    ref = results[0]["seq"]["ref"]
    for r in results:
        seq = r["seq"]
        _close(seq["forward"], ref["forward"], what=f"rank {r['rank']}")
        _close(seq["direct_step"]["loss"], ref["direct_step"]["loss"])
        for k, g in ref["direct_step"]["grads"].items():
            _close(seq["direct_step"]["grads"][k], g, what=k)
            _close(seq["direct_step"]["params"][k], ref["direct_step"]["params"][k],
                   PARAM_RTOL, PARAM_ATOL, k)
        _close(seq["adjoint_step"]["loss"], ref["adjoint_step"]["loss"])
        for k, g in seq["adjoint_rows_cpu_float64"].items():
            assert torch.equal(seq["adjoint_rows"][k], g), k
    gates = chip_smoke.par_verify(results)[0]["seq"]
    assert gates["adjoint_rows"][0]["max_ratio"] == 0.0
    assert gates["memory"] == []


def test_padded_ce_tail_has_nan_masks_that_differ_by_shard(ranks):
    """The JAX test's case for the global mean: 7 rows padded to 8, the pad
    row's labels NaN; a mean of the ranks' means would be off."""
    results, want = ranks
    assert results[0]["ce_step"]["padded_rows"] == SPEC["B"]
    assert float(results[0]["ce_step"]["loss"]) == float(results[1]["ce_step"]["loss"])


def test_forward_gathers_every_row(ranks):
    results, want = ranks
    for r in results:
        assert tuple(r["forward"].shape) == tuple(np.shape(want["forward"]))
        _close(r["forward"], want["forward"], what=f"rank {r['rank']}")


def test_ensemble_step_matches_jax(ranks):
    """The (2 ensemble x 1 data) ensemble: each rank trains its seed, the
    losses are gathered over the ensemble axis; against JAX's
    ``make_ensemble_step`` on the stacked ``init_ensemble`` weights."""
    results, want = ranks
    wparams = flatten_tree(jax.tree.map(np.asarray, want["ensemble_step"]["params"]))
    for r in results:
        _close(r["ensemble_step"]["loss"], want["ensemble_step"]["loss"])
        i = r["rank"]
        for name, w in wparams.items():
            _close(r["ensemble_step"]["params"][name], w[i:i + 1], PARAM_RTOL, PARAM_ATOL,
                   name)


def test_prefetch_sharding_gives_each_rank_its_rows(ranks):
    results, _ = ranks
    assert all(r["prefetch_equal"] for r in results)


def test_predictor_and_stepper_over_the_mesh(ranks):
    """Every rank returns every request's rows and every stream's outputs,
    as one process serves them."""
    results, _ = ranks
    ref = results[0]["ref"]
    for r in results:
        assert len(r["predict"]) == SPEC["requests"]
        for g, w in zip(r["predict"], ref["predict"]):
            np.testing.assert_allclose(g, w, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        assert tuple(r["stream"].shape) == (SPEC["ticks"] - 1, SPEC["streams"], 1)
        _close(r["stream"], ref["stream"], SERVE_RTOL, SERVE_ATOL)


def test_serving_refuses_what_does_not_divide_the_data_axis(ranks):
    results, _ = ranks
    for r in results:
        bucket, streams = r["refusals"]
        assert bucket.startswith("batch_buckets [3] do not divide the mesh's 2-device data axis")
        assert streams.startswith("stream batch 3 does not divide the mesh's 2-device data axis")


def test_run_data_parallel_matches_a_serial_run(ranks):
    """The toy suite (float32, one epoch) through ``run.main
    --data-parallel 2`` inside the group against the same suite in one
    process; only rank 0 wrote the ledger."""
    results, _ = ranks
    serial = results[0]["ref"]["run"]
    assert len(serial) == 1
    for r in results:
        (got,) = r["run"]
        assert got["epochs_run"] == serial[0]["epochs_run"] == 1
        for key in ("test.loss", "test.auc", "val.loss", "train.loss"):
            _close(got[key], serial[0][key], RUN_RTOL, 1e-7, key)
    ledger = results[0]["run_files"]
    assert [os.path.basename(f) for f in ledger] == ["dp.jsonl"]
    with open(ledger[0]) as fh:
        statuses = [json.loads(line)["status"] for line in fh]
    assert statuses == ["running", "completed"]


def test_data_parallel_command_spawns_workers_and_fails_with_a_worker(tmp_path):
    """The command starts its own gloo workers on the CPU; a worker's
    failure (here: no such data root) fails the command."""
    from online_neural_cdes_tpu_torch import run as port_run

    with pytest.raises(Exception, match="ProcessRaisedException|process 0 terminated|"
                                        "FileNotFoundError|No such file"):
        port_run.main(["toy", "--data-root", str(tmp_path / "absent"),
                       "--ledger", str(tmp_path / "l.jsonl"), "--device", "cpu",
                       "--data-parallel", "2"])


def test_a_trial_failing_on_one_rank_ends_the_search(tmp_path):
    """Over a mesh a trial's failure on one rank is not scored and passed
    over (the next trial's collectives would meet the other rank's, still
    in the failed trial): it ends the search, and the spawn with it."""
    import torch.multiprocessing as tmp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    context = tmp.spawn(test_torch_port_workers.hyperopt_rank, args=(address, str(tmp_path)), nprocs=2,
                        join=False)
    with pytest.raises((tmp.ProcessRaisedException, tmp.ProcessExitedException)):
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not context.join(timeout=5):
            assert time.monotonic() < deadline, "the search hung"
    for p in context.processes:
        p.kill()
    with open(tmp_path / "rank1") as fh:
        assert fh.read() == "trial\n"


def test_a_world_of_one_is_the_single_process_step_to_the_bit():
    """A mesh of one rank (gloo, in this process): the step, the forward
    and the ensemble step equal the ones without a mesh bit for bit."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    spec = dict(SPEC, dtype="float32")
    dist.init_process_group("gloo", init_method=address, world_size=1, rank=0)
    try:
        mesh = pm.make_mesh(1, devices="cpu")
        x, static, labels = chip_smoke.par_batch(spec, 31)
        from online_neural_cdes_tpu_torch import linear_interpolation_coeffs

        coeffs = linear_interpolation_coeffs(torch.tensor(x, dtype=torch.float32),
                                             rectilinear=0)
        inputs = (torch.tensor(static, dtype=torch.float32), coeffs)
        labels = torch.tensor(labels, dtype=torch.float32)
        got, want = (chip_smoke._par_model(spec, torch.device("cpu"), torch.float32)
                     for _ in range(2))
        for kw in ({}, {"accum_steps": 2}, {"loss": "rmse"}):
            a = loop.make_train_step(got, lr=1e-2, mesh=mesh, **kw)(inputs, labels, 1.0)
            b = loop.make_train_step(want, lr=1e-2, **kw)(inputs, labels, 1.0)
            assert torch.equal(a, b), kw
            for k, v in got.state_dict().items():
                assert torch.equal(v, want.state_dict()[k]), (kw, k)
        assert torch.equal(loop.make_eval_step(got, mesh=mesh)(inputs),
                           loop.make_eval_step(want)(inputs))
        assert pm.data_axis_size(mesh) == 1 and mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="Requested 2 devices but only 1 available"):
            pm.make_mesh(2, devices="cpu")
        with pytest.raises(ValueError, match="Need 2 devices, have 1"):
            ensemble.make_ensemble_mesh(2, 1, devices="cpu")
        with pytest.raises(ValueError, match="does not divide"):
            pm.shard_batch(np.zeros((3, 2)), _two_way(mesh))
    finally:
        dist.destroy_process_group()


class _two_way:
    """A stand-in mesh whose data axis has two ranks (this process is rank
    0 of it), for the refusal of a batch that does not divide it."""

    def __init__(self, mesh):
        self.device = mesh.device

    def axis_size(self, axis):
        return 2

    def axis_index(self, axis):
        return 0


@pytest.mark.parametrize("solver", C3_JAX_SOLVERS)
def test_c3_sharded_adaptive_solves_match_the_jax_single_device_ones(ranks, solver):
    """Each rank's ``Predictor(mesh=)`` rows (and the loaded artifact's),
    its step's loss and its weights after the step: the JAX package's
    single-device ``Predictor`` and ``make_train_step`` on the whole batch,
    at rtol 1e-7."""
    results, want = ranks
    want = want["c3"][solver]
    for r in results:
        c3 = r["c3"]
        for key in ("predict", "artifact"):
            if f"{solver}_{key}" not in c3:
                continue
            for g, w in zip(c3[f"{solver}_{key}"]["out"], want["predict"]):
                np.testing.assert_allclose(g, np.asarray(w), rtol=C3_RTOL, atol=C3_ATOL,
                                           err_msg=f"rank {r['rank']} {key}")
        step = c3[f"{solver}_step"]
        _close(step["out"], want["step"]["loss"], C3_RTOL, C3_ATOL, f"{solver} loss")
        flat = flatten_tree(jax.tree.map(np.asarray, want["step"]["params"]))
        for name, w in flat.items():
            _close(step["params"][name], w, C3_RTOL, C3_ATOL, f"{solver} {name}")


@pytest.mark.parametrize("key", [f"{s}_{k}" for s in C3["solvers"] for k in ("predict", "step")
                                 if f"{s}_{k}" != "dopri8_predict"]
                         + ["dopri5_artifact", "dopri5_ensemble_step",
                            "dopri5_adjoint_ensemble_step"]
                         + [f"{s}_adjoint_step" for s in C3["adjoint_solvers"]])
def test_c3_sharded_solves_match_one_process(ranks, key):
    """Each rank's rows (live and loaded), loss and weights after the step
    equal the port's one-process run on the whole batch at rtol 1e-6.
    dopri8's served rows are left to the counts and the serving gate
    (``test_c3_each_rank_steps_as_one_process``): on the requests' rough
    rows they sit 2.8e-7 to 4.3e-5 of a value from one process's from run
    to run, as JAX's own move by 1.5e-2 when its weights move by an ulp."""
    results, _ = ranks
    want = results[0]["c3"]["ref"][key]
    for r in results:
        got, what = r["c3"][key], f"rank {r['rank']} {key}"
        if key.endswith("_step"):
            _close(got["out"], want["out"], C3_ONE_PROCESS_RTOL, C3_ATOL, f"{what} loss")
            for name, w in want["params"].items():
                _close(got["params"][name], w, C3_ONE_PROCESS_RTOL, C3_ATOL,
                       f"{what} {name}")
        else:
            for g, w in zip(got["out"], want["out"]):
                _close(g, w, C3_ONE_PROCESS_RTOL, C3_ATOL, what)


@pytest.mark.parametrize("solver", C3["adjoint_solvers"])
def test_18c_sharded_adjoint_steps_match_the_jax_single_device_ones(ranks, solver):
    """ROADMAP item 18c: a ``make_train_step(mesh=)`` step of the model with
    ``adjoint=True`` over two ranks (the rough shard on rank 1), whose
    ``odeint_adjoint`` reverse solve steps on (y, a, vt, args_bar) with
    every decision over the whole batch: the row blocks' squares summed
    over the ranks, ``vt``'s and the weights' cotangents (each rank's a
    part of a sum over its rows) judged on their totals.  Each rank's loss
    and weights after the step equal JAX's single-device
    ``make_train_step`` at rtol 1e-7, and its forward and reverse nfe /
    accepted / rejected one process's.  bosh3's reverse steps follow the
    ratios: with the rank parts judged as rows they part from one
    process's."""
    results, want = ranks
    want = want["c3"][solver]["adjoint_step"]
    ref = results[0]["c3"]["ref"][f"{solver}_adjoint_step"]
    assert ref["counts"]["reverse_solves"] == C3["L"] - 1     # one an output interval
    flat = flatten_tree(jax.tree.map(np.asarray, want["params"]))
    for r in results:
        step, what = r["c3"][f"{solver}_adjoint_step"], f"rank {r['rank']} {solver}"
        assert step["counts"] == ref["counts"], what
        _close(step["out"], want["loss"], C3_RTOL, C3_ATOL, f"{what} loss")
        for name, w in flat.items():
            _close(step["params"][name], w, C3_RTOL, C3_ATOL, f"{what} {name}")


def test_18c_rank_parts_are_judged_on_their_totals(ranks):
    """18c's reductions on their own (``chip_smoke.summed_norm_probe``): an
    augmented reverse state whose vt and weight-shaped leaves are each
    rank's part of a sum over the rows.  Each rank's dopri5 and DOP853 error
    ratios (per leaf and as one block) and initial-step norms, over the data
    axis, equal one process's on the whole batch and the totals at rtol
    1e-12 (float64); the parts alone would not (the probe's parts read as
    totals move every quantity)."""
    results, _ = ranks
    want = results[0]["c3"]["ref"]["summed_norms"]
    for r in results:
        got = r["c3"]["summed_norms"]
        assert sorted(got) == ["dop853", "dop853_rms", "dopri5", "initial", "rms"]
        for key, w in want.items():
            _close(got[key], w, 1e-12, 0.0, f"rank {r['rank']} {key}")


@pytest.mark.parametrize("adjoint", [False, True], ids=["direct", "adjoint"])
def test_c3_sharded_ensemble_step_matches_the_jax_single_device_one(ranks, adjoint):
    """The dopri5 seed ensemble over (1 ensemble x 2 data): every rank
    solves both seeds' lanes on its rows, each lane's controller deciding
    over the whole batch (the K-lane norms reduced over the data axis), so
    its losses and both seeds' weights after the step equal JAX's
    single-device ``make_ensemble_step`` at rtol 1e-7; with the adjoint
    (18c) each lane's reverse solve judges its vt and weight cotangents on
    their totals over the ranks."""
    results, want = ranks
    want = want["c3"]["adjoint_ensemble" if adjoint else "ensemble"]
    flat = flatten_tree(jax.tree.map(np.asarray, want["params"]))
    for r in results:
        step = r["c3"]["dopri5_adjoint_ensemble_step" if adjoint else "dopri5_ensemble_step"]
        _close(step["out"], want["loss"], C3_RTOL, C3_ATOL, f"rank {r['rank']} losses")
        for name, w in flat.items():
            _close(step["params"][name], w, C3_RTOL, C3_ATOL, f"rank {r['rank']} {name}")


def test_c3_each_rank_steps_as_one_process(ranks):
    """Every rank's nfe / accepted / rejected (live, loaded and the step's)
    equal one process's on the whole batch, and the smoke run's C3 gates
    (``chip_smoke.c3_verify``) pass; both ranks take their solves'
    decisions together, so their counts are equal too."""
    results, _ = ranks
    ref = dict(results[0]["c3"]["ref"])
    ref.pop("summed_norms")
    assert sorted(ref) == sorted([f"{s}_{k}" for s in C3["solvers"]
                                  for k in ("predict", "step")]
                                 + ["dopri5_artifact", "dopri5_ensemble_step",
                                    "dopri5_adjoint_ensemble_step"]
                                 + [f"{s}_adjoint_step" for s in C3["adjoint_solvers"]])
    for r in results:
        for key, want in ref.items():
            assert r["c3"][key]["counts"] == want["counts"], (r["rank"], key)
            assert want["counts"]["solves"] >= 1, key
            # The RK controllers reject steps on these rows; Adams steps on
            # a fixed grid, its corrector iterating to the L-inf tolerance.
            assert key.startswith("implicit_adams") or want["counts"]["rejected"] > 0, key
    failed = []
    gates = chip_smoke.c3_verify(results, failed, lambda fn, *a: fn(*a),
                                 lambda *a: dict(zip(("max_abs_err", "gate_share",
                                                      "bit_identical"),
                                                     chip_smoke.par_gate(*a))))
    assert failed == [] and set(gates) == set(ref) | {"summed_norms"}


def test_c3_scipy_is_refused_over_a_mesh(ranks):
    """A ``scipy_solver`` forward would decide on a rank's rows alone (its
    host solve cannot take a reduction; JAX cannot trace it under ``jit``
    either): refused, naming C3.  (An adaptive ``odeint_adjoint`` step is
    no longer refused: ROADMAP item 18c.)"""
    results, _ = ranks
    for r in results:
        (scipy,) = r["c3"]["refusals"]
        assert "a scipy_solver solve" in scipy and "C3" in scipy


def test_a_world_of_one_adaptive_solve_is_bit_identical():
    """Over a world of one rank (gloo, in this process) a dopri5 step and
    ``Predictor(mesh=)`` equal the ones without a mesh bit for bit, and so
    does the reducing form itself, forced over the world's group."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    dist.init_process_group("gloo", init_method=address, world_size=1, rank=0)
    try:
        mesh = pm.make_mesh(1, devices="cpu")
        cpu, f64 = torch.device("cpu"), torch.float64
        x, labels = chip_smoke.c3_batch(C3, C3["B"], 41)
        coeffs = chip_smoke.c3_coeffs(C3)(torch.as_tensor(x))
        labels = torch.as_tensor(labels)
        requests = [r.astype(np.float32) for r in chip_smoke.c3_batch(C3, 4, 43)[0]]
        kw = dict(coeff_fn=chip_smoke.c3_coeffs(C3), batch_buckets=(4,),
                  length_multiple=C3["L"])
        for reducing in (False, True):
            context = data_reduce.over(dist.group.WORLD) if reducing else pm.data_reductions(
                mesh)
            got, want = (chip_smoke.c3_model(C3, "dopri5", cpu, f64) for _ in range(2))
            with context:
                a = loop.make_train_step(got, loss="mse", lr=1e-2, mesh=mesh)(coeffs,
                                                                              labels, 1.0)
                rows = Predictor(got, mesh=mesh, **kw).predict(requests)
            b = loop.make_train_step(want, loss="mse", lr=1e-2)(coeffs, labels, 1.0)
            assert torch.equal(a, b), reducing
            for k, v in got.state_dict().items():
                assert torch.equal(v, want.state_dict()[k]), (reducing, k)
            for g, w in zip(rows, Predictor(want, device="cpu", **kw).predict(requests)):
                np.testing.assert_array_equal(g, w)
    finally:
        dist.destroy_process_group()


def test_mesh_needs_a_process_group_and_a_device(monkeypatch):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        pm.make_mesh(2, devices="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices='cpu'"):
        pm._rank_device(0, None)
