"""Parity of the port's time-pipelined solve (``parallel/sequence.py``,
ROADMAP item 18b) against the JAX package's, on the CPU over gloo ranks in
float64: one counterpart of each sequence test of ``tests/test_parallel.py``.

Three spawns (worlds of 2, 3 and 4 ranks; the world of 4 holds a 4-rank
``seq`` mesh and a (2 data x 2 seq) mesh) run every case in
``test_torch_port_workers.sequence_rank`` while this process computes the
JAX package's results on its 8-device virtual mesh at the same ``n``,
``M`` and substeps: the JAX pipeline, and JAX's plain scan or interval
adjoint (``cdeint``).  Both sides take the same numpy inputs and the port
model's weights (seed 0).

Tolerances: the port's pipeline against JAX's, values and gradients (of
the field's weights, ``z0`` and the observations through the coefficients),
rtol 1e-9; against the plain scan and the interval adjoint, the JAX tests'
own.  The pipelined adjoint differs from the interval adjoint by the
reverse integration of ``z`` within a chunk, which grows with the chunk
length: the JAX tests hold it at chunks of 2 pieces (4 when paired), and
so do these.  ``ncde_apply_pipelined`` in float32 against JAX's
``model.apply`` at rtol 1e-5.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import Mesh

import test_torch_port_workers as workers
from online_neural_cdes_tpu.models.ncde import NeuralCDE as JaxNeuralCDE
from online_neural_cdes_tpu.models.ncde import make_spline as jax_make_spline
from online_neural_cdes_tpu.ops.cdeint import cdeint as jax_cdeint
from online_neural_cdes_tpu.ops.interpolation import linear_interpolation_coeffs as jax_coeffs
from online_neural_cdes_tpu.parallel import sequence as jax_sequence
from online_neural_cdes_tpu_torch.utils.convert import flatten_tree

RTOL, ATOL = 1e-9, 1e-12
SPAWN_TIMEOUT_S = 240

LIN = (16, 17, 0)                  # B, L, seed: 16 pieces
ADJ = (16, 5, 7)                   # 4 pieces: chunks of 2 on two seq ranks
RECT = (16, 5, 11, True)           # rectilinear: 8 pieces, paired chunks of 4
DRIFT = (8, 33, 13)                # 32 pieces: chunks of 16 on two seq ranks
APPLY = (16, 9, 0, True)           # rectilinear: 16 pieces
FUZZ = {"n2": (2, (10, 7, 20), 5), "n3": (3, (12, 13, 21), 6),
        "n4": (4, (12, 9, 22), 3), "n4_single_piece": (4, (8, 5, 23), 2)}

WORLDS = {
    2: [
        ("plain", "solve", dict(mesh=2, data=LIN, microbatches=4)),
        ("plain_m16", "solve", dict(mesh=2, data=LIN, microbatches=16, grads=False)),
        ("plain_seq", "solve", dict(mesh=2, data=LIN, microbatches=4, grads=False,
                                    return_sequences=True)),
        ("remat", "solve", dict(mesh=2, data=LIN, microbatches=4, remat=True)),
        ("apply_seq", "apply", dict(mesh=2, data=APPLY, return_sequences=True)),
        ("apply", "apply", dict(mesh=2, data=APPLY, return_sequences=False)),
        ("adjoint", "solve", dict(mesh=2, data=ADJ, microbatches=4, adjoint=True)),
        ("adjoint_ss4", "solve", dict(mesh=2, data=ADJ, microbatches=4, adjoint=True,
                                      substeps=4)),
        ("adjoint_online", "solve", dict(mesh=2, data=ADJ, microbatches=4, adjoint=True,
                                         return_sequences=True, substeps=2,
                                         online_loss=True)),
        ("extreme_2", "solve", dict(mesh=2, data=ADJ, microbatches=2, adjoint=True)),
        ("extreme_16", "solve", dict(mesh=2, data=ADJ, microbatches=16, adjoint=True)),
        ("paired_seq", "solve", dict(mesh=2, data=RECT, interpolation="rectilinear",
                                     microbatches=4, return_sequences=True, grads=False)),
        ("paired", "solve", dict(mesh=2, data=RECT, interpolation="rectilinear",
                                 microbatches=4)),
        ("paired_adjoint", "solve", dict(mesh=2, data=RECT, interpolation="rectilinear",
                                         microbatches=4, adjoint=True, substeps=2)),
        ("midpoint", "solve", dict(mesh=2, data=ADJ, microbatches=4, adjoint=True,
                                   adjoint_method="midpoint", substeps=2)),
        ("midpoint_ss1", "solve", dict(mesh=2, data=ADJ, microbatches=4, adjoint=True,
                                       adjoint_method="midpoint")),
        ("fuzz_n2", "solve", dict(mesh=2, data=FUZZ["n2"][1], microbatches=FUZZ["n2"][2],
                                  grads=False)),
        ("drift", "solve", dict(mesh=2, data=DRIFT, microbatches=4, adjoint=True)),
        ("refusals", "refusals", dict(mesh=2)),
        ("memory", "memory", dict(mesh=2, lengths=(17, 129))),
        ("harness", "harness", dict(mesh=2)),
        ("schedule", "schedule", dict(mesh=2, M=4)),
    ],
    3: [
        ("fuzz_n3", "solve", dict(mesh=3, data=FUZZ["n3"][1], microbatches=FUZZ["n3"][2],
                                  grads=False)),
        ("schedule", "schedule", dict(mesh=3, M=2)),
    ],
    4: [
        ("fuzz_n4", "solve", dict(mesh=4, data=FUZZ["n4"][1], microbatches=FUZZ["n4"][2],
                                  grads=False)),
        ("fuzz_n4_single_piece", "solve", dict(mesh=4, data=FUZZ["n4_single_piece"][1],
                                               microbatches=FUZZ["n4_single_piece"][2],
                                               grads=False)),
        ("schedule", "schedule", dict(mesh=4, M=3)),
        ("schedule_grid", "schedule", dict(mesh=(2, 2), M=3)),
        ("composed", "solve", dict(mesh=(2, 2), data=LIN, microbatches=4)),
        ("composed_seq", "solve", dict(mesh=(2, 2), data=LIN, microbatches=4, grads=False,
                                       return_sequences=True)),
        ("composed_adjoint", "solve", dict(mesh=(2, 2), data=ADJ, microbatches=4,
                                           adjoint=True)),
        ("composed_online", "solve", dict(mesh=(2, 2), data=ADJ, microbatches=4,
                                          adjoint=True, return_sequences=True, substeps=2,
                                          online_loss=True)),
        ("composed_refusal", "refusals", dict(mesh=(2, 2))),
    ],
}


# ------------------------------------------------------------- JAX side


def _jax_params(interpolation="linear", output_dim=2, dtype=torch.float64, **kw):
    """The JAX model and the port model's weights as its parameter tree."""
    port = workers.seq_model(interpolation, output_dim=output_dim, dtype=dtype, **kw)
    jmodel = JaxNeuralCDE(input_dim=workers.SEQ_C, hidden_dim=workers.SEQ_H,
                          output_dim=output_dim, hidden_hidden_dim=workers.SEQ_HH,
                          num_layers=1, interpolation=interpolation, **kw)
    tree = {}
    for name, v in port.state_dict().items():
        node, *path, leaf = name.split(".")
        cur = tree.setdefault(node, {})
        for key in path:
            cur = cur.setdefault(key, {})
        cur[leaf] = jnp.asarray(v.numpy())
    tree["field"]["trunk"] = [tree["field"]["trunk"][str(i)]
                              for i in range(len(tree["field"]["trunk"]))]
    return jmodel, tree


def _jax_mesh(shape):
    if isinstance(shape, tuple):
        return Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "seq"))
    return jax_sequence.make_sequence_mesh(shape)


def jax_solve(data, *, mesh=None, interpolation="linear", grads=True, online_loss=False,
              adjoint=False, substeps=1, microbatches=4, return_sequences=False,
              remat=False, adjoint_method=None):
    """The JAX side of :func:`test_torch_port_workers.seq_solve`: the JAX
    pipeline over ``mesh`` (a seq size or (data, seq)), or with ``mesh``
    None ``cdeint`` (the plain scan, or the interval adjoint)."""
    x, z0, w = workers.seq_data(*data)
    jmodel, params = _jax_params(interpolation)
    weight = jnp.asarray(w)[:, None] if online_loss else 1.0

    def run(p, z, xx):
        coeffs = jax_coeffs(xx, rectilinear=0 if interpolation == "rectilinear" else None)
        spline = jax_make_spline(interpolation, coeffs)
        if interpolation == "rectilinear":
            func, even, args, vf = jmodel.make_solve_func(p, z)
        else:
            # The JAX tests' plain field (the port runs its fused field).
            func, even, args, vf = (lambda t, zz, fp: jmodel.field.apply(fp, t, zz), None,
                                    p["field"], "matmul")
        if mesh is None:
            t = spline.grid_points if return_sequences else spline.interval
            adj = {"substeps": substeps, **({"method": adjoint_method} if adjoint_method
                                            else {})}
            out = jax_cdeint(spline, func, z, t, args, adjoint=adjoint, vector_field_type=vf,
                             method="rk4", options={"substeps": substeps},
                             adjoint_options=adj if adjoint else None, even_func=even)
            out = out if return_sequences else out[..., -1, :]
        else:
            out = jax_sequence.pipelined_cde_solve(
                spline, func, z, args, mesh=_jax_mesh(mesh),
                data_axis="data" if isinstance(mesh, tuple) else None,
                microbatches=microbatches, vector_field_type=vf,
                return_sequences=return_sequences, remat=remat, adjoint=adjoint,
                adjoint_method=adjoint_method, substeps=substeps, even_func=even)
        return jnp.sum((out * weight) ** 2), out

    args = (params, jnp.asarray(z0), jnp.asarray(x))
    if not grads:
        return {"out": np.asarray(jax.jit(run)(*args)[1])}
    value_and_grad = jax.value_and_grad(run, argnums=(0, 1, 2), has_aux=True)
    # One program for the scan's; the pipeline's gradient is taken as the
    # JAX tests take it, eagerly (XLA's SPMD partitioner refuses it under
    # an outer jit on the virtual CPU mesh).
    (loss, out), (gp, gz, gx) = (value_and_grad if mesh is not None
                                 else jax.jit(value_and_grad))(*args)
    g = {k: np.asarray(v) for k, v in flatten_tree(gp["field"], "field").items()}
    return {"out": np.asarray(out), "loss": float(loss),
            "grads": {**g, "z0": np.asarray(gz), "x": np.asarray(gx)}}


def _jax_refusal(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _jax_refusals():
    """The JAX entry points' messages for the port's refusal cases."""
    mesh = jax_sequence.make_sequence_mesh(2)
    uneven = jax_make_spline("linear", jax_coeffs(jnp.zeros((4, 12, 2))))
    jmodel, params = _jax_params()
    x, z0, _ = workers.seq_data(16, 17, 3)
    spline = jax_make_spline("linear", jax_coeffs(jnp.asarray(x)))
    func, _, args, vf = jmodel.make_solve_func(params, jnp.asarray(z0))

    def solve(z, m=mesh, **kw):
        return jax_sequence.pipelined_cde_solve(spline, func, z, args, mesh=m,
                                                vector_field_type=vf, **kw)

    bad = JaxNeuralCDE(input_dim=workers.SEQ_C, hidden_dim=workers.SEQ_H, output_dim=2,
                       num_layers=1, interpolation="rectilinear", adjoint=False,
                       solver="dopri5")
    xr = workers.seq_data(16, 9, 0, time_channel=True)[0]
    x6, z6, _ = workers.seq_data(6, 17, 3)
    spline6 = jax_make_spline("linear", jax_coeffs(jnp.asarray(x6)))
    return {
        "uneven": _jax_refusal(lambda: jax_sequence.pipelined_cde_solve(
            uneven, lambda t, z, a: z, jnp.zeros((4, 3)), None, mesh=mesh)),
        "adjoint_method": _jax_refusal(lambda: solve(jnp.asarray(z0), microbatches=4,
                                                     adjoint=True, adjoint_method="dopri5")),
        "microbatches": _jax_refusal(lambda: solve(jnp.asarray(z0), microbatches=5)),
        "solver": _jax_refusal(lambda: jax_sequence.ncde_apply_pipelined(
            bad, bad.init(jax.random.PRNGKey(0)),
            jax_coeffs(jnp.asarray(xr), rectilinear=0), mesh=mesh)),
        "data": _jax_refusal(lambda: jax_sequence.pipelined_cde_solve(
            spline6, func, jnp.asarray(z6), args, mesh=_jax_mesh((2, 2)), data_axis="data",
            microbatches=2, vector_field_type=vf)),
    }


def _jax_apply(return_sequences):
    jmodel, params = _jax_params("rectilinear", dtype=torch.float32, adjoint=False,
                                 return_sequences=return_sequences)
    x = workers.seq_data(*APPLY)[0].astype(np.float32)
    return np.asarray(jmodel.apply(params, jax_coeffs(jnp.asarray(x), rectilinear=0)))


def _jax_references():
    ref = {}
    ref["plain"] = jax_solve(LIN, mesh=2)
    ref["plain_seq"] = jax_solve(LIN, mesh=2, grads=False, return_sequences=True)
    ref["scan"] = jax_solve(LIN)
    ref["scan_seq"] = jax_solve(LIN, grads=False, return_sequences=True)
    ref["composed"] = jax_solve(LIN, mesh=(2, 2))
    ref["composed_seq"] = jax_solve(LIN, mesh=(2, 2), grads=False, return_sequences=True)
    ref["apply_seq"], ref["apply"] = _jax_apply(True), _jax_apply(False)
    for name, kw in (("adjoint", {}), ("extreme_2", {"microbatches": 2}),
                     ("extreme_16", {"microbatches": 16}),
                     ("adjoint_online", {"return_sequences": True, "substeps": 2,
                                         "online_loss": True}),
                     ("midpoint", {"adjoint_method": "midpoint", "substeps": 2})):
        ref[name] = jax_solve(ADJ, mesh=2, adjoint=True, **kw)
    ref["composed_adjoint"] = jax_solve(ADJ, mesh=(2, 2), adjoint=True)
    ref["composed_online"] = jax_solve(ADJ, mesh=(2, 2), adjoint=True, return_sequences=True,
                                       substeps=2, online_loss=True)
    ref["interval_adjoint"] = jax_solve(ADJ, adjoint=True)
    ref["interval_adjoint_ss4"] = jax_solve(ADJ, adjoint=True, substeps=4)
    ref["interval_online"] = jax_solve(ADJ, adjoint=True, return_sequences=True, substeps=2,
                                       online_loss=True)
    ref["interval_midpoint"] = jax_solve(ADJ, adjoint=True, adjoint_method="midpoint",
                                         substeps=2)
    ref["drift"] = jax_solve(DRIFT, mesh=2, adjoint=True)
    ref["interval_drift"] = jax_solve(DRIFT, adjoint=True)
    rect = dict(interpolation="rectilinear")
    ref["paired_seq"] = jax_solve(RECT, mesh=2, grads=False, return_sequences=True, **rect)
    ref["paired"] = jax_solve(RECT, mesh=2, **rect)
    ref["paired_adjoint"] = jax_solve(RECT, mesh=2, adjoint=True, substeps=2, **rect)
    ref["scan_paired_seq"] = jax_solve(RECT, grads=False, return_sequences=True, **rect)
    ref["scan_paired"] = jax_solve(RECT, **rect)
    ref["interval_paired"] = jax_solve(RECT, adjoint=True, substeps=2, **rect)
    for key, (n, data, M) in FUZZ.items():
        ref[f"fuzz_{key}"] = jax_solve(data, grads=False)
    ref["refusals"] = _jax_refusals()
    return ref


# ------------------------------------------------------------- the ranks


def _start(world, tmp_dir):
    import socket

    out = os.path.join(tmp_dir, f"world{world}")
    os.makedirs(out)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    spec = {"world": world, "address": address, "out": out, "cases": WORLDS[world]}
    return spec, tmp.spawn(workers.sequence_rank, args=(spec,), nprocs=world, join=False)


def _join(spec, context, deadline):
    """The ranks' results in rank order; a rank that fails or outlives the
    deadline fails the fixture (the others are stopped)."""
    try:
        while not context.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"sequence ranks still running after {SPAWN_TIMEOUT_S} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
    return [torch.load(os.path.join(spec["out"], f"seq_rank{r}.pt"), weights_only=False)
            for r in range(spec["world"])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks' results and the JAX references, computed while
    the ranks run."""
    tmp_dir = str(tmp_path_factory.mktemp("sequence"))
    started = {world: _start(world, tmp_dir) for world in WORLDS}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        ref = _jax_references()
    finally:
        ranks = {}
        for world, (spec, context) in started.items():
            ranks[world] = _join(spec, context, deadline)
    return ranks, ref


def _get(runs, name, world=2):
    return runs[0][world][0][name]


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def close_run(got, want, rtol=RTOL, atol=ATOL, grads=True, what=""):
    """Outputs (and gradients) of a port run against a JAX run."""
    close(got["out"], want["out"], rtol, atol, f"{what} out")
    if grads:
        assert set(got["grads"]) == set(want["grads"]), what
        for key, w in want["grads"].items():
            close(got["grads"][key], w, rtol, atol, f"{what} gradient of {key}")


def _gap(got, want):
    return max(float(np.abs(got["grads"][k].numpy() - w).max())
               for k, w in want["grads"].items())


# ------------------------------------------------------------- the tests


def test_pipelined_solve_matches_plain_scan(runs):
    """Terminal states at M=4 and 16, per-knot states, and the gradients
    of the weights, z0 and x: the JAX pipeline at rtol 1e-9 (M=4), the
    plain scan at the JAX test's tolerances (values 1e-6, gradients 1e-4 /
    1e-5)."""
    ref = runs[1]
    close_run(_get(runs, "plain"), ref["plain"], what="M=4")
    close_run(_get(runs, "plain_seq"), ref["plain_seq"], grads=False, what="sequences")
    for name in ("plain", "plain_m16"):
        close(_get(runs, name)["out"], ref["scan"]["out"], 1e-6, 1e-6, name)
    close(_get(runs, "plain_seq")["out"], ref["scan_seq"]["out"], 1e-6, 1e-6)
    close_run(_get(runs, "plain"), ref["scan"], 1e-4, 1e-5, what="against the scan")
    # At f64 the pipeline computes the scan's arithmetic: M=16 holds to it
    # at the pipelines' own 1e-9.
    close(_get(runs, "plain_m16")["out"], ref["scan"]["out"], what="M=16")


def test_uneven_chunks_are_refused(runs):
    """11 pieces over 2 seq ranks, and a batch of 16 in 5 microbatches:
    the JAX package's errors, word for word."""
    got, want = _get(runs, "refusals"), runs[1]["refusals"]
    assert "divide evenly" in got["uneven"]
    for key in ("uneven", "microbatches"):
        assert got[key] == want[key], key


def test_remat_gradients_identical(runs):
    """``remat=True`` (each chunk solve recomputed in the backward) leaves
    the gradients where they were: against the same run without it (the
    JAX test's 1e-6 / 1e-7) and against the JAX pipeline (rtol 1e-9)."""
    got, plain = _get(runs, "remat"), _get(runs, "plain")
    for key, g in plain["grads"].items():
        close(got["grads"][key], g.numpy(), 1e-6, 1e-7, key)
    close_run(got, runs[1]["plain"])


def test_ncde_apply_pipelined_matches_model_apply(runs):
    """The model entry point in float32 (h0, the fused field paired on
    rectilinear pieces, the head, the ``::2`` filtering) against JAX's
    ``model.apply``, online and terminal, at rtol 1e-5; a non-fixed solver
    is refused with JAX's message."""
    for name in ("apply_seq", "apply"):
        got, want = _get(runs, name)["out"], runs[1][name]
        assert tuple(got.shape) == want.shape
        close(got, want, 1e-5, 1e-5, name)
    got, want = _get(runs, "refusals")["solver"], runs[1]["refusals"]["solver"]
    assert got == want and "pipelined NCDE forward" in got


def test_data_by_sequence_composed_pipeline(runs):
    """A (2 data x 2 seq) mesh: terminal and per-knot states and the
    gradients against the JAX pipeline over the same mesh (rtol 1e-9) and
    the plain scan (the JAX test's 1e-6 and 1e-4 / 1e-6); microbatch rows
    that do not divide the data axis are refused with JAX's message."""
    ref = runs[1]
    close_run(_get(runs, "composed", 4), ref["composed"], what="composed")
    close_run(_get(runs, "composed_seq", 4), ref["composed_seq"], grads=False)
    close(_get(runs, "composed", 4)["out"], ref["scan"]["out"], 1e-6, 1e-6)
    close(_get(runs, "composed_seq", 4)["out"], ref["scan_seq"]["out"], 1e-6, 1e-6)
    close_run(_get(runs, "composed", 4), ref["scan"], 1e-4, 1e-6, what="against the scan")
    got = _get(runs, "composed_refusal", 4)["data"]
    assert got == ref["refusals"]["data"] and "divide over" in got


def test_adjoint_matches_interval_adjoint(runs):
    """The reverse-schedule adjoint: the loss and the gradients of the
    weights, z0 and x against the JAX pipeline's adjoint (rtol 1e-9) and
    the interval adjoint (the loss at 1e-6, gradients at the JAX test's
    5e-3 / 5e-4); the gap to the interval adjoint shrinks at solver order
    with the substeps (below a quarter and below 5e-5 at 4)."""
    ref = runs[1]
    got = _get(runs, "adjoint")
    close_run(got, ref["adjoint"])
    close(got["loss"], ref["interval_adjoint"]["loss"], 1e-6, 0.0)
    close_run(got, ref["interval_adjoint"], 5e-3, 5e-4, what="against the interval adjoint")
    gap1 = _gap(got, ref["interval_adjoint"])
    gap4 = _gap(_get(runs, "adjoint_ss4"), ref["interval_adjoint_ss4"])
    assert gap4 < gap1 / 4, (gap1, gap4)
    assert gap4 < 5e-5, (gap1, gap4)


def test_adjoint_drift_on_longer_chunks_is_the_designs(runs):
    """At chunks of 16 pieces the pipelined adjoint's gradients miss the
    interval adjoint's at the JAX tests' 5e-3 / 5e-4, in both packages
    alike (the port's pipeline against JAX's at 1e-9): the state is
    reverse-integrated through a whole chunk (JAX's design), and how far
    that drifts depends on the chunk and the data.  So the smoke run
    reads, and does not gate, the flagship's pipelined adjoint (100
    pieces a rank) against the interval adjoint."""
    ref = runs[1]
    got = _get(runs, "drift")
    close_run(got, ref["drift"])
    close(got["loss"], ref["interval_drift"]["loss"], 1e-6, 0.0)
    for run in (got, ref["drift"]):
        assert not all(np.allclose(np.asarray(run["grads"][k]), w, rtol=5e-3, atol=5e-4)
                       for k, w in ref["interval_drift"]["grads"].items())


def test_adjoint_composes_with_data_axis(runs):
    ref = runs[1]
    got = _get(runs, "composed_adjoint", 4)
    close_run(got, ref["composed_adjoint"])
    close(got["loss"], ref["interval_adjoint"]["loss"], 1e-6, 0.0)
    close_run(got, ref["interval_adjoint"], 5e-3, 5e-4, what="against the interval adjoint")


def test_adjoint_online_matches_interval_adjoint(runs):
    """Per-knot outputs under the adjoint: each knot's cotangent joins at
    the rank that owns it; a per-knot weighted loss at 2 substeps."""
    ref = runs[1]
    got = _get(runs, "adjoint_online")
    close_run(got, ref["adjoint_online"])
    close(got["loss"], ref["interval_online"]["loss"], 1e-6, 0.0)
    close_run(got, ref["interval_online"], 5e-3, 5e-4, what="against the interval adjoint")


def test_adjoint_online_composes_with_data_axis(runs):
    ref = runs[1]
    got = _get(runs, "composed_online", 4)
    close_run(got, ref["composed_online"])
    close(got["loss"], ref["interval_online"]["loss"], 1e-6, 0.0)
    close_run(got, ref["interval_online"], 5e-3, 5e-4, what="against the interval adjoint")


def test_adjoint_memory_flat_in_ticks(runs):
    """The bytes a rank saves for backward (``saved_tensors_hooks``, the
    caller's tensors left out) from 16 to 128 pieces: the adjoint's stay
    nearly flat (its chunk of the pieces and one batch of boundary
    states), direct autograd's grow with the ticks."""
    mem = _get(runs, "memory")
    adj, direct = mem[True], mem[False]
    assert direct[1] > 4 * direct[0], direct
    assert adj[1] < 2 * adj[0] + 65536, adj
    assert adj[1] < direct[1] / 4, (adj, direct)


def test_harness_train_step_through_pipelined_adjoint(runs):
    """``make_train_step`` without ``mesh=`` over a module whose forward is
    ``ncde_apply_pipelined(adjoint=True)`` takes the plain model's step
    (the loss at 1e-6, the weights at the JAX test's 5e-3 / 5e-4: the
    adjoints differ within a chunk), and the loss falls over 4 steps."""
    got = _get(runs, "harness")
    close(got["loss"], got["plain_loss"].numpy(), 1e-6, 0.0)
    for key, w in got["plain_params"].items():
        close(got["params"][key], w.numpy(), 5e-3, 5e-4, key)
    losses = got["losses"].numpy()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("M", [2, 16])
def test_adjoint_microbatch_extremes(runs, M):
    """Fewer microbatches than ranks' work and one row a microbatch: values
    against the plain scan (1e-6), gradients against the JAX pipeline
    (1e-9) and the interval adjoint (5e-3 / 5e-4)."""
    ref = runs[1]
    got = _get(runs, f"extreme_{M}")
    close_run(got, ref[f"extreme_{M}"])
    close(got["out"], ref["interval_adjoint"]["out"], 1e-6, 1e-6)
    close_run(got, ref["interval_adjoint"], 5e-3, 5e-4, what="against the interval adjoint")


def test_paired_rectilinear_matches_plain_paired(runs):
    """Paired chunks (the time-advance intervals on the cheap field):
    per-knot states, direct and adjoint gradients against the JAX pipeline
    (1e-9) and the paired scan / adjoint (values 1e-6; gradients the JAX
    test's rtol 1e-5 direct, 5e-3 adjoint, atol 100 rtol)."""
    ref = runs[1]
    close_run(_get(runs, "paired_seq"), ref["paired_seq"], grads=False)
    close(_get(runs, "paired_seq")["out"], ref["scan_paired_seq"]["out"], 1e-6, 1e-6)
    close_run(_get(runs, "paired"), ref["paired"])
    close_run(_get(runs, "paired_adjoint"), ref["paired_adjoint"])
    close_run(_get(runs, "paired"), ref["scan_paired"], 1e-5, 1e-3, what="direct")
    close_run(_get(runs, "paired_adjoint"), ref["interval_paired"], 5e-3, 5e-1,
              what="adjoint")


@pytest.mark.parametrize("key", sorted(FUZZ))
def test_fuzz_pipeline_schedules_match_plain_scan(runs, key):
    """(ranks, pieces a rank, microbatches, batch) across worlds of 2-4
    ranks against JAX's plain scan, at the pipelines' rtol 1e-9 (the JAX
    test's is 1e-6)."""
    got = _get(runs, f"fuzz_{key}", FUZZ[key][0])
    close(got["out"], runs[1][f"fuzz_{key}"]["out"])


def test_adjoint_honours_adjoint_method(runs):
    """``adjoint_method="midpoint"``: against the JAX pipeline (1e-9) and
    the interval adjoint with the same method (the JAX test's 5e-2 /
    1e-2, 2 substeps), and not the rk4 reverse (the knob is live)."""
    ref = runs[1]
    got = _get(runs, "midpoint")
    close_run(got, ref["midpoint"])
    close_run(got, ref["interval_midpoint"], 5e-2, 1e-2, what="against the interval adjoint")
    diffs = _gap(_get(runs, "midpoint_ss1"), {"grads": {
        k: v.numpy() for k, v in _get(runs, "adjoint")["grads"].items()}})
    assert diffs > 1e-4, diffs


def test_unknown_adjoint_method_is_refused(runs):
    got, want = _get(runs, "refusals")["adjoint_method"], runs[1]["refusals"]["adjoint_method"]
    assert got == want and "must be one of" in got


def test_ranks_return_the_same_results_to_the_bit(runs):
    """The gradient contract: every rank returns the same outputs and the
    same full gradients (of the weights, z0 and x), bit for bit."""

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b

    for world, ranks in runs[0].items():
        for name, case, kw in WORLDS[world]:
            if case in ("schedule", "memory"):
                continue
            results = [r[name] for r in ranks if r[name] is not None]
            assert len(results) == world, (world, name)
            for r in results[1:]:
                assert same(r, results[0]), (world, name)


def test_schedules_reverse_each_other_and_neighbours_follow_the_grid(runs):
    """Each rank runs microbatches 0..M-1 at ticks k..k+M-1 and reverses
    them in the opposite order at the mirrored ticks; its neighbours along
    ``seq`` are the global ranks k-1 and k+1 of a 1-D mesh, and on the
    (2 x 2) grid they share the data coordinate."""
    for world, ranks in runs[0].items():
        for rank, r in enumerate(ranks):
            for key in ("schedule", "schedule_grid"):
                s = r.get(key)
                if s is None:
                    continue
                n, k, d = s["n"], s["k"], s["d"]
                M = len(s["fwd"])
                assert d * n + k == rank and (n == world or key == "schedule_grid")
                assert s["fwd"] == [(m + k, m) for m in range(M)]
                assert [m for _, m in s["bwd"]] == list(range(M - 1, -1, -1))
                assert all(t == M + n - 2 - (m + k) for t, m in s["bwd"])
                assert s["prev"] == (rank - 1 if k else None)
                assert s["next"] == (rank + 1 if k < n - 1 else None)


def _spline(kind, x):
    from online_neural_cdes_tpu_torch.ops import interpolation as itp

    if kind == "linear":
        return itp.LinearInterpolation.create(itp.linear_interpolation_coeffs(x))
    if kind == "natural_cubic":
        return itp.CubicSpline.create(itp.natural_cubic_coeffs(x))
    if kind == "hermite":
        return itp.CubicSpline.create(
            itp.hermite_cubic_coefficients_with_backward_differences(x))
    return itp.SmoothLinearInterpolation.create(
        itp.linear_interpolation_coeffs(x), 0.3, match_second_derivatives=kind == "quintic")


@pytest.mark.parametrize("kind", ["linear", "natural_cubic", "hermite", "smooth", "quintic"])
def test_a_chunks_pieces_are_the_whole_series_pieces(kind):
    """What each seq rank builds, ``piece_data(lo, hi)`` from its chunk's
    knots alone, equals those pieces of the whole series' to the bit, and
    the chunks' cotangents summed reach the observations as the whole
    series' do."""
    x = torch.tensor(workers.seq_data(3, 13, 31)[0], requires_grad=True)
    spline = _spline(kind, x)
    whole = spline.piece_data()
    chunks = [spline.piece_data(lo, lo + 4) for lo in range(0, 12, 4)]
    w = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(5), dtype=v.dtype)
         if v.is_floating_point() else None for k, v in whole.items()}
    for key, v in whole.items():
        assert torch.equal(torch.cat([c[key] for c in chunks]), v), key

    def grad(pieces_list):
        loss = sum((c[k] * w[k][lo * 4:(lo + 1) * 4]).sum()
                   for lo, c in enumerate(pieces_list) for k in c if w[k] is not None)
        return torch.autograd.grad(loss, x, retain_graph=True)[0]

    ours = grad(chunks)
    theirs = grad([{k: v[lo * 4:(lo + 1) * 4] for k, v in whole.items()} for lo in range(3)])
    close(ours, theirs.numpy(), 1e-12, 1e-12)
