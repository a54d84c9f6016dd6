"""Worker functions that tests/test_torch_port_parallel.py spawns as ranks
of a gloo group.  They import torch and the port only, so a spawned rank
starts in seconds (the test module imports JAX).  No tests here."""

import os

import torch
import torch.distributed as dist

from online_neural_cdes_tpu_torch.parallel import mesh as pm


def hyperopt_rank(rank, address, log_dir):
    """One rank of a search over a two-rank mesh whose trials fail on rank
    1 alone, while rank 0 waits in the trial's all-reduce; each rank logs
    the trials it enters."""
    from online_neural_cdes_tpu_torch.training import hyperopt

    dist.init_process_group("gloo", init_method=address, world_size=2, rank=rank)
    try:
        def trial(cfg, **kw):
            with open(os.path.join(log_dir, f"rank{rank}"), "a") as fh:
                fh.write("trial\n")
            if rank == 1:
                raise OSError("planted failure on rank 1")
            dist.all_reduce(torch.ones(1))
            return {"val.loss": 1.0}

        hyperopt.run_experiment = trial
        hyperopt.run_hyperopt(
            {"parameterization": [{"name": "trainer__lr", "type": "range",
                                   "bounds": [1e-3, 1e-1]}],
             "total_trials": 4, "search": "sobol"},
            mesh=pm.make_mesh(2, devices="cpu"), device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The time-pipelined solve (tests/test_torch_port_sequence.py)
# ---------------------------------------------------------------------------

SEQ_C, SEQ_H, SEQ_HH = 3, 8, 12


def seq_data(B, L, seed, time_channel=False):
    """Observations (B, L, C) (channel 0 the time when ``time_channel``),
    initial states (B, H) and per-knot weights (L,) from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, SEQ_C)) * 0.3
    if time_channel:
        x[:, :, 0] = np.arange(L)
    z0 = rng.normal(size=(B, SEQ_H)) * 0.1
    return x, z0, rng.normal(size=(L,))


def seq_model(interpolation="linear", output_dim=2, dtype=torch.float64, **kw):
    """The port's NeuralCDE the sequence checks run (weights from seed 0;
    the parent copies them into the JAX model)."""
    from online_neural_cdes_tpu_torch import NeuralCDE

    return NeuralCDE(SEQ_C, SEQ_H, output_dim, hidden_hidden_dim=SEQ_HH, num_layers=1,
                     interpolation=interpolation, generator=torch.Generator().manual_seed(0),
                     device="cpu", dtype=dtype, **kw)


def _field_names(model):
    return [name for name, _ in model.named_parameters() if name.startswith("field.")]


def seq_solve(model, data, *, mesh, interpolation="linear", grads=True, online_loss=False,
              **kw):
    """``pipelined_cde_solve`` over the model's fused field on ``data`` (x,
    z0, w); returns the output and, with ``grads``, the gradients of the
    JAX tests' loss (sum of squares, per-knot weighted for ``online_loss``)
    with respect to the field's weights (by name), ``z0`` and ``x``."""
    from online_neural_cdes_tpu_torch.models.ncde import make_spline
    from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel.sequence import pipelined_cde_solve

    x_np, z0_np, w_np = data
    dtype = model.dtype
    x = torch.tensor(x_np, dtype=dtype, requires_grad=grads)
    z0 = torch.tensor(z0_np, dtype=dtype, requires_grad=grads)
    rect = 0 if interpolation == "rectilinear" else None
    spline = make_spline(interpolation, linear_interpolation_coeffs(x, rectilinear=rect))
    func, even, args, vf = model.make_solve_func(z0)
    out = pipelined_cde_solve(spline, func, z0, args, mesh=mesh, vector_field_type=vf,
                              even_func=even, **kw)
    if not grads:
        return {"out": out.detach()}
    w = torch.tensor(w_np, dtype=dtype)[:, None] if online_loss else 1.0
    loss = ((out * w) ** 2).sum()
    names = _field_names(model)
    params = dict(model.named_parameters())
    g = torch.autograd.grad(loss, [params[n] for n in names] + [z0, x])
    return {"out": out.detach(), "loss": loss.detach(),
            "grads": dict(zip(names + ["z0", "x"], g))}


def _saved_bytes(fn, inputs):
    """Bytes ``fn`` (a forward) saves for the backward, each storage once,
    the storages of ``inputs`` (the caller's tensors) left out."""
    seen = {t.untyped_storage().data_ptr() for t in inputs}
    total = [0]

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in seen:
            seen.add(ptr)
            total[0] += t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


def seq_memory(mesh, L, adjoint):
    """The bytes a pipelined solve of B=8 rows over L observations saves on
    this rank for its backward, its chunk's pieces included (the
    observations, their coefficients, z0 and the weights are the caller's,
    built outside); the backward then runs, so every rank's sends meet
    their receives."""
    from online_neural_cdes_tpu_torch.models.ncde import make_spline
    from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel.sequence import pipelined_cde_solve
    from online_neural_cdes_tpu_torch.utils.tree import flatten

    model = seq_model()
    x_np, z0_np, _ = seq_data(8, L, 5)
    x = torch.tensor(x_np, requires_grad=True)
    z0 = torch.tensor(z0_np, requires_grad=True)
    spline = make_spline("linear", linear_interpolation_coeffs(x))
    func, even, args, vf = model.make_solve_func(z0)
    inputs = [x, z0, spline.coeffs, spline.t, *flatten(args)[0]]

    outs = []

    def run():
        outs.append(pipelined_cde_solve(spline, func, z0, args, mesh=mesh,
                                        vector_field_type=vf, microbatches=4,
                                        adjoint=adjoint))

    saved = _saved_bytes(run, inputs)
    torch.autograd.grad((outs[0] ** 2).sum(), [z0])
    return saved


def seq_harness(mesh):
    """The harness's train step through the pipelined adjoint:
    ``PipelinedNCDE`` (the JAX test's ``apply_piped``), stepped by
    ``make_train_step`` without ``mesh=``,
    against the plain model's step; four steps' losses."""
    import numpy as np

    from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel.sequence import PipelinedNCDE
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    x, _, _ = seq_data(16, 9, 2, time_channel=True)
    coeffs = linear_interpolation_coeffs(torch.tensor(x), rectilinear=0)
    labels = torch.tensor((x[:, :, 1].sum(1) > 0).astype(np.float64))
    kw = dict(interpolation="rectilinear", output_dim=1, adjoint=True)
    piped, plain = seq_model(**kw), seq_model(**kw)
    step_piped = make_train_step(PipelinedNCDE(piped, mesh=mesh, microbatches=4, adjoint=True),
                                 loss="bce", lr=1e-2)
    step_plain = make_train_step(plain, loss="bce", lr=1e-2)
    losses = [step_piped(coeffs, labels, 1.0)]
    plain_loss = step_plain(coeffs, labels, 1.0)
    first = {k: v.clone() for k, v in piped.state_dict().items()}
    for _ in range(3):
        losses.append(step_piped(coeffs, labels, 1.0))
    return {"loss": losses[0], "plain_loss": plain_loss, "params": first,
            "plain_params": plain.state_dict(), "losses": torch.stack(losses)}


def sequence_rank(rank, spec):
    """One rank of the sequence checks: joins the gloo group of
    ``spec["world"]`` ranks, runs ``spec["cases"]`` (name, function name of
    this module's ``SEQ_CASES``, keyword arguments) and saves the results
    to ``<spec["out"]>/seq_rank<rank>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=spec["address"], world_size=spec["world"],
                            rank=rank)
    try:
        out = {}
        meshes = {}
        for name, case, kw in spec["cases"]:
            out[name] = SEQ_CASES[case](rank, meshes, **kw)
        torch.save(out, os.path.join(spec["out"], f"seq_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _mesh(meshes, shape):
    """The mesh of ``shape`` (a seq size, or (data, seq)) over the world's
    first ranks, built once (every rank builds every mesh in one order);
    None on a rank outside it."""
    from online_neural_cdes_tpu_torch.parallel.mesh import make_grid_mesh
    from online_neural_cdes_tpu_torch.parallel.sequence import make_sequence_mesh

    if shape not in meshes:
        try:
            meshes[shape] = (make_grid_mesh(("data", "seq"), shape, devices="cpu")
                             if isinstance(shape, tuple) else
                             make_sequence_mesh(shape, devices="cpu"))
        except ValueError as exc:
            if "outside the mesh" not in str(exc):
                raise
            meshes[shape] = None
    return meshes[shape]


def _case_solve(rank, meshes, mesh, data, interpolation="linear", model_kw=None, **kw):
    m = _mesh(meshes, mesh)
    if m is None:
        return None
    model = seq_model(interpolation, **(model_kw or {}))
    data_axis = "data" if isinstance(mesh, tuple) else None
    return seq_solve(model, seq_data(*data), mesh=m, interpolation=interpolation,
                     data_axis=data_axis, **kw)


def _case_apply(rank, meshes, mesh, data, return_sequences):
    """``ncde_apply_pipelined`` of a float32 rectilinear model."""
    from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel.sequence import ncde_apply_pipelined

    m = _mesh(meshes, mesh)
    model = seq_model("rectilinear", dtype=torch.float32, adjoint=False,
                      return_sequences=return_sequences)
    x = torch.tensor(seq_data(*data)[0], dtype=torch.float32)
    coeffs = linear_interpolation_coeffs(x, rectilinear=0)
    with torch.no_grad():
        return {"out": ncde_apply_pipelined(model, coeffs, mesh=m, microbatches=4)}


def _case_refusals(rank, meshes, mesh):
    """The messages of every refusal the JAX entry points give."""
    from online_neural_cdes_tpu_torch.models.ncde import make_spline
    from online_neural_cdes_tpu_torch.ops.interpolation import linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.parallel.sequence import (
        ncde_apply_pipelined, pipelined_cde_solve)

    m = _mesh(meshes, mesh)
    messages = {}

    def refused(key, fn):
        try:
            fn()
            messages[key] = None
        except ValueError as exc:
            messages[key] = str(exc)

    if isinstance(mesh, tuple):
        refused("data", lambda: seq_solve(seq_model(), seq_data(6, 17, 3), mesh=m,
                                          data_axis="data", microbatches=2))
        return messages
    uneven = make_spline("linear", linear_interpolation_coeffs(torch.zeros(4, 12, 2)))
    refused("uneven", lambda: pipelined_cde_solve(uneven, lambda t, z, a: z,
                                                  torch.zeros(4, 3), None, mesh=m))
    model = seq_model()
    data = seq_data(16, 17, 3)
    refused("adjoint_method", lambda: seq_solve(model, data, mesh=m, microbatches=4,
                                                adjoint=True, adjoint_method="dopri5"))
    refused("microbatches", lambda: seq_solve(model, data, mesh=m, microbatches=5))
    bad = seq_model("rectilinear", solver="dopri5", adjoint=False)
    x = torch.tensor(seq_data(16, 9, 0, time_channel=True)[0])
    refused("solver", lambda: ncde_apply_pipelined(
        bad, linear_interpolation_coeffs(x, rectilinear=0), mesh=m))
    return messages


def _case_memory(rank, meshes, mesh, lengths):
    m = _mesh(meshes, mesh)
    return {adjoint: [seq_memory(m, L, adjoint) for L in lengths]
            for adjoint in (True, False)}


def _case_harness(rank, meshes, mesh):
    return seq_harness(_mesh(meshes, mesh))


def _case_schedule(rank, meshes, mesh, M):
    """Both schedules of this rank, and its neighbours."""
    from online_neural_cdes_tpu_torch.parallel import sequence

    m = _mesh(meshes, mesh)
    k, n = m.axis_index("seq"), m.axis_size("seq")
    return {"fwd": sequence._fwd_slots(k, M), "bwd": sequence._bwd_slots(k, n, M),
            "prev": m.neighbour("seq", -1), "next": m.neighbour("seq", 1), "k": k, "n": n,
            "d": m.axis_index("data") if "data" in m.shape else 0}


SEQ_CASES = {"solve": _case_solve, "apply": _case_apply, "refusals": _case_refusals,
             "memory": _case_memory, "harness": _case_harness, "schedule": _case_schedule}
