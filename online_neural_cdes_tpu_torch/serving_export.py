"""Exported serving artifacts.

PyTorch counterpart of the JAX package's ``serving_export.py``.  The live
:class:`~online_neural_cdes_tpu_torch.serving.Predictor` needs the model
code in the serving process.  This module writes the predictor's whole
bucket grid -- the coefficient build *and* the forward, each shape staged
out with ``torch.export`` -- into one directory that serves without it:

* ``manifest.json`` -- the bucket grid and the host-side padding policy,
* ``params.npz`` -- the weights, written once; they are an *argument* of
  every exported module, so :func:`update_params` rolls a same-architecture
  checkpoint into the artifact without exporting again,
* ``modules/<key>.pt2`` -- one ``torch.export.save`` per shape: per
  (batch bucket, length bucket) for a predictor, ``step_b{b}``,
  ``init_b{b}``, ``readout_b{b}`` and ``stepblock{K}_b{b}`` for a stepper.

The leaves of ``params.npz`` are the model's ``state_dict`` in the JAX
pytree's flatten order (dict keys sorted, lists in order), so for the same
weights they equal the JAX artifact's leaf for leaf; the manifest's
``treedef`` is their names.  Format version 2: a leaf numpy cannot hold
(bfloat16) is stored as its same-width unsigned-int bit pattern; version 1
(such leaves stored float32-upcast) is still read.  sha256 digests cover
``params.npz`` and every module, so a corrupted copy refuses to load.

Each module's loop over the knots is one ``scan`` (``ops/cdeint.py``), not
an unrolled copy per knot, and runs the interval function the live solve
runs, so a loaded artifact serves the live server's outputs to the bit.
An adaptive or Adams solve (every method but ``scipy_solver``, which the
JAX package cannot export either) traces into its tensor form
(``ops/solvers.py``: a ``scan`` over the output times of ``while_loop``
attempts, or a ``scan`` over the Adams steps): its program also returns
the solves' nfe / accepted / rejected, which the loaded predictor counts
under ``solvers.COUNTS`` as the live solve does (manifest key
``solve_stats``), and its step-deciding reductions are the op
``oncde::data_all_reduce`` (``ops/reduce.py``), so a loaded artifact over
a mesh steps as one process over the whole bucket.
The fused field is the op ``oncde::fused_field_forward``
(``ops/kernels.py``): its kernel on the card, its plain version on the
CPU.  A module is traced on the server's device and moved to the device
that loads it, so one artifact serves on ``platforms=("cuda", "cpu")``;
``device=None`` means the card and raises when none is visible.  A
module's batch axis is dynamic: one program, traced at the largest bucket,
serves every bucket of its length (each key's file holds it; the loader
loads equal files once), and ``load_predictor(path, mesh=)`` and
``load_stepper(path, mesh=)`` run each rank's share of a bucket as a live
server over a mesh does.

The loader imports this module, the servers and the op library, never a
model class.  Exported programs run their ``scan`` nodes as a loop over
the combine graph and their ``while_loop`` nodes as a Python ``while``
over the body graph (:func:`_loop_scans`).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from online_neural_cdes_tpu_torch.ops import kernels  # noqa: F401  (registers the op)
from online_neural_cdes_tpu_torch.ops import solvers
from online_neural_cdes_tpu_torch.parallel.mesh import data_axis_size, replicate
from online_neural_cdes_tpu_torch.serving import (
    Predictor, _check_backlog_layout, _gather_streams, _mesh_device, _round_up,
    _stream_rows, _to_device, _tree,
)
from online_neural_cdes_tpu_torch.utils.tree import map_arrays

__all__ = [
    "export_predictor",
    "load_predictor",
    "export_stepper",
    "load_stepper",
    "update_params",
]

_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
_MODULES = "modules"
_EXT = ".pt2"
# v1: extension-float leaves stored f32-upcast.  v2: stored as raw
# same-width unsigned-int bit patterns.  The reader accepts both; the
# writer stamps v2 so a v1-only loader refuses a bit-pattern artifact.
_FORMAT_VERSION = 2
_READABLE_FORMAT_VERSIONS = (1, 2)


def _shape_key(batch: int, length: int) -> str:
    return f"b{batch}_l{length}"


def _flatten_params(state):
    """(names, leaves): a ``state_dict``'s tensors in the JAX flatten order
    of its pytree (``serving._tree``: dict keys sorted, lists in order).
    Every leaf must be a tensor."""
    if not isinstance(state, dict):
        raise TypeError(f"params must be a state_dict (a dict of tensors), got "
                        f"{type(state).__name__}")
    for name, leaf in state.items():
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"non-numeric parameter leaf {name!r}: {leaf!r}")
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + [key])
        elif isinstance(node, list):
            for i, child in enumerate(node):
                walk(child, path + [str(i)])
        else:
            names.append(".".join(path))

    walk(_tree(state, ""), [])
    return names, [state[n] for n in names]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype, or None when numpy has none."""
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        return None


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as numpy: its own dtype, or its same-width unsigned-int bit
    pattern for a dtype numpy has not (bfloat16)."""
    leaf = leaf.detach().cpu().contiguous()
    if _numpy_dtype(leaf.dtype) is not None:
        return leaf.numpy()
    width = leaf.element_size()
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[width]
    return leaf.view(bits).numpy().view(np.dtype(f"u{width}"))


def _from_numpy(raw: np.ndarray, name: str) -> torch.Tensor:
    """A stored leaf back as a tensor of the dtype ``name``: a bit pattern
    viewed back (v2), anything else value-cast (v1's f32 upcast)."""
    dtype = getattr(torch, name)
    if (_numpy_dtype(dtype) is None and raw.dtype.kind == "u"
            and raw.dtype.itemsize == torch.empty(0, dtype=dtype).element_size()):
        signed = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[raw.dtype.itemsize]
        return torch.from_numpy(raw.view(signed).copy()).view(dtype)
    return torch.from_numpy(np.array(raw)).to(dtype)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _stage_params(path, leaves):
    """Write params.npz to a temp file and return (tmp_path, sha256)
    without publishing it; callers ``os.replace`` when their commit
    protocol says so."""
    out = {f"p{i:04d}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    tmp = os.path.join(path, _PARAMS + ".tmp.npz")
    np.savez(tmp, **out)
    return tmp, _sha256(tmp)


def _write_artifact(path, leaves, named_programs, manifest):
    """The one artifact writer: modules/*.pt2, params.npz and the manifest.
    Modules of an earlier export into the same directory are removed
    first, so a stale shape can never be served.  A program several keys
    share is serialized once and written under each."""
    mod_dir = os.path.join(path, _MODULES)
    os.makedirs(mod_dir, exist_ok=True)
    for fname in os.listdir(mod_dir):
        if fname.endswith(_EXT):
            os.remove(os.path.join(mod_dir, fname))
    module_sha, blobs = {}, {}
    for name, program in named_programs:
        if id(program) not in blobs:
            buf = io.BytesIO()
            torch.export.save(program, buf)
            blobs[id(program)] = buf.getvalue()
        mod_path = os.path.join(mod_dir, name + _EXT)
        with open(mod_path, "wb") as f:
            f.write(blobs[id(program)])
        module_sha[name] = _sha256(mod_path)
    tmp, params_sha = _stage_params(path, leaves)
    os.replace(tmp, os.path.join(path, _PARAMS))
    manifest = dict(
        manifest,
        format_version=_FORMAT_VERSION,
        leaf_dtypes=[_dtype_name(leaf.dtype) for leaf in leaves],
        params_sha256=params_sha,
        module_sha256=module_sha,
    )
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def _cast_float_leaves(leaves, params_dtype):
    """Floating leaves cast to ``params_dtype`` (other leaves as they are):
    a bfloat16 artifact stores half the bytes and serves through the
    kernels' bf16 storage."""
    if params_dtype is None:
        return leaves
    dtype = getattr(torch, str(params_dtype), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"params_dtype must be a floating dtype, got {params_dtype!r}")
    return [leaf.to(dtype) if leaf.is_floating_point() else leaf for leaf in leaves]


def update_params(path: str, params) -> int:
    """Roll a new checkpoint (a ``state_dict``) into an existing artifact
    without exporting again: only ``params.npz`` is rewritten.  The new
    weights must have the artifact's leaf names (the manifest's
    ``treedef``), shapes and dtypes (floating leaves are cast to the
    artifact's floating dtype); anything else is refused before anything
    is written.  The rewrite is a two-phase commit, so a crash or a
    concurrent load never sees a torn artifact.  Returns the number of
    leaves written."""
    manifest = _load_manifest(path)
    names, leaves = _flatten_params(params)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"new params flatten to {len(leaves)} leaves; the artifact was "
            f"exported with {manifest['n_leaves']} -- a different "
            "architecture needs a re-export, not a params update")
    if names != manifest["treedef"]:
        raise ValueError(
            "new params' pytree structure differs from the artifact's -- "
            "same-index leaves would silently reassign weights across "
            "fields; a different architecture needs a re-export.\n"
            f"  artifact: {manifest['treedef']}\n  new:      {names}")
    cast = []
    for i, (leaf, name) in enumerate(zip(leaves, manifest["leaf_dtypes"])):
        leaf = leaf.detach()
        if _dtype_name(leaf.dtype) != name:
            want = getattr(torch, name)
            if not (leaf.is_floating_point() and want.is_floating_point):
                raise ValueError(
                    f"leaf #{i}: new dtype {_dtype_name(leaf.dtype)} != exported {name} "
                    "-- a different architecture needs a re-export, not a params update")
            leaf = leaf.to(want)
        cast.append(leaf)
    with np.load(os.path.join(path, _PARAMS)) as old:
        for i, leaf in enumerate(cast):
            if tuple(leaf.shape) != old[f"p{i:04d}"].shape:
                raise ValueError(
                    f"leaf #{i}: new shape {tuple(leaf.shape)} != exported "
                    f"{old[f'p{i:04d}'].shape} -- a different architecture needs "
                    "a re-export, not a params update")
    # Two-phase commit: stage the new params, publish a manifest that
    # accepts either digest (the old one as `params_sha256_prev`), then
    # replace params.npz.
    tmp_params, params_sha = _stage_params(path, cast)
    manifest["params_sha256_prev"] = manifest.get("params_sha256")
    manifest["params_sha256"] = params_sha
    if any(_numpy_dtype(leaf.dtype) is None for leaf in cast):
        manifest["format_version"] = _FORMAT_VERSION   # bit patterns: v2
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, _MANIFEST))
    os.replace(tmp_params, os.path.join(path, _PARAMS))
    return len(cast)


def _load_manifest(path: str) -> dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] not in _READABLE_FORMAT_VERSIONS:
        raise ValueError(
            f"artifact format v{manifest['format_version']} not in "
            f"{_READABLE_FORMAT_VERSIONS} supported by this loader")
    return manifest


def _read_manifest(path: str, expected_artifact: str) -> dict:
    manifest = _load_manifest(path)
    artifact = manifest.get("artifact", "predictor")
    if artifact != expected_artifact:
        raise ValueError(f"this artifact is a {artifact!r}; use load_{artifact}() "
                         f"instead of load_{expected_artifact}()")
    return manifest


# ---------------------------------------------------------------------------
# Export and load of one program
# ---------------------------------------------------------------------------


class _Program(torch.nn.Module):
    """A function as the module ``torch.export`` takes; it holds no
    tensors, so the weights stay arguments."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args, batch):
    """``fn`` over ``args`` (the weights' list first) traced with
    ``torch.export``, every batch axis of size ``batch`` dynamic when
    ``batch`` > 1 (``args`` entries given as ``(tensor, batch_axis)``), so
    the program takes any number of rows: one program serves every bucket
    of a length, and a rank's share of a bucket over a mesh.  Dead nodes
    are removed from every graph."""
    dim = torch.export.Dim("batch", min=1) if batch > 1 else None
    example, dynamic = [], []
    for arg in args:
        if isinstance(arg, tuple):
            tensor, axis = arg
            example.append(tensor)
            dynamic.append({axis: dim} if dim is not None else None)
        else:
            example.append(arg)
            dynamic.append([None] * len(arg) if isinstance(arg, list) else None)
    with torch.no_grad():
        # Shape guards become runtime asserts: some releases cannot prove a
        # contiguity guard on the batch that holds for every batch size.
        program = torch.export.export(_Program(fn), tuple(example),
                                      dynamic_shapes=(tuple(dynamic),), strict=False,
                                      prefer_deferred_runtime_asserts_over_guards=True)
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            gm.graph.eliminate_dead_code()
            gm.recompile()
    program._example_inputs = None   # the weights are not part of a module file
    return program


def _scan_loop(combine_fn, init, xs, additional_inputs):
    """A ``scan`` node's semantics: ``combine_fn`` once per element of
    ``xs``' leading axis, the carry threaded through, the outputs stacked."""
    carry, n_init, outs = list(init), len(init), []
    for i in range(xs[0].shape[0]):
        res = combine_fn(*carry, *[x[i] for x in xs], *additional_inputs)
        carry, out = list(res[:n_init]), res[n_init:]
        outs.append(out)
    return (*carry, *[torch.stack([o[j] for o in outs]) for j in range(len(outs[0]))])


def _while_loop(cond_fn, body_fn, carried_inputs, additional_inputs):
    """A ``while_loop`` node's semantics: ``body_fn`` while ``cond_fn``
    holds (one host read of its 0-d bool each time), the carry threaded
    through."""
    carried = tuple(carried_inputs)
    while bool(cond_fn(*carried, *additional_inputs)):
        carried = tuple(body_fn(*carried, *additional_inputs))
    return carried


def _loop_scans(gm: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """Run every ``scan`` node of a loaded program through
    :func:`_scan_loop` and every ``while_loop`` node through
    :func:`_while_loop`.  ``scan``'s own eager implementation evaluates
    the combine graph once more for the outputs' shapes in some releases of
    PyTorch (one more interval's kernel launches for nothing); the Python
    loops do each iteration once whatever the release."""
    loops = {torch.ops.higher_order.scan: _scan_loop,
             torch.ops.higher_order.while_loop: _while_loop}
    for sub in gm.modules():
        if not isinstance(sub, torch.fx.GraphModule):
            continue
        changed = False
        for node in sub.graph.nodes:
            if node.op == "call_function" and node.target in loops:
                if len(node.args) != 4 or node.kwargs:
                    raise RuntimeError(
                        f"unexpected {node.target} node layout {len(node.args)} args, "
                        f"kwargs {sorted(node.kwargs)} (torch {torch.__version__})")
                node.target = loops[node.target]
                changed = True
        if changed:
            sub.recompile()
    return gm


def _load_program(file: str, device: torch.device):
    program = torch.export.load(file)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return _loop_scans(program.module())


def _read_artifact(path: str, expected_artifact: str, device: torch.device):
    """The one artifact reader: (manifest, weights on ``device``, loaded
    programs keyed by file stem)."""
    manifest = _read_manifest(path, expected_artifact)
    platforms = manifest.get("platforms", ["cuda", "cpu"])
    if device.type not in platforms:
        raise ValueError(f"the artifact was exported for platforms {platforms}, not "
                         f"{device.type!r}; re-export with platforms=(..., "
                         f"{device.type!r})")
    want_params = manifest.get("params_sha256")
    if want_params is not None:
        got = _sha256(os.path.join(path, _PARAMS))
        # `params_sha256_prev` names the previous version during
        # update_params' two-phase commit window.
        if got not in {want_params, manifest.get("params_sha256_prev")}:
            raise ValueError(
                f"artifact integrity check failed: params.npz sha256 {got[:12]}... != "
                f"manifest {want_params[:12]}... -- the artifact is corrupted or was "
                "partially copied; re-export or restore from a good copy")
    listed = manifest.get("module_sha256")
    mod_dir = os.path.join(path, _MODULES)
    for name, want in (listed or {}).items():
        mod_path = os.path.join(mod_dir, name + _EXT)
        if not os.path.exists(mod_path) or _sha256(mod_path) != want:
            raise ValueError(f"artifact integrity check failed: module {name!r} is "
                             "missing or corrupted -- re-export or restore from a good copy")
    with np.load(os.path.join(path, _PARAMS)) as npz:
        flat = [_from_numpy(npz[f"p{i:04d}"], name).to(device)
                for i, name in enumerate(manifest["leaf_dtypes"])]
    # The digest map is the exported set: a stray file is never served.
    # Keys whose files are equal share one loaded program.
    names = list(listed) if listed else [
        f[: -len(_EXT)] for f in os.listdir(mod_dir) if f.endswith(_EXT)]
    modules, by_digest = {}, {}
    for name in names:
        digest = listed[name] if listed else name
        if digest not in by_digest:
            by_digest[digest] = _load_program(os.path.join(mod_dir, name + _EXT), device)
        modules[name] = by_digest[digest]
    return manifest, flat, modules


# ---------------------------------------------------------------------------
# The predictor
# ---------------------------------------------------------------------------


def export_predictor(
    predictor: Predictor,
    path: str,
    *,
    channels: int,
    max_length: int,
    static_dim: Optional[int] = None,
    platforms: Sequence[str] = ("cuda", "cpu"),
    params_dtype: Optional[str] = None,
) -> int:
    """Write ``predictor``'s full bucket grid to ``path``.

    Each module computes ``model(coeff_fn(series))`` (with the static
    features first when ``static_dim`` is given) from the weights' leaves,
    the (b, L, channels) float32 series and the (b, static_dim) float32
    statics, cast to the model's dtype as the live predictor casts them,
    so ``load_predictor(path)`` serves the live predictor's outputs to the
    bit.  ``params_dtype`` (e.g. ``"bfloat16"``) stores the weights in
    that floating dtype and serves in it: outputs then match the float32
    predictor to reduced-precision tolerance; :func:`update_params` casts
    float checkpoints to it.

    Needs a ``coeff_fn`` and a model that ``torch.export`` can trace
    (every coefficient builder and model of the port, on every solver
    but ``scipy_solver``, which steps in scipy on the host and is
    refused) and a predictor without a mesh: shard at serve time with
    ``load_predictor(path, mesh=)``.  Returns the number of shapes
    exported."""
    if predictor.mesh is not None:
        raise ValueError(
            "cannot export a mesh-sharded Predictor: each module is one "
            "process's program. Export the plain predictor and shard at serve "
            "time with load_predictor(path, mesh=...) instead.")
    if static_dim is not None and not predictor.accept_static:
        raise ValueError("static_dim given but this predictor rejects static features "
                         "(accept_static=False)")
    names, leaves = _flatten_params(predictor.model.state_dict())
    leaves = [leaf.detach() for leaf in _cast_float_leaves(leaves, params_dtype)]
    model, coeff_fn = predictor.model, predictor.coeff_fn
    dtype = (getattr(torch, params_dtype) if params_dtype is not None
             else getattr(model, "dtype", torch.float32))

    traced_solves = [False]   # whether the traced forward ran adaptive or Adams solves

    def forward(params, series, static=None):
        # A preparation may cast to its own model's dtype (a recurrent
        # bundle's): the inputs go in at the weights' dtype.
        inputs = map_arrays(coeff_fn(series.to(dtype)),
                            lambda t: t.to(dtype) if t.is_floating_point() else t)
        if static is not None:
            inputs = (static.to(dtype), inputs)
        with solvers.traced_stats() as traced:
            out = torch.func.functional_call(model, dict(zip(names, params)), (inputs,))
        traced_solves[0] = bool(traced)
        if not traced:
            return out
        # An adaptive or Adams solve: its (nfe, accepted, rejected), a row
        # a solve.
        return out, torch.stack([torch.stack([s["nfe"], s["accepted"], s["rejected"]])
                                 for s in traced])

    fwd = forward if static_dim is None else (
        lambda params, static, series: forward(params, series, static))
    device = predictor.device
    grid = predictor.bucket_grid(max_length)
    top = max(predictor.batch_buckets)
    programs = {}   # one per length, traced at the top bucket, for every bucket
    for _, L in grid:
        if L not in programs:
            series = (torch.zeros((top, L, channels), dtype=torch.float32,
                                  device=device), 0)
            args = [leaves]
            if static_dim is not None:
                args.append((torch.zeros((top, static_dim), dtype=torch.float32,
                                         device=device), 0))
            programs[L] = _export(fwd, args + [series], top)
    named = [(_shape_key(b, L), programs[L]) for b, L in grid]

    manifest = {
        "artifact": "predictor",
        "treedef": names,
        "batch_buckets": list(predictor.batch_buckets),
        "length_multiple": predictor.length_multiple,
        "channels": channels,
        "static_dim": static_dim,
        "max_length": (predictor.exact_length or
                       _round_up(max_length, predictor.length_multiple)),
        "rectilinear_rows": predictor.rectilinear_rows,
        "pad_forward_fill": predictor.pad_forward_fill,
        "return_sequences": bool(getattr(model, "return_sequences", False)),
        "platforms": list(platforms),
        "n_leaves": len(leaves),
    }
    if traced_solves[0]:
        manifest["solve_stats"] = True
    if predictor.exact_length is not None:
        # The loaded predictor refuses every other length, as the live one.
        manifest["exact_length"] = predictor.exact_length
    _write_artifact(path, leaves, named, manifest)
    return len(named)


class _ExportedModel(torch.nn.Module):
    """Shape-dispatching stand-in for the model: each (bucket, length)
    batch goes to its loaded module with the artifact's weights.  Over a
    mesh this rank's rows are a share of the bucket (``n_data`` of them
    make it up).  A shape outside the grid raises with the re-export
    recipe: there is no model to trace again."""

    def __init__(self, manifest, modules, flat, n_data):
        super().__init__()
        self.return_sequences = manifest["return_sequences"]
        self._manifest = manifest
        self._modules = modules
        self._flat = flat
        self._n_data = n_data

    def forward(self, inputs):
        static_dim = self._manifest["static_dim"]
        if static_dim is not None:
            if not isinstance(inputs, tuple):
                raise ValueError(f"artifact was exported with static_dim={static_dim}: "
                                 "every request must pass static features")
            static, series = inputs
        else:
            static, series = None, inputs
        key = _shape_key(series.shape[0] * self._n_data, series.shape[1])
        if key not in self._modules:
            raise ValueError(
                f"shape {tuple(series.shape)} is outside the exported grid (buckets "
                f"{self._manifest['batch_buckets']}, lengths <= "
                f"{self._manifest['max_length']}); re-export with export_predictor("
                "..., max_length=...) covering it")
        args = (series,) if static is None else (static, series)
        out = self._modules[key](self._flat, *args)
        if not self._manifest.get("solve_stats"):
            return out
        out, stats = out
        # The program's solves, counted as the live solves count theirs
        # (one read).
        nfe, accepted, rejected = np.asarray(solvers._read(stats)).reshape(-1, 3).sum(0)
        solvers._count(solves=stats.shape[0], nfe=nfe, accepted=accepted, rejected=rejected)
        return out


def load_predictor(path: str, mesh=None, *, device=None) -> Predictor:
    """A serving-ready :class:`Predictor` from an artifact written by
    :func:`export_predictor`, with no model code: the artifact's bucket
    grid and padding policy, every shape served by its loaded module.
    Requests outside the grid raise with the re-export recipe; an artifact
    of a predictor with ``exact_length`` (the manifest's key) refuses any
    other request length, as the live predictor does.

    ``device``: where to serve (the CUDA card unless ``"cpu"`` is asked
    for; with no card visible it raises).  ``mesh``: a ``parallel.mesh``
    mesh -- the weights are broadcast from its first rank and every bucket
    batch is split over its data axis, each rank running its rows through
    the bucket's module, exactly as a live ``Predictor(mesh=)``."""
    device = _mesh_device(mesh, device)
    manifest, flat, modules = _read_artifact(path, "predictor", device)
    n_data = 1
    if mesh is not None:
        flat = replicate(flat, mesh)
        n_data = data_axis_size(mesh)
    # The live model's weights are parameters, which require grad even
    # under inference_mode, and ATen's matmul picks its kernel by that flag
    # (a 3-D strided operand folds into one mm only when no operand
    # requires grad): the loaded weights carry it too, so the artifact
    # serves the live predictor's bits.
    flat = [t.requires_grad_() if t.is_floating_point() else t for t in flat]
    return Predictor(
        _ExportedModel(manifest, modules, flat, n_data),
        coeff_fn=None,   # the coefficient build is inside the modules
        batch_buckets=manifest["batch_buckets"],
        length_multiple=manifest["length_multiple"],
        rectilinear_rows=manifest["rectilinear_rows"],
        pad_forward_fill=manifest["pad_forward_fill"],
        accept_static=manifest["static_dim"] is not None,
        mesh=mesh,
        device=device,
        exact_length=manifest.get("exact_length"),
    )


# ---------------------------------------------------------------------------
# The stepper
# ---------------------------------------------------------------------------


def export_stepper(
    stepper,
    path: str,
    *,
    batch_sizes: Sequence[int],
    channels: int,
    platforms: Sequence[str] = ("cuda", "cpu"),
    params_dtype: Optional[str] = None,
    block_sizes: Sequence[int] = (),
) -> int:
    """Write an :class:`~online_neural_cdes_tpu_torch.serving.OnlineNCDEStepper`
    -- the streaming server -- for each stream count in ``batch_sizes``.
    Three modules a count: ``init`` (first observations -> state),
    ``step`` (one observation: the two rectilinear control pieces, and the
    output) and ``readout`` (state -> output); each K of ``block_sizes``
    adds ``stepblock{K}``, K observations in one call (the live
    ``step_many``), which the loaded stepper's ``step_many`` chunks a
    backlog into.  The weights are an argument of every module, as in
    :func:`export_predictor`; observations are float32 and the state is in
    the weights' dtype.  Returns the number of modules written."""
    if stepper.mesh is not None:
        raise ValueError("cannot export a mesh-sharded stepper: export the plain one and "
                         "shard at serve time with load_stepper(path, mesh=...)")
    names, leaves = _flatten_params(stepper.params)
    leaves = [leaf.detach() for leaf in _cast_float_leaves(leaves, params_dtype)]
    dtype = getattr(torch, params_dtype) if params_dtype is not None else stepper.dtype
    static_dim = None if stepper.static is None else int(stepper.static.shape[-1])
    hidden = int(stepper.model.hidden_dim)
    device = stepper.device

    def weights(params):
        return stepper._weights(dict(zip(names, params)))

    def step_mod(params, z, x_prev, x_new):
        return stepper._advance(weights(params), z, x_prev, x_new.to(dtype))

    def readout_mod(params, z):
        return stepper._readout(weights(params), z)

    def init_mod(params, x0, static=None):
        return stepper._init(weights(params), x0.to(dtype),
                             None if static is None else static.to(dtype))

    def block_mod(params, z, x_prev, xs):
        return stepper._block(weights(params), z, x_prev, xs.to(dtype))

    def zeros(*shape, dt=torch.float32, axis=0):
        return (torch.zeros(shape, dtype=dt, device=device), axis)

    # Each module traced once, at the largest stream count, for every count.
    b = max(int(n) for n in batch_sizes)
    z, state_x = zeros(b, hidden, dt=dtype), zeros(b, channels, dt=dtype)
    init_args = [leaves, zeros(b, channels)]
    if static_dim is not None:
        init_args.append(zeros(b, static_dim))
    programs = {"step": _export(step_mod, [leaves, z, state_x, zeros(b, channels)], b),
                "init": _export(init_mod, init_args, b),
                "readout": _export(readout_mod, [leaves, z], b)}
    for k in block_sizes:
        programs[f"stepblock{int(k)}"] = _export(
            block_mod, [leaves, z, state_x, zeros(int(k), b, channels, axis=1)], b)
    named = [(f"{name}_b{int(n)}", program) for n in batch_sizes
             for name, program in programs.items()]

    manifest = {
        "artifact": "stepper",
        "treedef": names,
        "batch_sizes": sorted(int(b) for b in batch_sizes),
        "block_sizes": sorted(int(k) for k in block_sizes),
        "channels": channels,
        "hidden_dim": hidden,
        "static_dim": static_dim,
        "platforms": list(platforms),
        "n_leaves": len(leaves),
    }
    _write_artifact(path, leaves, named, manifest)
    return len(named)


class _LoadedStepper:
    """Streaming server rebuilt from a stepper artifact: the live
    ``OnlineNCDEStepper``'s ``init(x0) -> state``, ``step(state, x_new) ->
    (state, y)``, ``step_many`` and ``readout(z)``, each call dispatched to
    the loaded module for its stream count.  Over a mesh the state holds
    this rank's streams and the outputs are gathered, as the live
    stepper's."""

    def __init__(self, manifest, flat, modules, static, device, mesh=None):
        self._manifest = manifest
        self._modules = modules
        self.mesh = mesh
        self.device = device
        self._n_data = 1
        if mesh is not None:
            flat = replicate(flat, mesh)
            self._n_data = data_axis_size(mesh)
        self._flat = flat
        self.static = None if static is None else self._streams(
            _to_device(static, device))

    def _streams(self, x, axis=0):
        return x if self.mesh is None else _stream_rows(x, self.mesh, axis)

    def _gathered(self, y, axis=0):
        return y if self.mesh is None else _gather_streams(y, self.mesh, axis)

    def _mod(self, name, rows):
        key = f"{name}_b{rows * self._n_data}"
        if key not in self._modules:
            raise ValueError(
                f"stream-batch size {rows * self._n_data} is outside the exported sizes "
                f"{self._manifest['batch_sizes']}; re-export with "
                "export_stepper(..., batch_sizes=...) covering it")
        return self._modules[key]

    def init(self, x0):
        with torch.inference_mode():
            x0 = self._streams(_to_device(x0, self.device))
            if self._manifest["static_dim"] is not None:
                if self.static is None:
                    raise ValueError("artifact was exported with static features: pass "
                                     "static= to load_stepper")
                z, filled = self._mod("init", x0.shape[0])(self._flat, x0, self.static)
            else:
                z, filled = self._mod("init", x0.shape[0])(self._flat, x0)
        return {"z": z, "last_obs": filled}

    def step(self, state, x_new):
        with torch.inference_mode():
            x_new = self._streams(_to_device(x_new, self.device))
            z, filled, y = self._mod("step", state["z"].shape[0])(
                self._flat, state["z"], state["last_obs"], x_new)
            y = self._gathered(y)
        return {"z": z, "last_obs": filled}, y

    def step_many(self, state, xs):
        """Catch-up through a (K, B, C) backlog, as the live ``step_many``:
        the largest exported blocks first (one call each), then single
        steps for the rest; the same per-tick arithmetic."""
        with torch.inference_mode():
            xs = _to_device(xs, self.device)
            rows = state["z"].shape[0]
            _check_backlog_layout(xs, rows * self._n_data)
            if xs.shape[0] == 0:
                # An empty block: (0, B, out).
                y = self.readout(state["z"])
                return state, y.new_zeros((0, rows * self._n_data) + tuple(y.shape[1:]))
            xs = self._streams(xs, axis=1)
            blocks = sorted(self._manifest.get("block_sizes", []), reverse=True)
            parts, k = [], 0
            while k < xs.shape[0]:
                rest = xs.shape[0] - k
                size = next((s for s in blocks if s <= rest and
                             f"stepblock{s}_b{rows * self._n_data}" in self._modules), None)
                if size is not None:
                    z, filled, ys = self._mod(f"stepblock{size}", rows)(
                        self._flat, state["z"], state["last_obs"], xs[k:k + size])
                    state = {"z": z, "last_obs": filled}
                    parts.append(self._gathered(ys, axis=1))
                    k += size
                else:
                    z, filled, y = self._mod("step", rows)(
                        self._flat, state["z"], state["last_obs"], xs[k])
                    state = {"z": z, "last_obs": filled}
                    parts.append(self._gathered(y)[None])
                    k += 1
            return state, torch.cat(parts, dim=0)

    def readout(self, z):
        with torch.inference_mode():
            return self._mod("readout", z.shape[0])(self._flat, z)

    def precompile(self) -> int:
        """Run every module (init, step and readout for each stream count,
        and each catch-up block) on zero observations, so the first real
        tick builds nothing.  Returns the number of modules run."""
        c = int(self._manifest["channels"])
        ran = 0
        for b in self._manifest["batch_sizes"]:
            if self._manifest["static_dim"] is not None and (
                    self.static is None or self.static.shape[0] * self._n_data != b):
                continue   # static binds one stream population size
            x0 = np.zeros((b, c), np.float32)
            state = self.init(x0)
            self.readout(state["z"])
            state, _ = self.step(state, x0)
            ran += 3
            for k in self._manifest.get("block_sizes", []):
                if f"stepblock{k}_b{b}" in self._modules:
                    self.step_many(state, np.zeros((int(k), b, c), np.float32))
                    ran += 1
        return ran


def load_stepper(path: str, static=None, mesh=None, *, device=None) -> _LoadedStepper:
    """A streaming stepper from an artifact written by :func:`export_stepper`,
    with no model code.  ``static`` binds the streams' static features
    (required iff the artifact was exported from a static-featured
    stepper), as the live constructor does.  ``device``: the CUDA card
    unless ``"cpu"`` is asked for (with no card visible it raises).
    ``mesh``: the weights are broadcast from its first rank and the
    streams split over its data axis, as ``OnlineNCDEStepper(mesh=)``;
    every stream count used must divide the data axis."""
    device = _mesh_device(mesh, device)
    manifest, flat, modules = _read_artifact(path, "stepper", device)
    if static is not None and manifest["static_dim"] is None:
        raise ValueError("artifact has no static head; do not pass static")
    return _LoadedStepper(manifest, flat, modules, static, device, mesh=mesh)
