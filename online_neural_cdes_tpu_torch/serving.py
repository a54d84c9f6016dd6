"""Batched and streaming inference.

PyTorch counterpart of the JAX package's ``serving.py``: ``Predictor`` (a
bucketed-batch server for ragged, NaN-holding requests) and
``OnlineNCDEStepper`` (a rectilinear NCDE advanced one observation at a
time).  Both run on the CUDA card unless ``device="cpu"`` is asked for,
and raise when neither is available.  The model carries its parameters
(an ``nn.Module``), so neither takes a separate ``params`` argument; the
model must already live on the server's device.  ``Predictor`` serves the
model's current weights; ``OnlineNCDEStepper`` serves a snapshot taken at
construction, which assigning its ``params`` replaces, as the JAX
stepper serves the ``params`` it holds.  ``predictor_from_bundle`` serves
a harness bundle at the ``params`` it is given, in a model of its own.

Work is enqueued on the current CUDA stream and read back only where a
result leaves the server (``Predictor._collect``'s ``.cpu()``), so
``predict_many`` keeps several batches in flight.  ``serving_export``
writes either server as an artifact that serves without the model code,
and ``deploy`` builds one from a trained checkpoint.

``mesh=`` (``parallel/mesh.py``) serves over a process group: every rank
builds the server on its mesh device and calls it with the same requests;
the weights are broadcast from the mesh's first rank, each bucket batch
(or stream population) is split over the data axis, each rank runs its
rows and the rows are all-gathered, so ``predict``, ``step`` and
``step_many`` return every row on every rank.  Buckets and stream counts
must divide the data axis.  A stepper's state holds this rank's streams.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from online_neural_cdes_tpu_torch.data.loader import pad_ragged
from online_neural_cdes_tpu_torch.ops import solvers as _solvers
from online_neural_cdes_tpu_torch.ops.kernels import fused_matmul_field
from online_neural_cdes_tpu_torch.parallel.mesh import (
    all_gather_rows, check_mesh, data_axis_size, data_parallel_sharding, data_reductions,
    replicate, shard_batch,
)
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.params import linear_apply
from online_neural_cdes_tpu_torch.utils.profiling import span, unit
from online_neural_cdes_tpu_torch.utils.tree import map_arrays

__all__ = ["OnlineNCDEStepper", "Predictor", "predictor_from_bundle"]


def _tree(state: dict, prefix: str):
    """The entries of a state dict under ``prefix`` as the JAX-layout tree
    the model's modules hold (dicts, and lists where every key is an
    index), or None when there are none."""
    root: dict = {}
    for key, value in state.items():
        if key.startswith(prefix):
            node, parts = root, key[len(prefix):].split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value

    def listed(node):
        if not isinstance(node, dict):
            return node
        node = {k: listed(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listed(root) if root else None


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _mesh_device(mesh, device) -> torch.device:
    """The server's device: this rank's mesh device with a mesh (``device``,
    when given, must be it), else ``device``."""
    if mesh is None:
        return resolve_device(device)
    check_mesh(mesh)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device={device!r}: this rank's mesh device is {mesh.device}")
    return mesh.device


def _stream_rows(x: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """This rank's streams of a per-stream tensor (its stream axis
    ``axis`` split over the data axis), failing with the fix if it does
    not divide."""
    n_data = data_axis_size(mesh)
    if x.shape[axis] % n_data:
        raise ValueError(
            f"stream batch {x.shape[axis]} does not divide the mesh's "
            f"{n_data}-device data axis; pad the stream population to a "
            "multiple of it"
        )
    return shard_batch(x.movedim(axis, 0), mesh).movedim(0, axis)


def _gather_streams(x: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    return all_gather_rows(x.movedim(axis, 0), mesh).movedim(0, axis)


def _check_model_device(model: torch.nn.Module, device: torch.device):
    for name, p in model.named_parameters():
        if p.device != device:
            raise ValueError(
                f"model parameter {name} lives on {p.device}, the server on "
                f"{device}: build the model with device={str(device)!r}"
            )


def _to_device(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Host array or tensor -> tensor on ``device``.  A host array goes
    through pinned memory with a non-blocking copy, so the copy is queued
    on the stream instead of waiting for the work already queued there."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.tensor(np.asarray(x), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _check_backlog_layout(xs, n_streams: int):
    """A backlog must be time-major (K, B, C): when B == K a swapped (B, K,
    C) array is shape-consistent and would silently scan streams as time."""
    if xs.dim() != 3 or xs.shape[1] != n_streams:
        raise ValueError(
            f"step_many expects a time-major (K, B={n_streams}, C) backlog; "
            f"got shape {tuple(xs.shape)} -- swap the first two axes of a "
            "(B, K, C) array first"
        )


class Predictor:
    """Bucketed-batch server for a model.

    Args:
        model: an ``nn.Module`` whose ``forward(inputs)`` maps model inputs
            to outputs (e.g. ``NeuralCDE``), already on ``device``.
        coeff_fn: raw series tensor (B, L, C) -> model inputs (e.g. a
            coefficient function); identity if requests are already inputs.
        batch_buckets / length_multiple: the bucket shape grid; requests
            pad up to the nearest bucket.
        rectilinear_rows: set True when the model emits *unfiltered*
            rectilinear sequence rows (2L-1 per length-L request); outputs
            are mapped back to one row per observation time.
        mesh: a ``parallel.mesh.Mesh`` with a ``"data"`` axis: each bucket
            batch shards over it and the rows are gathered (the module
            docstring); every batch bucket must divide the data-axis size.
        pad_forward_fill: the length pad repeats each request's final row
            (True: for interpolated controls dX = 0 there, freezing the CDE
            state) or is NaN (False).
        accept_static: whether requests may carry static features.
        device: where to serve (the CUDA card unless "cpu" is asked for;
            this rank's mesh device with a mesh).
        exact_length: serve requests of exactly this many observations and
            refuse any other (a coefficient build that a length pad would
            change: the natural cubic and Hermite splines); the one length
            bucket is then this length, whatever ``length_multiple`` says.
    """

    def __init__(
        self,
        model,
        coeff_fn=None,
        batch_buckets: Sequence[int] = (1, 8, 64, 256),
        length_multiple: int = 16,
        rectilinear_rows: bool = False,
        mesh=None,
        pad_forward_fill: bool = True,
        accept_static: bool = True,
        *,
        device=None,
        exact_length: Optional[int] = None,
    ):
        self.device = _mesh_device(mesh, device)
        _check_model_device(model, self.device)
        self.model = model
        self.mesh = mesh
        self.coeff_fn = coeff_fn or (lambda x: x)
        self.batch_buckets = sorted(batch_buckets)
        if mesh is not None:
            n_data = data_axis_size(mesh)
            bad = [b for b in self.batch_buckets if b % n_data]
            if bad:
                raise ValueError(
                    f"batch_buckets {bad} do not divide the mesh's "
                    f"{n_data}-device data axis; every bucket must shard "
                    "evenly over it"
                )
            replicate(model, mesh)
        self.exact_length = exact_length
        self.length_multiple = length_multiple if exact_length is None else exact_length
        self.rectilinear_rows = rectilinear_rows
        self.pad_forward_fill = pad_forward_fill
        self.accept_static = accept_static

    def _bucket_batch(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return _round_up(n, self.batch_buckets[-1])

    def bucket_grid(self, max_length: int):
        """Every (batch bucket, padded length) shape :meth:`predict` can
        dispatch for requests up to ``max_length`` (which pads UP to the
        next multiple, so the top bucket is included; with ``exact_length``
        that length alone)."""
        if self.exact_length is not None:
            return [(b, self.exact_length) for b in self.batch_buckets]
        top = _round_up(max_length, self.length_multiple)
        lengths = range(self.length_multiple, top + 1, self.length_multiple)
        return [(b, L) for b in self.batch_buckets for L in lengths]

    def precompile(self, channels: int, max_length: int,
                   static_dim: Optional[int] = None) -> int:
        """Serve zero requests at every bucket shape: builds the kernels at
        their first launch and fills the allocator's caches, so the first
        real request pays neither.  Returns the number of shapes warmed."""
        warmed = 0
        for b, length in self.bucket_grid(max_length):
            series = [np.zeros((length, channels), np.float32)] * b
            static = np.zeros((b, static_dim), np.float32) if static_dim else None
            self.predict(series, static=static)
            warmed += 1
        return warmed

    def _dispatch(self, series, static: Optional[np.ndarray]):
        """Pack one <=top-bucket batch and enqueue the forward.  Returns
        (device output, request lengths) without synchronising."""
        if static is not None and not self.accept_static:
            raise ValueError(
                "this predictor's model does not consume static features -- "
                "call predict without static"
            )
        lengths = [len(s) for s in series]
        if self.exact_length is not None and set(lengths) != {self.exact_length}:
            raise ValueError(
                f"this predictor serves requests of exactly {self.exact_length} "
                f"observations (its coefficient build is not inert under a length "
                f"pad); got lengths {sorted(set(lengths))}")
        n = len(series)
        nb = self._bucket_batch(n)

        padded = pad_ragged(
            [np.asarray(s, np.float32) for s in series],
            bucket_multiple=self.length_multiple,
            forward_fill=self.pad_forward_fill,
        )
        if nb > n:  # pad batch with repeats of the first request
            padded = np.concatenate([padded, np.repeat(padded[:1], nb - n, axis=0)])
            if static is not None:
                static = np.concatenate(
                    [static, np.repeat(static[:1], nb - n, axis=0)], axis=0
                )
        # The requests go in at the model's dtype (a bf16 model serves in
        # bf16, as the stepper does).
        dtype = getattr(self.model, "dtype", torch.float32)
        if self.mesh is not None:   # this rank's rows of the bucket batch
            rows = data_parallel_sharding(self.mesh)[0]
            padded = rows.place(padded)
            static = None if static is None else rows.place(np.asarray(static, np.float32))
        with torch.inference_mode():
            inputs = self.coeff_fn(_to_device(padded, self.device, dtype))
            if static is not None:
                inputs = (_to_device(static, self.device, dtype), inputs)
            with data_reductions(self.mesh):   # one controller over the bucket
                out = self.model(inputs)
            if self.mesh is not None:
                out = _gather_streams(out, self.mesh)
            return out, lengths

    def _collect(self, device_out, lengths) -> List[np.ndarray]:
        """Copy a dispatched batch to the host (the sync point) and strip
        the padding per request."""
        if device_out.dtype in (torch.bfloat16, torch.float16):
            device_out = device_out.float()  # numpy holds no bf16
        out = device_out.cpu().numpy()
        results = []
        for i, L in enumerate(lengths):
            o = out[i]
            if o.ndim >= 1 and getattr(self.model, "return_sequences", False):
                if self.rectilinear_rows:
                    # Unfiltered rectilinear rows alternate time-advance /
                    # value-update; every 2nd row is an observation time.
                    o = o[::2]
                results.append(o[:L])
            else:
                results.append(o)
        return results

    def _chunks(self, series, static: Optional[np.ndarray]):
        """Normalise one request batch (array -> list) and split it into
        <=top-bucket chunks."""
        if isinstance(series, np.ndarray) and series.ndim == 3:
            series = [s for s in series]
        if not len(series):
            raise ValueError("empty request batch")
        top = self.batch_buckets[-1]
        for start in range(0, len(series), top):
            st = None if static is None else static[start:start + top]
            yield series[start:start + top], st

    def predict(self, series, static: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """series: list of (L_i, C) raw observations (NaN = missing) or an
        (N, L, C) array.  Returns per-request outputs with padding removed
        (sequence outputs truncated to each request's own length).
        Requests beyond the biggest batch bucket are chunked through it."""
        out: List[np.ndarray] = []
        for chunk, st in self._chunks(series, static):
            out.extend(self._collect(*self._dispatch(chunk, st)))
        return out

    def predict_many(
        self,
        batches,
        statics: Optional[Sequence[Optional[np.ndarray]]] = None,
        in_flight: int = 4,
    ) -> List[List[np.ndarray]]:
        """Throughput mode: serve a stream of request batches keeping up to
        ``in_flight`` dispatched batches ahead of the sync point, so each
        batch's host packing and copy overlap earlier batches' device work.
        Outputs equal :meth:`predict` per batch, in order."""
        batches = list(batches)
        statics_list = list(statics) if statics is not None else [None] * len(batches)
        if len(statics_list) != len(batches):
            raise ValueError("statics must match batches in length")

        units = []  # (batch index, series chunk, static chunk)
        for bi, (series, static) in enumerate(zip(batches, statics_list)):
            for chunk, st in self._chunks(series, static):
                units.append((bi, chunk, st))

        results: List[List[np.ndarray]] = [[] for _ in batches]
        pending: deque = deque()

        def drain_one():
            bi, dev, lengths = pending.popleft()
            results[bi].extend(self._collect(dev, lengths))

        for bi, chunk, st in units:
            dev, lengths = self._dispatch(chunk, st)
            pending.append((bi, dev, lengths))
            if len(pending) >= max(int(in_flight), 1):
                drain_one()
        while pending:
            drain_one()
        return results


def predictor_from_bundle(bundle, params, **kw) -> Predictor:
    """Serve any harness ``ModelBundle`` (``training/harness.py::setup_model``)
    at the weights ``params`` (a ``state_dict``): the whole model zoo,
    the recurrent baselines included, whose inputs are prepared tensors
    (GRU-D's masks and deltas, the gru-intensity channels) rather than
    interpolation coefficients.

    The predictor serves a model of its own: a fresh one of the bundle's
    configuration with ``params`` copied in, so neither a later update of
    the bundle's model in place (a trainer's step) nor one of ``params``
    reaches it, as the JAX predictor serves the tree it was given.  The
    bundle's ``prepare_batch`` becomes ``coeff_fn`` (pass ``coeff_fn=`` for
    NCDE bundles, whose preparation only moves precomputed coefficients),
    and it serves on the bundle's device unless ``device=`` says otherwise.
    Recurrent bundles pad with NaN rows (``pad_forward_fill=False``): their
    preparation derives observation masks from NaN, so forward-fill padding
    would fabricate observations, while NaN pad rows stay causally isolated
    from every request's own (earlier) rows.

    A recurrent ONE-SHOT bundle is refused: its output is read after the
    pad rows, which a recurrent cell keeps updating even on padding
    (unlike the NCDE, whose pad intervals have dX = 0).  Build the bundle
    with ``return_sequences=True`` and read each request's final row
    (``outs[i][-1]``), the one-shot output for the same weights.
    """
    recurrent = bundle.model_string not in (
        "ncde", "ncde-stacked", "ncde-attention"
    )
    return_sequences = bool(getattr(bundle.model, "return_sequences", False))
    if recurrent and not return_sequences:
        raise ValueError(
            f"Cannot serve a one-shot {bundle.model_string!r} bundle: a "
            "recurrent cell keeps mutating state across the length-pad "
            "rows, so the final-state output would include padding. Build "
            "the bundle with return_sequences=True and read each "
            "request's final row (outs[i][-1]) instead."
        )
    model = bundle.make_model(torch.Generator().manual_seed(0))
    model.load_state_dict(params)
    kw.setdefault("coeff_fn", bundle.prepare_batch)
    kw.setdefault("pad_forward_fill", not recurrent)
    # A recurrent bundle's preparation is temporal-only (it drops the
    # static half of (static, temporal) training batches), so a static
    # request is refused loudly rather than handed to the model as a tuple.
    kw.setdefault("accept_static", not recurrent)
    kw.setdefault("device", bundle.device)
    return Predictor(model, **kw)


class OnlineNCDEStepper:
    """Streaming inference for a **rectilinear** NeuralCDE: advance the
    hidden state one observation at a time.

    Each new observation appends two control pieces -- a time advance (only
    the time channel moves) and a value update (time held) -- so the state
    advances without re-solving the history, and after ``k`` steps it
    equals the offline model's row ``k``.  The original field goes through
    the fused op: the value update with all I = C channels, the time
    advance with the time channel's head slice (I = 1), the same arithmetic
    as the full contraction since the other channels' dX are exact zeros.
    Any other matmul field is the plain field matrix contracted with the
    piece's dX (the time advance's zero in every other channel), as the
    JAX stepper does.

    Missing values (NaN) hold their last observed value; NaNs in the first
    observation are zeroed.

    Usage::

        stepper = OnlineNCDEStepper(model)
        state = stepper.init(x0)                # (B, C) first observations
        state, y = stepper.step(state, x_new)   # per new (B, C) row
    """

    def __init__(self, model, static=None, mesh=None, *, device=None):
        if model.interpolation != "rectilinear":
            raise ValueError(
                "OnlineNCDEStepper requires interpolation='rectilinear' "
                f"(got {model.interpolation!r}); other schemes are non-causal "
                "or need lookahead."
            )
        if model.solver not in _solvers.FIXED_METHODS:
            raise ValueError("OnlineNCDEStepper requires a fixed-grid solver.")
        if model.vector_field_type != "matmul":
            raise ValueError(
                "OnlineNCDEStepper supports vector_field_type='matmul' only "
                f"(got {model.vector_field_type!r})."
            )
        if model.static_dim is not None and static is None:
            raise ValueError("model has static_dim: pass static features.")
        self.device = _mesh_device(mesh, device)
        _check_model_device(model, self.device)
        self.model = model
        self.mesh = mesh
        self.dtype = model.dtype
        self.static = None if static is None else self._streams(self._tensor(static))
        self._rk_step = _solvers.tree_fixed_step(model.solver)
        self.params = model.state_dict()

    @property
    def params(self) -> dict:
        """The weights the stepper serves, keyed as ``model.state_dict()``:
        detached clones taken at construction, so a later in-place update
        of the model (an optimizer step) does not reach a running stream.
        Assign a state dict to serve other weights, as the JAX stepper's
        ``params`` is reassigned; the field is packed again then."""
        return self._params

    @params.setter
    def params(self, state: dict):
        want = self.model.state_dict()
        if set(state) != set(want):
            raise ValueError(
                f"params keys {sorted(set(state) ^ set(want))} do not match the "
                "model's state_dict")
        for key, ref in want.items():
            if tuple(state[key].shape) != tuple(ref.shape):
                raise ValueError(f"params[{key!r}] has shape {tuple(state[key].shape)}, "
                                 f"the model's {tuple(ref.shape)}")
        with torch.no_grad():
            snapshot = {key: torch.as_tensor(state[key]).detach()
                        .to(device=self.device, dtype=ref.dtype).clone()
                        for key, ref in want.items()}
            if self.mesh is not None:   # the mesh's first rank's weights on every rank
                snapshot = replicate(snapshot, self.mesh)
            self._w = self._weights(snapshot)
        self._params = snapshot

    def _weights(self, state: dict) -> dict:
        """What a tick reads from the weights ``state`` (keyed as
        ``model.state_dict()``): the field's, ``initial`` and ``final``
        trees, and the field packed for the fused op (None for a plain
        field).  The live stepper packs its snapshot once; an exported
        stepper module (``serving_export``) packs its weights argument."""
        field = _tree(state, "field.")
        return {"field": field, "initial": _tree(state, "initial."),
                "final": _tree(state, "final."),
                "packed": (self.model.packed_field(field)
                           if self.model.uses_fused_field else None)}

    def _tensor(self, x) -> torch.Tensor:
        return _to_device(x, self.device, self.dtype)

    def _streams(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's streams of ``x`` over a mesh, else ``x``."""
        return x if self.mesh is None else _stream_rows(x, self.mesh, axis)

    def _gathered(self, y: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's streams of ``y`` over a mesh, else ``y``."""
        return y if self.mesh is None else _gather_streams(y, self.mesh, axis)

    def _piece(self, field, z, dx):
        """One solver step over one unit-length control piece of the field
        ``field(z, dx) -> dz/dt``."""
        return self._rk_step(lambda tt, zz: field(zz, dx), 0.0, 1.0, z)

    def _advance(self, w, z, x_prev, x_new):
        """One tick at the weights ``w`` (:meth:`_weights`): (z, the filled
        observation, the output)."""
        ch = self.model.rectilinear_time_channel
        filled = torch.where(torch.isnan(x_new), x_prev, x_new)
        dx_vals = filled - x_prev
        dx_vals.select(-1, ch).zero_()
        packed, H = w["packed"], self.model.hidden_dim
        if packed is None:
            field, params = self.model.field, w["field"]
            dx_time = torch.zeros_like(filled)
            dx_time[..., ch] = filled[..., ch] - x_prev[..., ch]

            def time_field(zz, dx):
                return torch.einsum("...hi,...i->...h", field.apply(params, 0.0, zz), dx)

            value_field = time_field
        else:
            dx_time = (filled[..., ch] - x_prev[..., ch]).unsqueeze(-1)

            def time_field(zz, dx):
                return fused_matmul_field(packed["trunk"], packed["head_w_time"],
                                          packed["head_b_time"], zz, dx, H, 1)

            def value_field(zz, dx):
                return fused_matmul_field(packed["trunk"], packed["head_w"],
                                          packed["head_b"], zz, dx, H, dx.shape[-1])

        z = self._piece(time_field, z, dx_time)       # time-advance piece
        z = self._piece(value_field, z, dx_vals)      # value-update piece
        return z, filled, self._readout(w, z)

    def _block(self, w, z, x_prev, xs):
        """K ticks over the (K, B, C) observations ``xs``: (z, the last
        filled observation, the (K, B, out) outputs).  While
        ``torch.export`` traces, the same tick under ``scan``."""
        if torch.compiler.is_exporting():
            from torch._higher_order_ops.scan import scan

            w = map_arrays(w, torch.clone)   # a scan's inputs may not alias

            def tick(carry, x_new):
                zz, prev, y = self._advance(w, *carry, x_new)
                return (zz, prev), (y.clone() if y is zz else y)

            (z, x_prev), ys = scan(tick, (z, x_prev), xs)
            return z, x_prev, ys
        ys = []
        for x_new in xs:
            z, x_prev, y = self._advance(w, z, x_prev, x_new)
            ys.append(y)
        return z, x_prev, torch.stack(ys)

    def _init(self, w, x0, static):
        """(h0, the first observation with NaN -> 0) at the weights ``w``."""
        model = self.model
        x0 = torch.where(torch.isnan(x0), torch.zeros_like(x0), x0)
        if static is None:
            if model.use_initial:
                z = linear_apply(w["initial"], x0)
            else:
                z = torch.zeros(x0.shape[:-1] + (model.hidden_dim,),
                                dtype=x0.dtype, device=x0.device)
        elif model.use_initial:
            z = linear_apply(w["initial"], torch.cat([static, x0], dim=-1))
        else:
            z = linear_apply(w["initial"], static)
        return z, x0

    def _readout(self, w, z):
        return linear_apply(w["final"], z) if self.model.apply_final_linear else z

    def init(self, x0):
        """State from the first (B, C) observations (NaN -> 0); mirrors the
        offline model's h0, including the static-only head when
        use_initial=False."""
        with torch.inference_mode():
            z, x0 = self._init(self._w, self._streams(self._tensor(x0)), self.static)
        return {"z": z, "last_obs": x0}

    def step(self, state: dict, x_new):
        """Advance by one observation; returns (new_state, outputs) where
        outputs match the offline model's per-observation rows."""
        with unit("oncde.serve.step"), torch.inference_mode():
            with span("oncde.serve.upload"):
                x_new = self._tensor(x_new)
            z, filled, y = self._advance(self._w, state["z"], state["last_obs"],
                                         self._streams(x_new))
            y = self._gathered(y)
        return {"z": z, "last_obs": filled}, y

    def step_many(self, state: dict, xs):
        """Catch-up/replay: advance through a block of K observations ``xs``
        of shape (K, B, C).  Returns ``(new_state, ys)`` with ``ys[k]`` equal
        to :meth:`step`'s output at observation k (the same arithmetic)."""
        with torch.inference_mode():
            xs = self._tensor(xs)
            n_data = 1 if self.mesh is None else self.mesh.axis_size("data")
            _check_backlog_layout(xs, state["z"].shape[0] * n_data)
            z, prev, ys = self._block(self._w, state["z"], state["last_obs"],
                                      self._streams(xs, axis=1))
            return {"z": z, "last_obs": prev}, self._gathered(ys, axis=1)

    def readout(self, z: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._readout(self._w, z)

    def precompile(self, n_streams: int, block_sizes=()) -> int:
        """Run init, one tick and each catch-up block on zero observations:
        builds the kernels and fills the allocator's caches before the
        first real stream.  Returns the number of programs warmed."""
        n_data = 1 if self.mesh is None else self.mesh.axis_size("data")
        if self.model.static_dim is not None and (
            self.static is None or self.static.shape[0] * n_data != n_streams
        ):
            raise ValueError(
                f"precompile(n_streams={n_streams}): static features bind "
                "one stream population "
                f"(shape {None if self.static is None else tuple(self.static.shape)})"
                " -- n_streams must match it"
            )
        c = int(self.model.input_dim)
        x0 = np.zeros((n_streams, c), np.float32)
        state = self.init(x0)
        state, _ = self.step(state, x0)
        warmed = 2
        for k in block_sizes:
            self.step_many(state, np.zeros((int(k), n_streams, c), np.float32))
            warmed += 1
        return warmed
