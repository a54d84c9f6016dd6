"""Batched and streaming inference.

PyTorch counterpart of the JAX package's ``serving.py``: ``Predictor`` (a
bucketed-batch server for ragged, NaN-holding requests) and
``OnlineNCDEStepper`` (a rectilinear NCDE advanced one observation at a
time).  Both run on the CUDA card unless ``device="cpu"`` is asked for,
and raise when neither is available.  The model carries its parameters
(an ``nn.Module``), so neither takes a separate ``params`` argument; the
model must already live on the server's device.

Work is enqueued on the current CUDA stream and read back only where a
result leaves the server (``Predictor._collect``'s ``.cpu()``), so
``predict_many`` keeps several batches in flight.  ``mesh=``,
``predictor_from_bundle`` and the export/deploy surface come with later
slices (ROADMAP items 18 and 19).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from online_neural_cdes_tpu_torch.data.loader import pad_ragged
from online_neural_cdes_tpu_torch.ops import solvers as _solvers
from online_neural_cdes_tpu_torch.ops.kernels import fused_matmul_field
from online_neural_cdes_tpu_torch.utils.device import resolve_device
from online_neural_cdes_tpu_torch.utils.params import linear_apply

__all__ = ["OnlineNCDEStepper", "Predictor", "predictor_from_bundle"]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _no_mesh(mesh, who: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{who}(mesh=...) is not ported yet (ROADMAP item 18: parallel/)"
        )


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
        pad_forward_fill: the length pad repeats each request's final row
            (True: for interpolated controls dX = 0 there, freezing the CDE
            state) or is NaN (False).
        accept_static: whether requests may carry static features.
        device: where to serve (the CUDA card unless "cpu" is asked for).
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
    ):
        _no_mesh(mesh, "Predictor")
        self.device = resolve_device(device)
        _check_model_device(model, self.device)
        self.model = model
        self.coeff_fn = coeff_fn or (lambda x: x)
        self.batch_buckets = sorted(batch_buckets)
        self.length_multiple = length_multiple
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
        next multiple, so the top bucket is included)."""
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
        with torch.inference_mode():
            inputs = self.coeff_fn(_to_device(padded, self.device, dtype))
            if static is not None:
                inputs = (_to_device(static, self.device, dtype), inputs)
            return self.model(inputs), lengths

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


def predictor_from_bundle(bundle, params, **kw):
    raise NotImplementedError(
        "predictor_from_bundle is not ported yet (ROADMAP item 19: the rest "
        "of serving, with the harness's model bundles)"
    )


class OnlineNCDEStepper:
    """Streaming inference for a **rectilinear** NeuralCDE: advance the
    hidden state one observation at a time.

    Each new observation appends two control pieces -- a time advance (only
    the time channel moves) and a value update (time held) -- so the state
    advances without re-solving the history, and after ``k`` steps it
    equals the offline model's row ``k``.  Both pieces go through the fused
    field: the value update with all I = C channels, the time advance with
    the time channel's head slice (I = 1), the same arithmetic as the full
    contraction since the other channels' dX are exact zeros.

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
        _no_mesh(mesh, "OnlineNCDEStepper")
        self.device = resolve_device(device)
        _check_model_device(model, self.device)
        self.model = model
        self.dtype = model.dtype
        self.static = None if static is None else self._tensor(static)
        self._rk_step = _solvers.tree_fixed_step(model.solver)
        # Packed once: the stepper serves the weights the model holds now.
        with torch.inference_mode():
            self._packed = model.packed_field()

    def _tensor(self, x) -> torch.Tensor:
        return _to_device(x, self.device, self.dtype)

    def _piece(self, trunk, head_w, head_b, z, dx):
        """One solver step over one unit-length control piece."""
        H, I = self.model.hidden_dim, dx.shape[-1]

        def f(tt, zz):
            return fused_matmul_field(trunk, head_w, head_b, zz, dx, H, I)

        return self._rk_step(f, 0.0, 1.0, z)

    def _advance(self, z, x_prev, x_new):
        packed = self._packed
        ch = self.model.rectilinear_time_channel
        filled = torch.where(torch.isnan(x_new), x_prev, x_new)
        dx_time = (filled[..., ch] - x_prev[..., ch]).unsqueeze(-1)
        dx_vals = filled - x_prev
        dx_vals[..., ch] = 0.0
        trunk = packed["trunk"]
        z = self._piece(trunk, packed["head_w_time"], packed["head_b_time"],
                        z, dx_time)                   # time-advance piece
        z = self._piece(trunk, packed["head_w"], packed["head_b"],
                        z, dx_vals)                   # value-update piece
        return z, filled, self.readout(z)

    def init(self, x0):
        """State from the first (B, C) observations (NaN -> 0); mirrors the
        offline model's h0, including the static-only head when
        use_initial=False."""
        model = self.model
        with torch.inference_mode():
            x0 = self._tensor(x0)
            x0 = torch.where(torch.isnan(x0), torch.zeros_like(x0), x0)
            if self.static is None:
                if model.use_initial:
                    z = linear_apply(model.initial, x0)
                else:
                    z = torch.zeros(x0.shape[:-1] + (model.hidden_dim,),
                                    dtype=x0.dtype, device=x0.device)
            elif model.use_initial:
                z = linear_apply(model.initial, torch.cat([self.static, x0], dim=-1))
            else:
                z = linear_apply(model.initial, self.static)
        return {"z": z, "last_obs": x0}

    def step(self, state: dict, x_new):
        """Advance by one observation; returns (new_state, outputs) where
        outputs match the offline model's per-observation rows."""
        with torch.inference_mode():
            z, filled, y = self._advance(state["z"], state["last_obs"],
                                         self._tensor(x_new))
        return {"z": z, "last_obs": filled}, y

    def step_many(self, state: dict, xs):
        """Catch-up/replay: advance through a block of K observations ``xs``
        of shape (K, B, C).  Returns ``(new_state, ys)`` with ``ys[k]`` equal
        to :meth:`step`'s output at observation k (the same arithmetic)."""
        with torch.inference_mode():
            xs = self._tensor(xs)
            _check_backlog_layout(xs, state["z"].shape[0])
            z, prev = state["z"], state["last_obs"]
            ys = []
            for x_new in xs:
                z, prev, y = self._advance(z, prev, x_new)
                ys.append(y)
            return {"z": z, "last_obs": prev}, torch.stack(ys)

    def readout(self, z: torch.Tensor) -> torch.Tensor:
        if not self.model.apply_final_linear:
            return z
        with torch.inference_mode():
            return linear_apply(self.model.final, z)

    def precompile(self, n_streams: int, block_sizes=()) -> int:
        """Run init, one tick and each catch-up block on zero observations:
        builds the kernels and fills the allocator's caches before the
        first real stream.  Returns the number of programs warmed."""
        if self.model.static_dim is not None and (
            self.static is None or self.static.shape[0] != n_streams
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
