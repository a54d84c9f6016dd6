"""Profiling and timing utilities.

PyTorch counterpart of the JAX package's ``utils/profiling.py``: a device
sync, a host-clock timer that ends on that sync, a profiler trace, the
peak device memory and the NFE rate.  The trace is ``torch.profiler``'s
Chrome/Perfetto JSON, with the card's kernels when a card is visible.

Spans name the port's layers on the host.  The training step is the unit
``oncde.train.step``; inside it ``oncde.train.backward`` (the loss's
backward), ``oncde.train.optimizer`` (``zero_grad``, and the learning
rates with Adam's update), ``oncde.model.forward``, ``oncde.spline.setup``
(the spline and h0), ``oncde.cdeint.scan`` (the piece scan of the interval
adjoint) and ``oncde.cdeint.adjoint`` (its reverse solve, on autograd's
device thread on a card).  A stepper's tick is the unit
``oncde.serve.step``, with ``oncde.serve.upload`` around the copy of its
observations to the device.  No span opens inside a loop over intervals,
stages or field calls.  Off, the default, a span costs one flag check;
:func:`collect_spans` records them, on the clock ``torch.profiler`` stamps
its events with, and :func:`trace` shows them by name in its trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from typing import NamedTuple, Optional

import torch

from online_neural_cdes_tpu_torch.utils.tree import flatten

__all__ = ["device_sync", "DeviceTimer", "trace", "device_memory_mb", "nfe_per_second",
           "Span", "span", "unit", "collect_spans"]


def device_sync(value) -> None:
    """Wait for the device of ``value``'s first tensor leaf (a nested
    dict / list / tuple) to finish its queued work.  A CPU tensor needs no
    sync."""
    leaves, _ = flatten(value)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class DeviceTimer:
    """with DeviceTimer() as t: out = step(...); t.sync(out)
    -> t.elapsed seconds of host time up to the device's completion of
    ``out``."""

    def __enter__(self):
        self._start = time.perf_counter()
        self.elapsed = None
        return self

    def sync(self, value):
        device_sync(value)
        self.elapsed = time.perf_counter() - self._start

    def __exit__(self, *exc):
        if self.elapsed is None:
            self.elapsed = time.perf_counter() - self._start
        return False


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block (host ops with the
    port's spans as ranges of their own name, and the card's kernels when a
    card is visible) and write it as Chrome/Perfetto JSON to
    ``log_dir/trace-<pid>-<ns>.json``.  ``log_dir`` defaults to
    ``torch-trace`` under the temporary directory.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, _spans(mirror=True):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def device_memory_mb(device=None) -> Optional[float]:
    """Peak device memory allocated by tensors, in MiB
    (``torch.cuda.max_memory_allocated``); None for a CPU device."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def nfe_per_second(nfe: int, seconds: float) -> float:
    """The paper's efficiency metric rate-form (BASELINE.json)."""
    return float(nfe) / max(seconds, 1e-12)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class Span(NamedTuple):
    """One span as :func:`collect_spans` records it.  ``unit_id`` and
    ``parent`` are indices into the record list: the unit's own record and
    the enclosing span's (None outside any unit, and for a root).  The
    parent is the innermost span open on the same thread, or on a thread
    with none open (autograd's device thread), the innermost one open on
    the unit's thread.  Times are ``time.time_ns()``, the clock of
    ``torch.profiler``'s events; ``end_ns`` is None while the span is
    open."""

    name: str
    unit_id: Optional[int]
    parent: Optional[int]
    thread_id: int
    start_ns: int
    end_ns: Optional[int]


_NO_SPAN = contextlib.nullcontext()  # what span() and unit() return while nothing records
_on = False                  # a collect_spans() or trace() block is open
_records = None              # collect_spans()'s list
_mirror = False              # trace(): each span is also a profiler range
_lock = threading.Lock()
_threads = threading.local()  # .stack: the indices of this thread's open spans
_unit_stack = None           # the open unit's thread's .stack


def _stack() -> list:
    stack = getattr(_threads, "stack", None)
    if stack is None:
        stack = _threads.stack = []
    return stack


class _Span:
    __slots__ = ("name", "is_unit", "records", "index", "range", "outer_unit")

    def __init__(self, name: str, is_unit: bool):
        self.name, self.is_unit = name, is_unit
        self.records = self.range = None

    def __enter__(self):
        global _unit_stack
        if _mirror:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        records = self.records = _records
        if records is not None:
            stack = _stack()
            outer = stack or _unit_stack
            parent = outer[-1] if outer else None
            with _lock:
                self.index = len(records)
                unit_id = (self.index if self.is_unit else
                           None if parent is None else records[parent].unit_id)
                records.append(Span(self.name, unit_id, parent, threading.get_ident(),
                                    time.time_ns(), None))
            stack.append(self.index)
            if self.is_unit:
                self.outer_unit, _unit_stack = _unit_stack, stack
        return self

    def __exit__(self, *exc):
        global _unit_stack
        records = self.records
        if records is not None:
            end = time.time_ns()
            records[self.index] = records[self.index]._replace(end_ns=end)
            _stack().pop()
            if self.is_unit:
                _unit_stack = self.outer_unit
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """``with span("oncde.<layer>.<part>"):`` -- a span of the port's
    layers; returns a shared no-op unless :func:`collect_spans` or
    :func:`trace` is open."""
    if not _on:
        return _NO_SPAN
    return _Span(name, False)


def unit(name: str):
    """The root span of one unit of work (a training step, a tick): every
    span opened inside it, on any thread, carries its ``unit_id``."""
    if not _on:
        return _NO_SPAN
    return _Span(name, True)


@contextlib.contextmanager
def _spans(records=None, mirror=False):
    global _on, _records, _mirror
    saved = _on, _records, _mirror
    _records = records if records is not None else _records
    _mirror = mirror or _mirror
    _on = True
    try:
        yield records
    finally:
        _on, _records, _mirror = saved


def collect_spans():
    """``with collect_spans() as spans:`` -- records every span opened in
    the block, on any thread, as :class:`Span` s appended to ``spans`` in
    the order they open."""
    return _spans(records=[])
