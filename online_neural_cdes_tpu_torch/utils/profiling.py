"""Profiling and timing utilities.

PyTorch counterpart of the JAX package's ``utils/profiling.py``: a device
sync, a host-clock timer that ends on that sync, a profiler trace, the
peak device memory and the NFE rate.  The trace is ``torch.profiler``'s
Chrome/Perfetto JSON, with the card's kernels when a card is visible.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch

from online_neural_cdes_tpu_torch.utils.tree import flatten

__all__ = ["device_sync", "DeviceTimer", "trace", "device_memory_mb", "nfe_per_second"]


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
    """Capture a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels when a card is visible) and write it as Chrome/Perfetto
    JSON to ``log_dir/trace-<pid>-<ns>.json``.  ``log_dir`` defaults to
    ``torch-trace`` under the temporary directory.  Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
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
