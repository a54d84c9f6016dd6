"""Device traces of a few steady units (training steps or ticks) under
``torch.profiler``, and what the per-layer metrics read from them.

Two segments are traced after the measured window:

- ``steady``: ``trace_units`` units with the device's activity alone, so
  the host runs at its own pace: device time by kernel, the busy time
  (the union of the device's intervals), the kernels a unit and the wall
  time;
- ``detailed``: one unit with the host's ops and their shapes too, which
  ties each call of the port's two field kernels to its shape: the k-th
  forward call on the device to the k-th ``oncde::fused_field_forward``
  op on the host (one stream, so the same order), and each backward call
  to the forward call just before it, the interval adjoint's reverse stage
  evaluating the field and then its VJP at the same (B, I).  Its host ops
  also name the device's idle gaps.

A call of ``csrc/fused_field.cu`` runs ``trunk_forward`` then
``head_forward`` (or ``fused_field_forward_kernel`` alone above 256
wide); one of ``csrc/fused_field_bwd.cu`` runs ``trunk_forward``,
``head_backward``, ``trunk_backward`` and ``weight_grad``.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from port_bench import costs

FIELD_KERNELS = ("trunk_forward", "head_forward", "fused_field_forward_kernel",
                 "head_backward", "trunk_backward", "weight_grad")
FORWARD_OP = "oncde::fused_field_forward"


@dataclass
class Segment:
    """Device events ``(name, start_ns, dur_ns)`` sorted by start, host ops
    ``(name, start_ns, dur_ns, shapes)`` (empty without host tracing), the
    wall seconds and the units traced."""

    device: list
    host: list = field(default_factory=list)
    wall_s: float = 0.0
    units: int = 1

    def kernels(self):
        """Device events that are kernels (not copies or fills)."""
        return [e for e in self.device if not e[0].startswith(("Memcpy", "Memset"))]

    def intervals(self):
        """The union of the device's busy intervals, [(start_ns, end_ns)]."""
        merged = []
        for _, start, dur in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], start + dur)
            else:
                merged.append([start, start + dur])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e9


def is_field_kernel(name: str) -> bool:
    return any(k in name for k in FIELD_KERNELS)


def _segment(unit, n, host: bool, device) -> Segment:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=activities, record_shapes=host) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            unit()
        sync()
        wall = time.perf_counter() - t0
    dev, ops = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.duration_ns()))
        elif host:
            ops.append((e.name(), e.start_ns(), e.duration_ns(), e.shapes()))
    dev.sort(key=lambda e: e[1])
    ops.sort(key=lambda e: e[1])
    return Segment(device=dev, host=ops, wall_s=wall, units=n)


def capture(unit, n: int, device) -> dict:
    """``steady`` (``n`` units, device only), ``detailed`` (one unit with
    host ops) and the field calls of the detailed one."""
    steady = _segment(unit, n, False, device)
    detailed = _segment(unit, 1, True, device)
    return {"steady": steady, "detailed": detailed, "calls": field_calls(detailed)}


def field_calls(seg: Segment) -> list:
    """``[(kind, batch, channels, device_s)]``, one per call of a field
    kernel in the segment; empty where the device ran no field kernel.
    Raises where the device's field kernels do not pair one to one with the
    host's forward ops, so that a lost pairing fails the run instead of
    silencing the rooflines."""
    shapes = [op[3] for op in seg.host if op[0] == FORWARD_OP]
    calls, trunk, fwd = [], 0, 0
    for name, _, dur in seg.kernels():
        if "trunk_forward" in name:
            trunk = dur
        elif "head_forward" in name or "fused_field_forward_kernel" in name:
            if fwd >= len(shapes):
                raise RuntimeError(f"field kernels unpaired: a forward kernel past the "
                                   f"{len(shapes)} {FORWARD_OP} ops on the host")
            z, dx = shapes[fwd][0], shapes[fwd][1]
            fwd += 1
            calls.append(["forward", z[0], dx[-1], (trunk + dur) / 1e9])
            trunk = 0
        elif "head_backward" in name:
            last = next((c for c in reversed(calls) if c[0] == "forward"), None)
            if last is None:
                raise RuntimeError("field kernels unpaired: a backward kernel before "
                                   "any forward one")
            calls.append(["backward", last[1], last[2], (trunk + dur) / 1e9])
            trunk = 0
        elif ("trunk_backward" in name or "weight_grad" in name) and calls \
                and calls[-1][0] == "backward":
            calls[-1][3] += dur / 1e9
    if calls and fwd != len(shapes):
        raise RuntimeError(f"field kernels unpaired: {fwd} forward kernels on the device, "
                           f"{len(shapes)} {FORWARD_OP} ops on the host")
    return calls


def roofline_pct(calls, cfg, kind):
    """Sum of the calls' bounds over the sum of their device time, in %, of
    the ``kind`` ("forward" or "backward") calls; None without any."""
    mine = [c for c in calls if c[0] == kind]
    if not mine:
        return None
    bound = sum(costs.call_bound_s(kind, b, cfg, i) for _, b, i, _ in mine)
    return 100.0 * bound / sum(c[3] for c in mine)


def idle_pct(seg: Segment):
    if not seg.device or seg.wall_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s() / seg.wall_s)


def glue_s(seg: Segment) -> float:
    """Device seconds of every kernel that is not a field kernel."""
    return sum(d for n, _, d in seg.kernels() if not is_field_kernel(n)) / 1e9


def breakdown(readings) -> dict:
    """The device ops that took most time in the steady segment, and the
    longest idle gaps of the detailed one summed by the innermost host op
    running at each gap's middle."""
    by_name = defaultdict(float)
    for name, _, dur in readings.steady.device:
        by_name[name[:120]] += dur / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    seg = readings.detailed
    gaps = defaultdict(float)
    busy = seg.intervals()
    open_ops, i = [], 0          # a max-heap by start of the host ops begun so far
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        mid = (end + start) / 2
        while i < len(seg.host) and seg.host[i][1] <= mid:
            name, s, d, _ = seg.host[i]
            heapq.heappush(open_ops, (-s, s + d, name))
            i += 1
        while open_ops and open_ops[0][1] < mid:    # ended before this gap and every later one
            heapq.heappop(open_ops)
        inner = open_ops[0][2] if open_ops else "(no host op)"
        gaps[inner[:120]] += (start - end) / 1e9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(kv) for kv in ops], "idle_gaps": [list(kv) for kv in idle]}
