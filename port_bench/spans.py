"""The port's spans (``online_neural_cdes_tpu_torch.utils.profiling``) on
the device trace's clock: each layer's self time, and the device idle time
each layer causes, per unit (a training step or a tick).

The ``spanned`` segment is ``n`` units traced with the device's activity
alone, as ``trace.py``'s ``steady`` segment is, inside
``profiling.collect_spans()``; it is traced after ``steady`` and
``detailed``, so neither of those sees a span.  Spans are stamped with
``time.time_ns()``, the clock of ``torch.profiler``'s events
(``tests/test_port_bench_spans_card.py`` checks it on the card).

The groups of spans, by the layer each times:

- ``spline``: ``oncde.spline.setup`` (the spline and h0);
- ``scan``: ``oncde.cdeint.scan`` (the interval adjoint's forward scan);
- ``adjoint``: ``oncde.cdeint.adjoint`` (its reverse solve);
- ``optim``: ``oncde.train.optimizer`` (``zero_grad``, the learning rates
  and Adam's update);
- ``upload``: ``oncde.serve.upload`` (a tick's observations to the device);
- ``loop``: every other span (the step, the backward call, the model's
  forward, the tick), and the time under no span.

A span's self time is its duration less the part its children cover, on
any thread of its unit (the reverse solve runs on autograd's device
thread, under the backward call).  Each idle gap of the device (between
the first unit's start, the merged busy intervals and the last unit's end)
is charged, at its middle, to the deepest span open then on any thread, or to ``loop``
under none.  So the groups' self times add up to the units' durations,
and their idle times to the window's idle time.

    python3 port_bench/spans.py --workload rect-train-b32768 --seed 2147483700

sets a cell up as a run does, then traces ``steady``, ``detailed`` and
``spanned`` ``--rounds`` times and prints one JSON line a round (the
groups' times a unit, their sums, the first unit's idle time and the
others', and ``spanned``'s
wall time a unit against ``steady``'s), then, with ``--pairs``, one line of
units timed with spans recorded and not, in turns; all also written to
``chiprun_out/spans-<cell>-<seed>.json``.
A cell kept under ``pending/`` is found there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if __package__ in (None, ""):
    sys.path.insert(0, str(ROOT))

from port_bench import trace  # noqa: E402

GROUPS = {
    "spline": ("oncde.spline.setup",),
    "scan": ("oncde.cdeint.scan",),
    "adjoint": ("oncde.cdeint.adjoint",),
    "optim": ("oncde.train.optimizer",),
    "upload": ("oncde.serve.upload",),
}
LOOP = "loop"
TRAIN_GROUPS = ("spline", "scan", "adjoint", "optim", LOOP)


@dataclass
class SpannedSegment(trace.Segment):
    """A segment with the spans recorded over it (``profiling.Span``)."""

    spans: list = field(default_factory=list)

    def window(self):
        """``(start_ns, end_ns)``: the first unit's start to the last unit's
        or the device's end, whichever is later."""
        own = units(self.spans)
        start = self.spans[own[0]].start_ns
        end = max([self.spans[own[-1]].end_ns] + [a + d for _, a, d in self.device[-1:]])
        return start, end


def group_of(name: str) -> str:
    return next((g for g, names in GROUPS.items() if name in names), LOOP)


def capture(unit, n: int, device):
    """The ``spanned`` segment of ``n`` calls of ``unit``; None where the
    port records no spans."""
    from online_neural_cdes_tpu_torch.utils import profiling

    if not hasattr(profiling, "collect_spans"):
        return None
    with profiling.collect_spans() as spans:
        seg = trace._segment(unit, n, False, device)
    return SpannedSegment(**vars(seg), spans=list(spans))


def units(spans) -> list:
    """Indices of the closed units' own records."""
    return [i for i, s in enumerate(spans) if s.unit_id == i and s.end_ns is not None]


def self_ns(spans) -> list:
    """Each record's duration less the union of its children's intervals
    within it (0 for a record still open)."""
    children = [[] for _ in spans]
    for s in spans:
        if s.parent is not None and s.end_ns is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = []
    for s, kids in zip(spans, children):
        if s.end_ns is None:
            out.append(0)
            continue
        covered, reach = 0, s.start_ns
        for a, b in sorted(kids):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out.append(s.end_ns - s.start_ns - covered)
    return out


def idle_gaps(seg: SpannedSegment) -> list:
    """``[(start_ns, end_ns)]``: the window's stretches with nothing on the
    device."""
    start, end = seg.window()
    gaps, at = [], start
    for a, b in seg.intervals():
        if a > at:
            gaps.append((at, min(a, end)))
        at = max(at, b)
    if end > at:
        gaps.append((at, end))
    return [(a, b) for a, b in gaps if b > a]


def _depths(spans) -> list:
    depths = []
    for s in spans:               # a parent is recorded before its children
        depths.append(0 if s.parent is None else depths[s.parent] + 1)
    return depths


def idle_by_group_ns(seg: SpannedSegment) -> dict:
    """The window's idle nanoseconds by the group of the deepest span open
    at each gap's middle."""
    depths = _depths(seg.spans)
    deepest_first = sorted(((-d, s.start_ns, s.end_ns, group_of(s.name))
                            for s, d in zip(seg.spans, depths)), key=lambda e: e[0])
    out = {g: 0 for g in (*GROUPS, LOOP)}
    for a, b in idle_gaps(seg):
        mid = (a + b) / 2
        group = next((g for _, s, e, g in deepest_first
                      if s <= mid and (e is None or mid < e)), LOOP)
        out[group] += b - a
    return out


def _readable(seg) -> bool:
    """A segment with spans and with the card's activity."""
    return seg is not None and bool(seg.device) and bool(units(seg.spans))


def span_self_ms(seg, group: str):
    """Milliseconds a unit of the ``group``'s self time; None off the card
    or without spans."""
    if not _readable(seg):
        return None
    own = set(units(seg.spans))
    total = sum(t for s, t in zip(seg.spans, self_ns(seg.spans))
                if s.unit_id in own and group_of(s.name) == group)
    return total / 1e6 / len(own)


def span_idle_ms(seg, group: str):
    """Milliseconds a unit of device idle charged to ``group``; None off
    the card or without spans."""
    if not _readable(seg):
        return None
    return idle_by_group_ns(seg)[group] / 1e6 / seg.units


def unit_ms(seg) -> float:
    """The units' mean duration in ms."""
    own = units(seg.spans)
    return sum(seg.spans[i].end_ns - seg.spans[i].start_ns for i in own) / 1e6 / len(own)


def idle_ms(seg) -> float:
    """The window's idle milliseconds a unit."""
    return sum(b - a for a, b in idle_gaps(seg)) / 1e6 / seg.units


def unit_idle_ms(seg) -> list:
    """Each unit's idle milliseconds (the gaps whose middle falls in it),
    in order."""
    bounds = [(seg.spans[i].start_ns, seg.spans[i].end_ns) for i in units(seg.spans)]
    out = [0.0] * len(bounds)
    for a, b in idle_gaps(seg):
        mid = (a + b) / 2
        k = next((k for k, (s, e) in enumerate(bounds) if s <= mid < e), None)
        if k is not None:
            out[k] += (b - a) / 1e6
    return out


def on_off_ms(unit, n: int, pairs: int, device) -> list:
    """``[(ms a unit with spans recorded, ms without)]``: ``pairs`` turns of
    ``n`` units each way, no profiler."""
    from online_neural_cdes_tpu_torch.utils import profiling

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def block():
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            unit()
        sync()
        return 1e3 * (time.perf_counter() - t0) / n

    out = []
    for _ in range(pairs):
        with profiling.collect_spans():
            on = block()
        out.append((on, block()))
    return out


def report(readings, spanned, groups=TRAIN_GROUPS) -> dict:
    """The groups' times a unit beside the totals they should add up to,
    the first unit's idle time and the others' mean, and the spanned
    segment's wall time a unit against ``steady``'s."""
    steady = readings["steady"]
    per_unit = unit_idle_ms(spanned)
    selfs = {g: span_self_ms(spanned, g) for g in groups}
    idles = {g: span_idle_ms(spanned, g) for g in groups}
    steady_ms = 1e3 * steady.wall_s / steady.units
    spanned_ms = 1e3 * spanned.wall_s / spanned.units
    return {"self_ms": selfs, "idle_ms": idles,
            "self_sum_ms": sum(selfs.values()), "unit_ms": unit_ms(spanned),
            "idle_sum_ms": sum(idles.values()), "window_idle_ms": idle_ms(spanned),
            "first_unit_idle_ms": per_unit[0],
            "other_units_idle_ms": statistics.fmean(per_unit[1:]) if per_unit[1:] else None,
            "steady_wall_ms": steady_ms, "spanned_wall_ms": spanned_ms,
            "on_cost_pct": 100.0 * (spanned_ms / steady_ms - 1.0),
            "steady_idle_pct": trace.idle_pct(steady), "spanned_idle_pct": trace.idle_pct(spanned),
            "spans_per_unit": len(spanned.spans) / spanned.units}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--pairs", type=int, default=0,
                        help="turns of units with spans recorded and not, after the rounds")
    args = parser.parse_args(argv)

    import importlib

    from port_bench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = harness.load_bench(ROOT)
    pending = ROOT / "port_bench" / "pending" / f"{args.workload}.json"
    if args.workload not in [w["name"] for w in bench["workloads"]] and pending.exists():
        for section, entries in json.loads(pending.read_text()).items():
            bench[section].extend(entries)
    cell = harness.load_cell(ROOT, bench, args.workload)
    device = torch.device("cuda")
    driver = importlib.import_module(f"port_bench.drivers.{cell.spec['driver']}").Driver(
        cell.cfg, cell.mix, args.seed, device)
    driver.setup()
    setup_s = harness.process_age_s()
    groups = TRAIN_GROUPS if cell.spec["driver"] == "train" else ("upload", LOOP)
    out = ROOT / "chiprun_out" / f"spans-{args.workload}-{args.seed}.json"
    out.parent.mkdir(exist_ok=True)
    lines = []
    for r in range(args.rounds):
        readings = trace.capture(driver.unit, cell.spec["trace_units"], device)
        spanned = capture(driver.unit, cell.spec["trace_units"], device)
        line = {"workload": args.workload, "seed": args.seed, "round": r,
                "device": torch.cuda.get_device_name(device), "setup_s": setup_s,
                **report(readings, spanned, groups)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.pairs:
        turns = on_off_ms(driver.unit, cell.spec["trace_units"], args.pairs, device)
        lines.append({"on_off_ms": turns, "on_cost_pct_median": 100.0 * (
            statistics.median(on / off for on, off in turns) - 1.0)})
        print(json.dumps(lines[-1]), flush=True)
    out.write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
