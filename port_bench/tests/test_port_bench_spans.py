"""The ``spanned`` segment's readings (``spans.py``) on synthetic segments:
idle gaps charged to the deepest span across threads, or to ``loop``
under none, and the groups adding up to the window's idle time and to the
units' durations.  On the CPU at a tiny size: a cell's spans recorded,
the ``steady`` and ``detailed`` segments left as they were, and the
readers of ``pending/layer-spans.json`` silent in a whole traced run."""

from types import SimpleNamespace

import pytest
import torch

from online_neural_cdes_tpu_torch.utils.profiling import Span
from port_bench import harness, spans, trace
from port_bench.conftest import ROOT, add_pending
from port_bench.drivers import train

SEED = 2**31 + 77

# One unit of 1,000 ns on thread 1: the forward 0-400 holds the spline
# 10-60 and the scan 60-390; the backward 400-900 holds the reverse solve
# 420-880 on thread 2; the optimizer 900-990.
RECORDS = [Span("oncde.train.step", 0, None, 1, 0, 1000),
           Span("oncde.model.forward", 0, 0, 1, 0, 400),
           Span("oncde.spline.setup", 0, 1, 1, 10, 60),
           Span("oncde.cdeint.scan", 0, 1, 1, 60, 390),
           Span("oncde.train.backward", 0, 0, 1, 400, 900),
           Span("oncde.cdeint.adjoint", 0, 4, 2, 420, 880),
           Span("oncde.train.optimizer", 0, 0, 1, 900, 990)]
# Busy 50-300, 320-440, 500-1,000: gaps 0-50 (spline), 300-320 (scan),
# 440-500 (adjoint).
DEVICE = [("k", 50, 250), ("k", 320, 100), ("k", 400, 40), ("k", 500, 500)]


def segment(**kw):
    return spans.SpannedSegment(**{"device": DEVICE, "spans": RECORDS, **kw})


def test_gaps_go_to_the_deepest_span_across_threads():
    idle = spans.idle_by_group_ns(segment())
    assert idle == {"spline": 50, "scan": 20, "adjoint": 60, "optim": 0, "upload": 0,
                    "loop": 0}


def test_a_gap_outside_every_span_goes_to_loop():
    """Two units with the driver's code between them, 100-300."""
    seg = segment(spans=[Span("oncde.train.step", 0, None, 1, 0, 100),
                         Span("oncde.train.step", 1, None, 1, 300, 400)],
                  device=[("k", 0, 100), ("k", 300, 100)], units=2)
    assert spans.idle_by_group_ns(seg)["loop"] == 200
    assert spans.span_idle_ms(seg, "loop") == 100 / 1e6


def test_groups_add_up_to_the_idle_time_and_the_units():
    seg = segment()
    idle = [spans.span_idle_ms(seg, g) for g in spans.TRAIN_GROUPS]
    assert sum(idle) == pytest.approx(spans.idle_ms(seg)) == 130 / 1e6
    selfs = {g: spans.span_self_ms(seg, g) for g in spans.TRAIN_GROUPS}
    assert selfs == pytest.approx({"spline": 50e-6, "scan": 330e-6, "adjoint": 460e-6,
                                   "optim": 90e-6, "loop": 70e-6})
    assert sum(selfs.values()) == pytest.approx(spans.unit_ms(seg)) == 1000 / 1e6


def test_off_the_card_or_without_spans_nothing_is_read():
    for seg in (None, segment(device=[]), segment(spans=[])):
        assert spans.span_self_ms(seg, "scan") is None
        assert spans.span_idle_ms(seg, "scan") is None


def test_pending_readers_read_the_spanned_segment():
    r = SimpleNamespace(spanned=segment())
    for path in sorted((ROOT / "port_bench" / "layer_metrics").glob("*_ms.*.py")):
        kind = "self" if "_self_ms." in path.name else "idle" if "_idle_ms." in path.name \
            else None
        if kind is None:
            continue
        group = path.name.split(f"_{kind}_ms.")[0]
        want = (spans.span_self_ms if kind == "self" else spans.span_idle_ms)(r.spanned, group)
        assert harness.load_reader(ROOT, path.name[:-3])(r) == want
        assert harness.load_reader(ROOT, path.name[:-3])(SimpleNamespace()) is None


@pytest.fixture
def driver():
    cell = harness.load_cell(ROOT, harness.load_bench(ROOT),
                             "hermite-train-b16384")
    mix = dict(cell.mix, series=4, length=6)
    d = train.Driver(cell.cfg, mix, SEED, torch.device("cpu"))
    d.setup()
    return d


def test_a_cells_spans_leave_its_other_segments_as_they_were(driver):
    def names(readings):
        return [op[0] for op in readings["detailed"].host], len(readings["steady"].device)

    before = trace.capture(driver.unit, 2, torch.device("cpu"))
    assert not [n for n in names(before)[0] if n.startswith("oncde.")]
    seg = spans.capture(driver.unit, 2, torch.device("cpu"))
    own = spans.units(seg.spans)
    assert len(own) == 2 and len(seg.spans) == 2 * 8
    assert names(trace.capture(driver.unit, 2, torch.device("cpu"))) == names(before)


@pytest.mark.parametrize("cell", ["rect-train-b32768", "hermite-train-b16384",
                                  "rect-tick-s8192"])
def test_a_traced_run_with_the_pending_entries_is_sound_on_the_cpu(tiny_root, cell):
    if cell == "rect-tick-s8192":
        add_pending(tiny_root, cell)
    add_pending(tiny_root, "layer-spans")
    bench = harness.load_bench(tiny_root)
    listed = {m["name"] for m in harness.metrics_for(bench, "per_layer", cell)}
    assert {f"{g}_{k}_ms.{'tick' if 'tick' in cell else 'train'}"
            for g in (("upload",) if "tick" in cell else spans.TRAIN_GROUPS)
            for k in ("self", "idle")} <= listed
    result = harness.run_cell(tiny_root, cell, SEED, 0.2, True, device="cpu")
    assert result["correct"], result["compared"]
    assert not [m for m in result["metrics"] if "_self_ms." in m or "_idle_ms." in m]

