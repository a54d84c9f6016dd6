"""Whole runs of each cell on the CPU at a tiny size, past the look for a
card: sound, they come out correct; with a fault planted under the timed
path, or with the control (the reference in TF32) in the program's place,
they do not.  The pending tick cell runs with its entries added."""

import json

import pytest
import torch

from port_bench import calibrate, harness
from port_bench.conftest import add_pending
from port_bench.drivers import tick, train

SEED = 2**32 + 5
CELLS = {"rect-train-b32768": train, "hermite-train-b16384": train, "rect-tick-s8192": tick}
PENDING = {"rect-tick-s8192"}
FAULTS = [(cell, fault) for cell, module in CELLS.items()
          for fault in calibrate.FAULTS["train" if module is train else "tick"]]


@pytest.fixture
def root(tiny_root, cell):
    """The tiny checkout, with the cell's entries added where it is pending."""
    if cell in PENDING:
        add_pending(tiny_root, cell)
    return tiny_root


def plant(monkeypatch, module, fault):
    build = module.Driver.build

    def faulty(self):
        build(self)
        fault(self)

    monkeypatch.setattr(module.Driver, "build", faulty)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    for trace in (False, True):
        result = harness.run_cell(root, cell, SEED, 0.2, trace, device="cpu")
        assert result["correct"], result["compared"]
        assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    module = CELLS[cell]
    plant(monkeypatch, module, calibrate.FAULTS["train" if module is train else "tick"][fault])
    result = harness.run_cell(root, cell, SEED, 0.2, False, device="cpu")
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    # The tick cell's whole cycle of 128 ticks, over a few streams: the
    # control's gap grows along the cycle.
    mix = root / "port_bench" / "traffic" / "tick-s8192.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), series=32, length=128)))
    bench = harness.load_bench(root)
    spec = harness.load_cell(root, bench, cell)
    numbers = calibrate.control_numbers(spec, SEED, torch.device("cpu"))
    assert any(v > spec.spec["limits"][k] for k, v in numbers.items()), numbers
