"""On the card, at each cell's own size: the program's numbers within their
limits, the control's (the reference in TF32 in the program's place)
past one of them.  Run there with

    python3 -m pytest port_bench/tests/test_port_bench_card.py -q
"""

import pytest

from port_bench import calibrate, harness
from port_bench.conftest import ROOT

CELLS = [w["name"] for w in harness.load_bench(ROOT)["workloads"]]
SEED = 2**31 + 2024


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_within_and_control_past_the_limits(card, name):
    cell = harness.load_cell(ROOT, harness.load_bench(ROOT), name)
    limits = cell.spec["limits"]
    program = calibrate.program_numbers(cell, SEED, card)
    assert all(v <= limits[k] for k, v in program.items()), program
    control = calibrate.control_numbers(cell, SEED, card)
    assert any(v > limits[k] for k, v in control.items()), control
