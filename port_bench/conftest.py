"""Test settings of the benchmark's own tests (``port_bench/tests``).

``card`` marks a test that needs a CUDA card; the ``card`` fixture skips
it where none is visible (decided when the test runs, never at import).
``tiny_root`` is a copy of ``BENCHMARK.json`` and ``port_bench/`` whose
traffic mixes are cut to a few short series, so a whole run of a cell
fits on the CPU.  ``add_pending`` adds to such a copy's ``BENCHMARK.json``
the entries of a cell kept under ``port_bench/pending/`` (built and
tested, not yet measured within bounds).
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TINY = {"series": 6, "length": 9}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (root / "port_bench" / "traffic").glob("*.json"):
        params = json.loads(path.read_text())
        params.update(TINY)
        path.write_text(json.dumps(params))
    return root


def add_pending(root: Path, cell: str):
    """Adds ``pending/<cell>.json``'s entries to ``root``'s BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pending = json.loads((ROOT / "port_bench" / "pending" / f"{cell}.json").read_text())
    for section, entries in pending.items():
        bench[section].extend(entries)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
