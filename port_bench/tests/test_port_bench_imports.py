"""The reference imports nothing of the program, of JAX or of the JAX
package; the rest of the benchmark nothing of JAX or the JAX package.
Names are compared by their top-level part, whole (the port's name begins
with the JAX package's)."""

import ast

import pytest

from port_bench.conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "online_neural_cdes_tpu"}
PROGRAM = {"online_neural_cdes_tpu_torch"}
BENCH = ROOT / "port_bench"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not top_level_imports(path) & (JAX | PROGRAM)


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts), ids=lambda p: p.name)
def test_benchmark_imports_no_jax(path):
    assert not top_level_imports(path) & JAX


def test_the_check_compares_whole_names(monkeypatch):
    import sys

    from port_bench import harness

    monkeypatch.setitem(sys.modules, "online_neural_cdes_tpu_torch_probe", sys)
    assert "online_neural_cdes_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "online_neural_cdes_tpu.probe", sys)
    assert harness.forbidden_modules() == ["online_neural_cdes_tpu"]
