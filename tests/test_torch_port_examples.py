"""The port's example scripts run on the CPU (the JAX examples' counterparts,
``tests/test_examples.py``): ``examples/long_context_torch.py`` compresses a
series by log-ODE windows and trains the raw series through the pipelined
adjoint over two gloo ranks it starts itself."""

import importlib
import os
import sys

import numpy as np

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def test_long_context_example_runs(capsys):
    """Both ranks return the same loss and gradient norm; the pipelined
    forward equals the one-process model's loss (float32, rtol 1e-5)."""
    sys.path.insert(0, EXAMPLES)   # the spawned ranks import the script by name
    try:
        example = importlib.import_module("long_context_torch")
        out = example.main()
    finally:
        sys.path.remove(EXAMPLES)
    printed = capsys.readouterr().out
    assert "log-ODE: (32, 257, 3) -> (32, 33, 6)" in printed
    assert "pipelined adjoint loss" in printed
    assert out[0]["loss"] == out[1]["loss"]
    assert out[0]["grad_norm"] == out[1]["grad_norm"]
    assert np.isfinite(out[0]["grad_norm"]) and out[0]["grad_norm"] > 0
    np.testing.assert_allclose(out[0]["loss"], out[0]["single_loss"], rtol=1e-5)
