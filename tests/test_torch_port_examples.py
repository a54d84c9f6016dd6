"""The port's example scripts run on the CPU (the JAX examples' counterparts,
``tests/test_examples.py``): ``examples/long_context_torch.py`` compresses a
series by log-ODE windows and trains the raw series through the pipelined
adjoint over two gloo ranks it starts itself; ``quickstart_torch.py``,
``streaming_inference_torch.py`` and ``deployment_torch.py`` print what
their JAX counterparts print."""

import importlib
import os
import sys

import numpy as np
import pytest

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


def _run_example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module(name).main(device="cpu")
    finally:
        sys.path.remove(EXAMPLES)


# Each example's printed lines, as its JAX counterpart prints them.
EXAMPLE_LINES = {
    "quickstart_torch": ("epoch   0  loss", "epoch  15  loss", "masked train accuracy"),
    "streaming_inference_torch": ("t=0   offline", "t=11  offline",
                                  "predict_many (throughput mode) == per-call predict: True",
                                  "serves identically: True"),
    "deployment_torch": ("exported 3 bucket shapes",
                         "loaded artifact serves bit-identically to the live predictor",
                         "same artifact served over a 1-rank mesh",
                         "update_params rolled the new checkpoint in (no re-export)",
                         "bf16 artifact: relative deviation", "deployment arc complete"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLE_LINES))
def test_example_runs_on_the_cpu(name, capsys):
    """``examples/quickstart_torch.py``, ``streaming_inference_torch.py`` and
    ``deployment_torch.py`` with ``device="cpu"``: every line their JAX
    counterparts print; the quickstart's loss falls below its first epoch's
    and the deployment's bf16 artifact stays within 5% of the output
    scale."""
    out = _run_example(name)
    printed = capsys.readouterr().out
    for line in EXAMPLE_LINES[name]:
        assert line in printed, line
    if name == "quickstart_torch":
        first = float(printed.split("epoch   0  loss ")[1].split()[0])
        assert np.isfinite(out[0]) and out[0] < first and 0.5 < out[1] <= 1.0
    if name == "deployment_torch":
        assert out["shapes"] == 3 and out["bf16_deviation"] < 0.05
