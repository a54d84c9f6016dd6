"""Quickstart with the PyTorch port: train an online Neural CDE end to end.

Generates irregular synthetic data (NaN = missing), builds rectilinear
interpolation coefficients, trains a ``NeuralCDE`` through the interval
adjoint and evaluates: the counterpart of ``examples/quickstart.py``.

Run from the repo root (on the card; ``--device cpu`` without one):

    python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def make_data(n=256, length=16, channels=4, seed=0):
    """Irregularly observed series: channel 0 is time, NaN = unobserved."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, length, channels)).astype(np.float32).cumsum(axis=1)
    x[:, :, 0] = np.arange(length)                       # time channel
    x[rng.random(size=x.shape) < 0.3] = np.nan           # 30% missing
    x[:, :, 0] = np.arange(length)
    # Online binary labels: sign of a running statistic, NaN past a random
    # per-series end (the temporal loss masks them).
    labels = (np.nan_to_num(x[:, :, 1]) > 0).astype(np.float32)
    ends = rng.integers(length // 2, length, size=n)
    for i, e in enumerate(ends):
        labels[i, e:] = np.nan
    return x, labels


def main(device=None):
    from online_neural_cdes_tpu_torch import NeuralCDE, linear_interpolation_coeffs
    from online_neural_cdes_tpu_torch.training.loop import make_train_step

    x, labels = make_data()
    model = NeuralCDE(
        input_dim=x.shape[-1], hidden_dim=16, output_dim=1,
        hidden_hidden_dim=32, num_layers=1,
        interpolation="rectilinear", return_sequences=True,
        adjoint=True, solver="rk4",
        generator=torch.Generator().manual_seed(0), device=device,
    )
    # Rectilinear = the causal (online) interpolation: time advances, then
    # values update, so the model never peeks ahead.
    coeffs = linear_interpolation_coeffs(torch.from_numpy(x).to(model.device), rectilinear=0)
    labels_t = torch.from_numpy(labels).to(model.device)
    # Mixed precision: add compute_dtype="bfloat16" to run the forward and
    # backward on bf16 copies of the weights (f32 master weights).
    step = make_train_step(model, loss="bce", lr=1e-3)

    for epoch in range(20):
        loss = step(coeffs, labels_t, 1.0)
        if epoch % 5 == 0:
            print(f"epoch {epoch:3d}  loss {float(loss):.4f}")

    with torch.no_grad():
        logits = model(coeffs)[..., 0].cpu().numpy()
    mask = ~np.isnan(labels)
    acc = ((logits > 0) == (labels > 0.5))[mask].mean()
    print(f"final loss {float(loss):.4f}  masked train accuracy {acc:.3f}")
    return float(loss), float(acc)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or the CUDA card by default")
    main(ap.parse_args().device)
