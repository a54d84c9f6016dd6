"""Brownian-motion toy benchmark on the port.

The counterpart of the JAX package's ``experiments/sim_bm_toy.py``: train
the Neural CDE under each interpolation scheme for several repetitions and
write a table of train/test accuracy (mean and standard deviation) as CSV.
The schemes are the JAX script's: natural cubic, Hermite cubic with
backward differences, rectilinear and linear.  Repetitions run one after
another (the JAX script vmaps them).

Usage::

    python -m online_neural_cdes_tpu_torch.experiments.sim_bm_toy \\
        [--epochs 100] [--paths 4096] [--reps 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from functools import partial

import torch

from online_neural_cdes_tpu_torch.data.toy import brownian_motion_data
from online_neural_cdes_tpu_torch.models.ncde import NeuralCDE
from online_neural_cdes_tpu_torch.ops.interpolation import (
    hermite_cubic_coefficients_with_backward_differences,
    linear_interpolation_coeffs,
    natural_cubic_coeffs,
)
from online_neural_cdes_tpu_torch.training.loop import make_eval_step, make_train_step
from online_neural_cdes_tpu_torch.utils.device import resolve_device

__all__ = ["SCHEMES", "coefficients", "train_scheme", "main"]

# scheme -> (the model's interpolation, its coefficient function)
SCHEMES = {
    "cubic": ("cubic", natural_cubic_coeffs),
    "cubic_hermite": ("hermite", hermite_cubic_coefficients_with_backward_differences),
    "rectilinear": ("rectilinear", lambda x: linear_interpolation_coeffs(x, rectilinear=0)),
    "linear": ("linear", linear_interpolation_coeffs),
}
LR = 1e-3          # Adam, every parameter alike, as the JAX script
SEED = 2           # repetition r starts from weights of seed SEED + r
TEST_PATHS = 1024


def coefficients(name: str, x: torch.Tensor) -> torch.Tensor:
    """The scheme's interpolation coefficients of the paths ``x``."""
    if name not in SCHEMES:
        raise ValueError(f"unknown scheme {name!r}; one of {sorted(SCHEMES)}")
    return SCHEMES[name][1](x)


def make_model(name: str, hidden: int, width: int, seed: int, device) -> NeuralCDE:
    return NeuralCDE(
        input_dim=2, hidden_dim=hidden, output_dim=1, hidden_hidden_dim=width,
        num_layers=2, interpolation=SCHEMES[name][0], return_sequences=True,
        adjoint=True, solver="rk4", generator=torch.Generator().manual_seed(seed),
        device=device,
    )


def last_time_accuracy(model, coeffs, labels) -> torch.Tensor:
    """Share of paths whose sign at the last time is predicted (a device
    scalar)."""
    logits = make_eval_step(model)(coeffs)[..., 0]
    pred = torch.sigmoid(logits[:, -1]) > 0.5
    return (pred == (labels[:, -1] > 0.5)).to(torch.float32).mean()


def train_scheme(name, data, *, epochs, hidden, width, reps, batch_size, device,
                 models=None):
    """Train ``reps`` models of one scheme with Adam (LR, every parameter
    alike) on the mean BCE over every time step, as the JAX script does.
    ``data = (x_train, y_train, x_test, y_test)``; ``models`` optionally
    gives the starting models (one per repetition), else repetition r
    starts from weights of seed ``SEED + r``.  Returns the
    per-step losses (reps, steps), the last-time train accuracy before and
    after, the test accuracy after, and the training's wall seconds."""
    x_train, y_train, x_test, y_test = data
    c_train, c_test = coefficients(name, x_train), coefficients(name, x_test)
    n_batches = max(1, x_train.shape[0] // batch_size)
    out = {"losses": [], "train_acc_before": [], "train_acc": [], "test_acc": []}
    seconds = 0.0
    for rep in range(reps):
        model = (models[rep] if models is not None
                 else make_model(name, hidden, width, SEED + rep, device))
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                               loss="bce")
        out["train_acc_before"].append(last_time_accuracy(model, c_train, y_train))
        if c_train.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for _ in range(epochs):
            for b in range(n_batches):
                sl = slice(b * batch_size, (b + 1) * batch_size)
                losses.append(step(c_train[sl], y_train[sl]))
        losses = torch.stack(losses).cpu()  # waits for the card
        seconds += time.perf_counter() - t0
        out["losses"].append(losses)
        out["train_acc"].append(last_time_accuracy(model, c_train, y_train))
        out["test_acc"].append(last_time_accuracy(model, c_test, y_test))
    result = {k: torch.stack(v).cpu().numpy() for k, v in out.items()}
    result["seconds"] = seconds
    return result


def toy_data(num_paths, n_points, device):
    """Train paths from seed 0 and TEST_PATHS test paths from seed 1 (the
    JAX script's keys), made on the CPU and moved to ``device``."""
    x_train, y_train = brownian_motion_data(torch.Generator().manual_seed(0),
                                            num_paths, n_points, device=device)
    x_test, y_test = brownian_motion_data(torch.Generator().manual_seed(1),
                                          TEST_PATHS, n_points, device=device)
    return x_train, y_train, x_test, y_test


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--paths", type=int, default=4096)
    ap.add_argument("--points", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=10)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--schemes", nargs="+", default=list(SCHEMES),
                    choices=sorted(SCHEMES))
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    ap.add_argument("--out", default="results/sim_bm/results_table_torch.csv")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    data = toy_data(args.paths, args.points, device)
    run = partial(train_scheme, data=data, epochs=args.epochs, hidden=args.hidden,
                  width=args.width, reps=args.reps, batch_size=args.batch_size,
                  device=device)
    rows = []
    for name in args.schemes:
        r = run(name)
        train_acc, test_acc = r["train_acc"], r["test_acc"]
        print(f"{name:>14}: train {train_acc.mean():.3f}+-{train_acc.std():.3f}  "
              f"test {test_acc.mean():.3f}+-{test_acc.std():.3f}  "
              f"({r['seconds']:.1f}s for {args.reps} reps x {args.epochs} epochs "
              f"on {device})", flush=True)
        rows.append([name, float(train_acc.mean()), float(train_acc.std()),
                     float(test_acc.mean()), float(test_acc.std())])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["interpolation", "train_mean", "train_sd", "test_mean",
                         "test_sd"])
        writer.writerows(rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
