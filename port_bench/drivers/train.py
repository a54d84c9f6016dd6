"""Closed-loop training: Adam steps of ``training.loop.make_train_step``
back to back on a pool of batches.

Set-up builds the model, draws its weights and the pool from the seed on
the card, builds each batch's coefficients as the data pipeline
precomputes them, and drives the step object through its first three
steps on pool batches 0, 1 and 2 (rows that all differ): the warm-up, and
the steps the reference follows.  The same object then runs the window.
"""

from __future__ import annotations

import time

import torch

from port_bench import compare, harness, traffic
from port_bench.reference import ncde as reference

FOLLOWED = 3   # steps the reference follows


class Driver:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.next = 0

    def setup(self):
        self.build()
        self.warm()

    def build(self):
        """The model, its weights, the pool and its coefficients, the step."""
        from online_neural_cdes_tpu_torch import (
            NeuralCDE, hermite_cubic_coefficients_with_backward_differences,
            linear_interpolation_coeffs)
        from online_neural_cdes_tpu_torch.training.loop import make_train_step

        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model = NeuralCDE(
            input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
            output_dim=cfg["output_dim"], static_dim=cfg["static_dim"],
            hidden_hidden_dim=cfg["hidden_hidden_dim"], num_layers=cfg["num_layers"],
            interpolation=cfg["interpolation"], solver=cfg["solver"],
            adjoint=cfg["adjoint"], return_sequences=cfg["return_sequences"],
            device=self.device)
        self.weights0 = harness.draw_weights(self.model, gen)
        self.batches = traffic.generate(self.mix, cfg["input_dim"], cfg["static_dim"], gen,
                                        self.device)
        if cfg["interpolation"] == "rectilinear":
            def coefficients(x):
                return linear_interpolation_coeffs(x, rectilinear=cfg["rectilinear_time_channel"])
        else:
            coefficients = hermite_cubic_coefficients_with_backward_differences
        self.coeffs = [coefficients(x) for x in self.batches.x]
        self.step = make_train_step(self.model, loss=cfg["loss"], lr=cfg["lr"],
                                    final_lr_multiplier=cfg["final_lr_multiplier"])

    def warm(self):
        """The first three steps, and what the reference is held to: their
        losses, the first gradient (from Adam's first moment after step 1)
        and the weights' change."""
        optimizer = self.step.optimizer
        beta1 = optimizer.defaults["betas"][0]
        losses = []
        for k in range(FOLLOWED):
            losses.append(self.unit())
            if k == 0:     # the first gradient, as Adam's first moment holds it
                self.grad1 = {n: optimizer.state[p].get("exp_avg", torch.zeros_like(p)).detach()
                              / (1 - beta1) for n, p in self.model.named_parameters()}
        self.losses = torch.stack(losses).detach()
        self.change = {n: p.detach() - self.weights0[n]
                       for n, p in self.model.named_parameters()}
        harness.synchronize(self.device)

    def unit(self):
        """One training step on the pool's next batch; returns the loss (on
        the device)."""
        k = self.next % self.mix["pool"]
        self.next += 1
        return self.step((self.batches.static[k], self.coeffs[k]), self.batches.labels[k],
                         1.0)

    def window(self, seconds):
        harness.synchronize(self.device)
        cpu0, t0 = harness.cpu_s(), time.perf_counter()
        losses = []
        while time.perf_counter() - t0 < seconds:
            losses.append(self.unit())
        harness.synchronize(self.device)
        window_s, cpu = time.perf_counter() - t0, harness.cpu_s() - cpu0
        steps = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        rows = steps * self.mix["series"]
        return {"metrics": {"train_rows_per_s": rows / window_s}, "attempted": steps,
                "failed": failed, "units": steps, "window_s": window_s, "cpu_s": cpu}

    def check(self):
        """Frees the program's state, then follows the first three steps with
        the reference on the same weights and raw batches."""
        got = (self.losses, self.grad1, self.change)
        raw = [(self.batches.x[k], self.batches.static[k], self.batches.labels[k])
               for k in range(FOLLOWED)]
        del self.model, self.step, self.coeffs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want = follow(self.cfg, self.weights0, raw, exact=True)
        return compare.train_numbers(*got, *want)


def follow(cfg, weights0, raw, exact=False, tf32=False):
    """(losses, first gradient, change of the weights) of the reference's
    Adam steps over ``raw`` from ``weights0``: in float64 with ``exact``
    (what a run is held to), else in float32, its products in TF32 with
    ``tf32`` (the control)."""
    dtype = torch.float64 if exact else torch.float32
    weights0 = {k: v.to(dtype) for k, v in weights0.items()}
    raw = [tuple(t.to(dtype) for t in batch) for batch in raw]
    reference.no_tf32()
    losses, grad1, after = reference.train_steps(
        weights0, cfg["interpolation"], raw, cfg["lr"], cfg["final_lr_multiplier"], tf32=tf32)
    return losses, grad1, {k: after[k] - weights0[k] for k in after}
