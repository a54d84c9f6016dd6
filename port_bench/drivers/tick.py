"""Closed-loop online scoring: ``OnlineNCDEStepper`` over many streams,
ticks back to back.

Set-up builds the model and the stepper, draws the weights, the static
features and a bank of observations from the seed on the card, and keeps
the bank on the host as the ticks' arrays.  A cycle is ``init`` on the
bank's first row and a ``step`` on each later row; set-up runs one whole
cycle to warm every shape.  A tick starts when ``step`` is called with the
host array of new observations and ends when every stream's score is on
the host.  Every score served in the window is kept and compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import compare, harness, traffic
from port_bench.reference import ncde as reference


class Driver:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device

    def setup(self):
        self.build()
        self.warm()

    def build(self):
        """The model, its weights, the static features, the bank, the
        stepper."""
        from online_neural_cdes_tpu_torch import NeuralCDE, OnlineNCDEStepper

        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        model = NeuralCDE(
            input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
            output_dim=cfg["output_dim"], static_dim=cfg["static_dim"],
            hidden_hidden_dim=cfg["hidden_hidden_dim"], num_layers=cfg["num_layers"],
            interpolation=cfg["interpolation"], solver=cfg["solver"],
            return_sequences=cfg["return_sequences"], device=self.device)
        self.weights0 = harness.draw_weights(model, gen)
        batches = traffic.generate(self.mix, cfg["input_dim"], cfg["static_dim"], gen,
                                   self.device)
        self.static = batches.static[0]
        self.bank = list(batches.x[0].transpose(0, 1).cpu().numpy())   # (streams, C) a tick
        self.stepper = OnlineNCDEStepper(model, static=self.static, device=self.device)

    def warm(self):
        """One whole cycle; its scores."""
        self.answers = [self.cycle(len(self.bank))]
        self.k = len(self.bank)

    def tick(self, k):
        self.state, y = self.stepper.step(self.state, self.bank[k])
        return y.cpu().numpy()

    def cycle(self, ticks):
        """``init`` and ticks 1 .. ``ticks`` - 1; their scores."""
        self.state = self.stepper.init(self.bank[0])
        return [self.tick(k) for k in range(1, ticks)]

    def unit(self):
        """The next tick (a new cycle's ``init`` first when the bank is
        spent)."""
        if self.k == len(self.bank):
            self.state, self.k = self.stepper.init(self.bank[0]), 1
        self.tick(self.k)
        self.k += 1

    def window(self, seconds):
        """Ticks back to back for ``seconds``; each tick's latency on the
        host's clock, from the call of ``step`` to its scores on the host."""
        self.answers, latencies = [], []
        cpu0, t0 = harness.cpu_s(), time.perf_counter()
        done = False
        while not done:
            self.state, cycle = self.stepper.init(self.bank[0]), []
            for k in range(1, len(self.bank)):
                start = time.perf_counter()
                cycle.append(self.tick(k))
                end = time.perf_counter()
                latencies.append((end - start) * 1e3)
                if end - t0 >= seconds:
                    done = True
                    break
            self.answers.append(cycle)
        window_s, cpu = time.perf_counter() - t0, harness.cpu_s() - cpu0
        latencies = np.array(latencies)
        self.k = len(self.bank)
        failed = sum(int((~np.isfinite(a)).any()) for c in self.answers for a in c)
        return {"metrics": {"tick_p95_ms": float(np.percentile(latencies, 95))},
                "attempted": len(latencies), "failed": failed, "units": len(latencies),
                "window_s": window_s, "cpu_s": cpu, "latencies_ms": latencies}

    def check(self):
        """Frees the program's state, then runs one cycle of the reference
        on the same weights, static features and bank, and compares every
        score served in the window with it."""
        del self.stepper
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        want = reference_scores(self.weights0, self.static, self.bank, self.device, exact=True)
        return {"score_gap": compare.score_gap(self.answers, want)}


def reference_scores(weights0, static, bank, device, exact=False, tf32=False) -> np.ndarray:
    """The reference's scores of one cycle over the host ``bank``, (ticks - 1,
    streams): in float64 with ``exact`` (what a run is held to), else in
    float32, its products in TF32 with ``tf32`` (the control)."""
    dtype = torch.float64 if exact else torch.float32
    x = torch.from_numpy(np.stack(bank)).to(device=device, dtype=dtype)
    weights0 = {k: v.to(dtype) for k, v in weights0.items()}
    reference.no_tf32()
    with torch.no_grad():
        return reference.tick_cycle(weights0, static.to(dtype), x, tf32=tf32).cpu().numpy()
