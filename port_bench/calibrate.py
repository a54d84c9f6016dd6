#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--controls 3]

For each seed, at the cell's own sizes, on the card: the numbers the run
compares for the program as it is (the lower readings), and, on the first
``--controls`` seeds, for the control (the reference in TF32, the
precision just below the configuration's float32, in the program's place)
and for each fault the cell can have, planted in the program (the upper
readings).  A training cell's readings need no measured window: they are
those of the three steps its set-up drives; a tick cell's compare the
scores of the cycle its set-up serves.  Prints one JSON line a seed, then
the largest lower and the smallest upper reading of each number.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def unchanged_state_train(driver):
    """A training step that returns the loss and leaves the weights and
    Adam's state as they were."""
    model = driver.model

    def step(inputs, labels, lr_scale):
        with torch.no_grad():
            preds = model(inputs)[..., 0]
        return torch.nn.functional.binary_cross_entropy_with_logits(preds, labels)

    driver.step = step
    step.optimizer = torch.optim.Adam(model.parameters())


def half_batch_train(driver):
    """A training step on the first half of the batch's rows, its loss the
    mean over them."""
    inner = driver.step

    def step(inputs, labels, lr_scale):
        rows = labels.shape[0] // 2
        return inner(tuple(t[:rows] for t in inputs), labels[:rows], lr_scale)

    step.optimizer = inner.optimizer
    driver.step = step


def unchanged_state_tick(driver):
    """A tick that serves the advanced state's scores but keeps the old
    state."""
    inner = driver.stepper.step
    driver.stepper.step = lambda state, x: (state, inner(state, x)[1])


def altered_answer_tick(driver):
    """The scores of each cycle's first tick handed one stream on."""
    inner = driver.tick

    def tick(k):
        y = inner(k)
        return np.roll(y, 1, axis=0) if k == 1 else y

    driver.tick = tick


FAULTS = {"train": {"unchanged_state": unchanged_state_train, "half_batch": half_batch_train},
          "tick": {"unchanged_state": unchanged_state_tick,
                   "altered_answer": altered_answer_tick}}


def program_numbers(cell, seed, device, fault=None) -> dict:
    """The numbers a run compares, with ``fault`` (a name of FAULTS)
    planted in the program after it is built."""
    driver = importlib.import_module(f"port_bench.drivers.{cell.spec['driver']}").Driver(
        cell.cfg, cell.mix, seed, device)
    driver.build()
    if fault is not None:
        FAULTS[cell.spec["driver"]][fault](driver)
    driver.warm()
    return driver.check()


def control_numbers(cell, seed, device) -> dict:
    """The numbers of the reference in TF32 in the program's place."""
    from port_bench import compare
    from port_bench.drivers import tick, train

    driver = (train if cell.spec["driver"] == "train" else tick).Driver(
        cell.cfg, cell.mix, seed, device)
    driver.build()
    if cell.spec["driver"] == "train":
        raw = [(driver.batches.x[k], driver.batches.static[k], driver.batches.labels[k])
               for k in range(train.FOLLOWED)]
        del driver.model, driver.step, driver.coeffs
        want = train.follow(cell.cfg, driver.weights0, raw, exact=True)
        got = train.follow(cell.cfg, driver.weights0, raw, tf32=True)
        return compare.train_numbers(*got, *want)
    del driver.stepper
    want = tick.reference_scores(driver.weights0, driver.static, driver.bank, device, exact=True)
    got = tick.reference_scores(driver.weights0, driver.static, driver.bank, device, tf32=True)
    return {"score_gap": compare.score_gap([list(got[:, :, None])], want)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--controls", type=int, default=3,
                        help="seeds (the first ones) that also read the control and faults")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    device = torch.device(args.device)
    bench = harness.load_bench(ROOT)
    cell = harness.load_cell(ROOT, bench, args.workload)
    lower, upper = {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = {"seed": seed, "program": program_numbers(cell, seed, device)}
        if i < args.controls:
            line["control"] = control_numbers(cell, seed, device)
            for fault in FAULTS[cell.spec["driver"]]:
                line[fault] = program_numbers(cell, seed, device, fault)
        print(json.dumps(line), flush=True)
        for key, value in line["program"].items():
            lower[key] = max(lower.get(key, 0.0), value)
        for kind, numbers in line.items():
            if kind not in ("seed", "program"):
                for key, value in numbers.items():
                    upper.setdefault(kind, {})[key] = min(upper.get(kind, {}).get(key, np.inf),
                                                          value)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
