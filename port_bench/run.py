#!/usr/bin/env python3
"""Run one cell of the benchmark of ``online_neural_cdes_tpu_torch``.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints the numbers compared with their limits as the last lines of
standard error and one JSON object as the last line of standard output.
Exits with a code other than 0, printing no result, where no card is
visible, where the port cannot be imported, or where a module of JAX or of
the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    bench = harness.load_bench(ROOT)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
