"""One run of one cell: find its files by name, set it up, measure it,
read its per-layer metrics from a trace, check its answers against the
plain reference, and build the result line.

The cell's entry in ``BENCHMARK.json`` names its configuration and traffic
mix; ``workloads/<cell>.json`` names the driver (``drivers/<driver>.py``,
the code that drives one kind of entry point), how many units the trace
covers, and the limit of each number compared.  Which metrics a cell
reports, and their units, come from ``BENCHMARK.json``; each per-layer
metric is read by ``layer_metrics/<metric>.py``.  Adding a cell or a metric
is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import resource
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from port_bench import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "online_neural_cdes_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        after_name = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(after_name[19])              # field 22: starttime
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def cpu_s() -> float:
    """CPU seconds this process has used, every thread."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is exactly one of FORBIDDEN
    (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(root: Path, bench: dict, name: str) -> SimpleNamespace:
    """The cell ``name``: its entry, its workload file, its configuration
    and its traffic mix, each found by name."""
    from port_bench import traffic

    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = json.loads((root / "port_bench" / "workloads" / f"{name}.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[entry["config"]]["file"]).read_text())
    return SimpleNamespace(name=name, entry=entry, spec=spec, cfg=cfg,
                           mix=traffic.load(root, entry["traffic"]))


def metrics_for(bench: dict, section: str, cell: str) -> list:
    """The ``section`` ("end_to_end" or "per_layer") metrics that ``cell``
    reports: those that list it under ``workloads``, or list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def load_reader(root: Path, metric: str):
    """``layer_metrics/<metric>.py``'s ``read``."""
    path = root / "port_bench" / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def check_modules():
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device="cuda") -> dict:
    """Set up, measure and check the cell ``name``; returns the result
    line's object.  Set-up counts from the start of the process."""
    bench = load_bench(root)
    cell = load_cell(root, bench, name)
    device = torch.device(device)
    driver = importlib.import_module(f"port_bench.drivers.{cell.spec['driver']}").Driver(
        cell.cfg, cell.mix, seed, device)
    driver.setup()
    setup_s = process_age_s()

    measured = driver.window(seconds)
    check_modules()
    result = {"correct": False, "attempted": measured["attempted"],
              "failed": measured["failed"]}
    if trace:
        readings = SimpleNamespace(cfg=cell.cfg, mix=cell.mix, window=measured,
                                   **tracing.capture(driver.unit, cell.spec["trace_units"],
                                                     device))
        metrics = {}
        for m in metrics_for(bench, "per_layer", name):
            value = load_reader(root, m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        silent = [m["name"] for m in metrics_for(bench, "per_layer", name)
                  if m["name"] not in metrics]
        if silent and device.type == "cuda":
            # BENCHMARK.json lists these for this cell: on the card each has
            # something to read, and one that reads nothing is a fault.
            raise RuntimeError(f"per-layer metrics of {name} read nothing: {silent}")
        dev = device_info(device)
        dev.update(busy_s=readings.steady.busy_s(), window_s=readings.steady.wall_s)
        result.update(metrics=metrics, device=dev, breakdown=tracing.breakdown(readings))
    else:
        values = dict(measured["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_for(bench, "end_to_end", name)}
        result.update(metrics=metrics, device=device_info(device))

    numbers = driver.check()
    limits = cell.spec["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    result["correct"] = bool(measured["failed"] == 0 and compared and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values()))
    result["compared"] = compared
    check_modules()
    return result


def print_result(result: dict):
    """The numbers compared as the last lines of standard error, the result
    as the last line of standard output."""
    for key, c in result["compared"].items():
        print(f"compared {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_weights(model, gen: torch.Generator) -> dict:
    """Every parameter of ``model`` drawn anew from ``gen`` on the model's
    device in one call, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as the port's
    own initialisation; returns a copy keyed as the ``state_dict``."""
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    u = torch.rand(total, generator=gen, device=next(iter(params.values())).device)
    offset = 0
    with torch.no_grad():
        for name, p in params.items():
            fan_in = params[name[:-1] + "w"].shape[0]      # a layer's "w" is (in, out)
            chunk = u[offset:offset + p.numel()].view_as(p)
            p.copy_((2.0 * chunk - 1.0) / math.sqrt(fan_in))
            offset += p.numel()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
