"""A cell and a per-layer metric added as files and entries are found and
run without editing any code."""

import json

from port_bench import harness

SEED = 2**31 + 99


def add_cell_and_metric(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "hermite-train-tiny", "config": "mimic-ncde-hermite",
                               "traffic": "train-tiny", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "rows_per_step.tiny", "unit": "rows", "better": "higher",
                               "source": "host_clock", "layer": "Training loop",
                               "moves": "train_rows_per_s", "workloads": ["hermite-train-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench_dir = root / "port_bench"
    (bench_dir / "traffic" / "train-tiny.json").write_text(json.dumps(
        {"series": 4, "length": 6, "pool": 3, "gap_mean": 2.0, "nan_share": 0.1,
         "label_share": 0.5}))
    spec = json.loads((bench_dir / "workloads" / "hermite-train-b16384.json").read_text())
    (bench_dir / "workloads" / "hermite-train-tiny.json").write_text(json.dumps(spec))
    (bench_dir / "layer_metrics" / "rows_per_step.tiny.py").write_text(
        "def read(r):\n    return float(r.mix['series'])\n")


def test_new_files_are_found(tiny_root):
    add_cell_and_metric(tiny_root)
    bench = harness.load_bench(tiny_root)
    cell = harness.load_cell(tiny_root, bench, "hermite-train-tiny")
    assert cell.mix["series"] == 4 and cell.cfg["interpolation"] == "hermite"
    names = [m["name"] for m in harness.metrics_for(bench, "per_layer", "hermite-train-tiny")]
    assert names == ["rows_per_step.tiny"]
    assert [m["name"] for m in harness.metrics_for(bench, "end_to_end", "hermite-train-tiny")] \
        == ["setup_s"]


def test_new_cell_runs_and_reports_its_metric(tiny_root):
    add_cell_and_metric(tiny_root)
    result = harness.run_cell(tiny_root, "hermite-train-tiny", SEED, 0.2, True, device="cpu")
    assert result["correct"]
    assert result["metrics"] == {"rows_per_step.tiny": {"value": 4.0, "unit": "rows"}}
