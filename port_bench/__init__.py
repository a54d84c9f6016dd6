"""The benchmark of ``online_neural_cdes_tpu_torch`` on one NVIDIA card.

``python port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the root ``BENCHMARK.json`` and prints
one JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``,
``workloads/<cell>.json`` and ``layer_metrics/<metric>.py``.
"""
