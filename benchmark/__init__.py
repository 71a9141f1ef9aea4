"""The benchmark of ``vilgod_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
needs is data found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``limits/<config>.json`` and one reader per
per-layer metric in ``metrics/<name>.py``. The plain reference that
decides ``correct`` is under ``reference/`` and imports nothing of the
program.
"""
