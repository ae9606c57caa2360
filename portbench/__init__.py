"""The benchmark of ``crossclr_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line last.  What
belongs to one cell, configuration, traffic kind or per-layer metric lives
in files of its own, found by the names in ``BENCHMARK.json``:
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<kind>.py``, ``layer_metrics/<metric>.py``,
``families/<layer>/*.txt`` and ``work/<op>.py``.  ``reference/`` is the
plain float32 PyTorch that decides ``correct``; it imports nothing of the
program.
"""
