"""capbench: the end-to-end benchmark of ``mit_tpu_torch`` on one GPU.

``python3 capbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell. Cells, configurations, traffic kinds and
per-layer metrics are files found by name (see ``capbench/core.py``).
"""
