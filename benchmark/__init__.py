"""The benchmark of ``interpol_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once.  Cells, configurations, traffic
mixes, drivers, systems, work counts, kernel lists and metric readers are
files found by name (``registry.py``); the plain reference lives in
``reference/`` and imports nothing of the program.
"""
