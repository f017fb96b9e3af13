"""The benchmark of ``swiftvideo_tpu_torch``: data-driven cells run on one
CUDA card.  ``python3 -m svbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once (see ``svbench/run.py``).
"""
