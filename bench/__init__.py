"""The end-to-end benchmark of ``repro_torch`` on one CUDA card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell needs is
found by name: its configuration in ``bench/configs/``, its traffic mix in
``bench/traffic/``, its correctness limits in ``bench/cells/`` and each
per-layer metric's reader in ``bench/metrics/``.  ``bench/reference/`` holds
the plain PyTorch references, which import nothing of the program.
"""
