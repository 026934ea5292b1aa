"""The PyTorch/CUDA port's benchmark.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA
device and prints one JSON result line.  Everything a cell needs is found
by name: its traffic in ``workloads/<cell>.json``, its model in
``configs/<config>.json``, each per-layer metric's reader in
``metrics/<metric>.py``.
"""
