"""The PyTorch/CUDA port's benchmark.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA
device and prints one JSON result line.  Everything a cell needs is found
by name: its traffic in ``workloads/<cell>.json``, its model in
``configs/<config>.json``, the plain reference that configuration names
in ``reference/<name>.py``, the recorder of each program entry it traces
in ``entries/<span>.py``, each per-layer metric's reader in
``metrics/<metric>.py``.  A configuration lists the entries it traces
under ``"entries"`` (``[{"entry": <name in repro_torch.kernels.ops>,
"span": <span>}]``; without the key a driver traces its ``ENTRIES``), and
may give the cut widths its host tests run at under ``"smoke"``
(``{"train": {...}, "serve": {...}}``).  So a new configuration is new
files and its entries in ``BENCHMARK.json``.
"""
