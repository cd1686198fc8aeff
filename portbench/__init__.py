"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything that belongs to one configuration, traffic mix or
metric sits in a file of its own (``configs/``, ``workloads/``,
``metrics/``, ``drivers/``), found by the name ``BENCHMARK.json`` gives.
"""
