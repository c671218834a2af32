"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Everything a cell needs is found
by name: ``configs/<config>.json``, ``workloads/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``. Nothing here imports
the JAX package (``repro``), JAX, or ``benchmarks/``; ``reference.py``
imports nothing of ``repro_torch`` either.
"""
