"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the H100.

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. See
``chipbench/run.py`` for the run and ``PERF.md`` for the cells.
"""
