"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; see ``portbench/README.md``."""
