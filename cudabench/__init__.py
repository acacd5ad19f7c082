"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON line: ``python3 cudabench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``. Everything that
belongs to one configuration, traffic mix or metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it (see ``README.md``).
Nothing here imports ``jax`` or the JAX package.
"""
