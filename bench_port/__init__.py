"""The benchmark of paddlebox_tpu_torch on NVIDIA H100 cards.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. The package imports nothing of the JAX package.
"""
