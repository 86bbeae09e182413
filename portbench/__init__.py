"""The benchmark of ``etmppo_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Nothing here imports JAX or
the JAX package; ``reference/`` imports nothing of the port either.
"""
