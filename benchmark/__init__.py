"""The benchmark of ``radix_sort_tpu_torch`` on NVIDIA GPUs.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
query or metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it (``harness.Registry``).
"""
