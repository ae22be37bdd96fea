"""Worked examples of the port's public API: ``query_demo`` (filter, join,
GROUP BY on tensors), ``table_demo`` (a Table pipeline with an ASOF join)
and ``dist_table_demo`` (the same kind of pipeline over a DistTable).
Counterparts of the repository's ``examples/``; run each with
``python -m radix_sort_tpu_torch.examples.<name>``."""
