"""The distributed layer: row-sharded operators over a mesh of shard slots
(counterpart of ``radix_sort_tpu/parallel``)."""
