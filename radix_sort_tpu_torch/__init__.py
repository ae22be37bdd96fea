"""radix_sort_tpu_torch -- the engine's PyTorch and CUDA port.

The counterpart of ``radix_sort_tpu`` (the JAX package, which stays the
reference) for one NVIDIA H100. It mirrors that package's module names.
It ports the sort (key transforms, the public sort API with
``lexsort``, ``sort_segments``, ``top_k`` and the 128-bit trio, and the
sample-sort engine whose data movement is a CUDA kernel written for Hopper,
``csrc/extract.cu``), the join slice of the query operators (``filter``,
``searchsorted``, ``unique``, ``hash_join``, ``repeat``, whose expansion is
a second such kernel, ``csrc/expand.cu``), the GROUP BY family
(``hash_aggregate`` with every aggregation, multi-aggregates and ROLLUP
levels), the relational completions (``join_asof``, set operators,
``quantiles``), band joins (``band_join``), window functions (``window``)
and the relational facade (``Table``, with NULL masks from ``nulls``,
dictionary-encoded strings from ``strings`` and dates from ``dates``), the
query-language layer (column expressions ``col`` / ``lit`` / ``where`` /
... from ``expr``, the lazy planner behind ``Table.lazy()`` in ``plan``,
and ``sql()``) and the LSD ladder of ``ops/xla_radix`` as the
``"xla_argsort"`` / ``"xla_rank"`` engines, and the first slice of the
distributed layer (``parallel``: a mesh of shard slots, several of which
may share one card, the distributed sort, GROUP BY, join, DISTINCT, top-k,
quantiles, filter, UNNEST and set operators); the kernels are built at
first use, and its second slice: the distributed windows and ASOF joins
and ``DistTable``, the sharded relation facade (``parallel.dist_table``,
exported lazily). ``Table`` puts its columns on the GPU unless it is given
``device="cpu"``. Host modules: ``native`` (the C++ host radix sort
``host_sort`` / ``host_sort_pairs`` and the C++ CSV loader behind
``Table.from_csv``, built with g++ at first use), ``utils.io`` (raw
dataset files, CSV reading), ``utils.distributions`` (the reference's
input distributions, made on the device), ``utils.profiling``
(``PhaseTimer``, ``speed_of_light_s``), the demo CLI
(``python -m radix_sort_tpu_torch.demo``) and three examples
(``radix_sort_tpu_torch.examples``).
"""

from radix_sort_tpu_torch import config, dates, keys, nulls, strings
from radix_sort_tpu_torch.expr import coalesce, col, concat, lit, null, nullif, udf, where
from radix_sort_tpu_torch.ops.query import (
    AGGREGATIONS,
    BAND_OPS,
    COMBINABLE_AGGREGATIONS,
    JOIN_HOWS,
    band_join,
    filter,
    hash_aggregate,
    hash_aggregate_levels,
    hash_join,
    repeat,
    searchsorted,
    unique,
)
from radix_sort_tpu_torch.ops.relational import (
    ASOF_DIRECTIONS,
    join_asof,
    quantiles,
    set_difference,
    set_intersect,
    set_union,
)
from radix_sort_tpu_torch.ops.sort import (
    IMPLEMENTATIONS,
    argsort,
    argsort128,
    counting_sort,
    lexsort,
    sort,
    sort128,
    sort_limbs,
    sort_pairs,
    sort_pairs128,
    sort_segments,
    top_k,
)
from radix_sort_tpu_torch.ops.window import WINDOW_OPS, window
from radix_sort_tpu_torch.sql import SqlError, sql
from radix_sort_tpu_torch.table import Table

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, as in the JAX package: the planner loads on first use
    if name == "LazyTable":
        from radix_sort_tpu_torch.plan import LazyTable

        return LazyTable
    if name == "DistTable":
        from radix_sort_tpu_torch.parallel.dist_table import DistTable

        return DistTable
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "config",
    "keys",
    "nulls",
    "strings",
    "dates",
    "Table",
    "LazyTable",
    "DistTable",
    "col",
    "lit",
    "udf",
    "where",
    "concat",
    "coalesce",
    "nullif",
    "null",
    "sql",
    "SqlError",
    "window",
    "band_join",
    "sort",
    "argsort",
    "sort_pairs",
    "sort_limbs",
    "lexsort",
    "top_k",
    "sort_segments",
    "sort128",
    "argsort128",
    "sort_pairs128",
    "counting_sort",
    "filter",
    "hash_aggregate",
    "hash_aggregate_levels",
    "hash_join",
    "repeat",
    "unique",
    "searchsorted",
    "join_asof",
    "set_union",
    "set_intersect",
    "set_difference",
    "quantiles",
    "ASOF_DIRECTIONS",
    "AGGREGATIONS",
    "COMBINABLE_AGGREGATIONS",
    "JOIN_HOWS",
    "BAND_OPS",
    "WINDOW_OPS",
    "IMPLEMENTATIONS",
    "__version__",
]
