"""radix_sort_tpu_torch -- the engine's PyTorch and CUDA port.

The counterpart of ``radix_sort_tpu`` (the JAX package, which stays the
reference) for one NVIDIA H100. It mirrors that package's module names.
It ports the sort (key transforms, the public sort API, and the
sample-sort engine whose data movement is a CUDA kernel written for Hopper,
``csrc/extract.cu``) and the join slice of the query operators (``filter``,
``searchsorted``, ``unique``, ``hash_join``, ``repeat``, whose expansion is
a second such kernel, ``csrc/expand.cu``); the kernels are built at first
use. Aggregation, band joins, tables, SQL and the multi-device layer are
not ported yet (ROADMAP.md).
"""

from radix_sort_tpu_torch import config, keys
from radix_sort_tpu_torch.ops.query import (
    JOIN_HOWS,
    filter,
    hash_join,
    repeat,
    searchsorted,
    unique,
)
from radix_sort_tpu_torch.ops.sort import (
    IMPLEMENTATIONS,
    argsort,
    counting_sort,
    sort,
    sort_limbs,
    sort_pairs,
)

__version__ = "0.1.0"

__all__ = [
    "config",
    "keys",
    "sort",
    "argsort",
    "sort_pairs",
    "sort_limbs",
    "counting_sort",
    "IMPLEMENTATIONS",
    "filter",
    "hash_join",
    "repeat",
    "searchsorted",
    "unique",
    "JOIN_HOWS",
    "__version__",
]
