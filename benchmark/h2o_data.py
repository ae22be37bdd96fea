"""The db-benchmark groupby data set G1_<N>_<K>_0_0 (h2oai db-benchmark,
continued by DuckDB Labs; ``_data/groupby-datagen.R``), made on the device
from a ``torch.Generator``, rows unsorted and no NAs:

    id1, id2  sprintf("id%03d", sample(K, N, TRUE))      K distinct strings
    id3       sprintf("id%010d", sample(N/K, N, TRUE))   N/K distinct strings
    id4, id5  sample(K, N, TRUE)                          int
    id6       sample(N/K, N, TRUE)                        int
    v1        sample(5, N, TRUE)                          int
    v2        sample(15, N, TRUE)                         int
    v3        round(runif(N, max=100), 6)                 double

Departures from the R script: the draws are the generator's, not R's
stream; the string columns are uint32 codes into sorted dictionaries whose
entry 0 is ``""`` (the value ``i`` has code ``i``); the integers are int32;
v3 is ``randint(0, 10**8 + 1) / 10**6`` in float64.
"""

from __future__ import annotations

import numpy as np
import torch

STRINGS = {"id1": "id%03d", "id2": "id%03d", "id3": "id%010d"}


def vocabulary(fmt: str, count: int) -> np.ndarray:
    """The sorted dictionary of ``fmt % i`` for i in 1..count, ``""`` first
    (zero padding makes the string order the numeric one)."""
    return np.concatenate([[""], np.char.mod(fmt, np.arange(1, count + 1))])


def generate(gen: torch.Generator, cfg: dict):
    """({column name: tensor} on ``gen``'s device, {string column:
    dictionary}). ``cfg`` gives ``rows`` (N) and ``k`` (K)."""
    n, k = cfg["rows"], cfg["k"]
    dev = gen.device

    def sample(hi):  # 1..hi, uniform with replacement
        return torch.randint(1, hi + 1, (n,), generator=gen, device=dev, dtype=torch.int32)

    cols = {
        "id1": sample(k).view(torch.uint32),
        "id2": sample(k).view(torch.uint32),
        "id3": sample(n // k).view(torch.uint32),
        "id4": sample(k),
        "id5": sample(k),
        "id6": sample(n // k),
        "v1": sample(5),
        "v2": sample(15),
        "v3": torch.randint(0, 10**8 + 1, (n,), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.float64) / 10**6,
    }
    sizes = {"id1": k, "id2": k, "id3": n // k}
    return cols, {c: vocabulary(STRINGS[c], sizes[c]) for c in STRINGS}
