"""TPC-H Q13 (2.4.13): the customer distribution, customers counted by
their orders whose comment passes the predicate (``o_special`` marks the
others)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.tpch import common as C


def answer(raw, lower=False) -> C.Answer:
    orders, cust = raw["orders"], raw["customer"]
    ck = torch.sort(cust["c_custkey"]).values
    oc = orders["o_custkey"][~orders["o_special"]]
    at = torch.searchsorted(ck, oc).clamp(max=ck.shape[0] - 1)
    hit = ck[at] == oc
    per = torch.bincount(at[hit], minlength=ck.shape[0])  # LEFT JOIN: 0 for none
    c_count, custdist = torch.unique(per, return_counts=True)
    # ORDER BY custdist DESC, c_count DESC
    perm = torch.sort(c_count, stable=True, descending=True).indices
    perm = perm[torch.sort(custdist[perm], stable=True, descending=True).indices]
    cols = {"c_count": C.host(c_count[perm]).astype(np.int32),
            "custdist": C.host(custdist[perm]).astype(np.int32)}
    return C.Answer(cols, {"c_count": "int32", "custdist": "int32"})
