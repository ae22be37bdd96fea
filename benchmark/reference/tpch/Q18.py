"""TPC-H Q18 (2.4.18, QUANTITY = 300): the large volume customer query,
the first 100 orders whose lineitems hold more than 300 units."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.tpch import common as C

QUANTITY = 300
LIMIT = 100


def answer(raw, lower=False) -> C.Answer:
    li, orders, cust = raw["lineitem"], raw["orders"], raw["customer"]
    f64, _ = C.dtypes(lower)
    uk, inv = torch.unique(C.u32_as_i64(li["l_orderkey"]), return_inverse=True)
    qty = torch.zeros_like(uk).index_add_(0, inv, li["l_quantity"].to(torch.int64))
    big = qty > QUANTITY
    kk, ks = uk[big], qty[big]
    o_keys, o_idx = torch.sort(C.u32_as_i64(orders["o_orderkey"]))
    at_o = torch.searchsorted(o_keys, kk).clamp(max=o_keys.shape[0] - 1)
    pos = o_idx[at_o]
    price = orders["o_totalprice"][pos].to(f64)
    date, ock = orders["o_orderdate"][pos], orders["o_custkey"][pos]
    c_keys = torch.sort(cust["c_custkey"]).values
    at_c = torch.searchsorted(c_keys, ock).clamp(max=c_keys.shape[0] - 1)
    joined = (o_keys[at_o] == kk) & (c_keys[at_c] == ock)  # the two inner joins
    kk, ks, price, date, ock = kk[joined], ks[joined], price[joined], date[joined], ock[joined]
    # ORDER BY o_totalprice DESC, o_orderdate; equal rows by the group keys
    # (c_custkey, o_orderkey): kk ascending already
    perm = torch.sort(ock, stable=True).indices
    perm = perm[torch.sort(date[perm], stable=True).indices]
    perm = perm[torch.sort(price[perm], stable=True, descending=True).indices][:LIMIT]
    cols = {"c_custkey": C.host(ock[perm]),
            "o_orderkey": C.host(kk[perm]).astype(np.uint32),
            "o_orderdate": C.host(date[perm]),
            "o_totalprice": C.host(price[perm].to(torch.float64)),
            "sum_qty": C.host(ks[perm]).astype(np.int32)}
    types = {"c_custkey": "int64", "o_orderkey": "uint32", "o_orderdate": "int32",
             "o_totalprice": "float64", "sum_qty": "int32"}
    return C.Answer(cols, types)
