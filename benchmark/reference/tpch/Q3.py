"""TPC-H Q3 (2.4.3, SEGMENT = 'BUILDING', DATE = 1995-03-15): the
shipping priority query, the 10 unshipped orders of most revenue."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import tpch_data as D
from benchmark.reference.tpch import common as C

DATE = D.days(1995, 3, 15)
SEGMENT = "BUILDING"
LIMIT = 10


def answer(raw, lower=False) -> C.Answer:
    li, orders, cust = raw["lineitem"], raw["orders"], raw["customer"]
    f64, _ = C.dtypes(lower)
    code = int(np.searchsorted(D.SEGMENTS, SEGMENT))
    seg = cust["c_mktsegment"].view(torch.int32)
    building = torch.sort(cust["c_custkey"][seg == code]).values
    o_ok = orders["o_orderdate"] < DATE
    at = torch.searchsorted(building, orders["o_custkey"]).clamp(max=building.shape[0] - 1)
    o_ok &= building[at] == orders["o_custkey"]
    keys, order = torch.sort(C.u32_as_i64(orders["o_orderkey"])[o_ok])
    dates = orders["o_orderdate"][o_ok][order]
    prio = orders["o_shippriority"][o_ok][order]
    lk = C.u32_as_i64(li["l_orderkey"])
    at = torch.searchsorted(keys, lk).clamp(max=keys.shape[0] - 1)
    l_ok = (keys[at] == lk) & (li["l_shipdate"] > DATE)
    rev = li["l_extendedprice"][l_ok].to(f64) * (1 - li["l_discount"][l_ok].to(f64))
    uk, inv = torch.unique(lk[l_ok], return_inverse=True)
    g = uk.shape[0]
    revenue = C.sums(rev, inv, g, f64, lower)
    at = torch.searchsorted(keys, uk)
    # ORDER BY revenue DESC, o_orderdate; equal rows stay in key order
    perm = torch.sort(dates[at], stable=True).indices
    perm = perm[torch.sort(revenue[perm], stable=True, descending=True).indices][:LIMIT]
    cols = {"o_orderkey": C.host(uk[perm]).astype(np.uint32),
            "revenue": C.host(revenue[perm].to(torch.float64)),
            "o_orderdate": C.host(dates[at][perm]),
            "o_shippriority": C.host(prio[at][perm])}
    types = {"o_orderkey": "uint32", "revenue": "float64", "o_orderdate": "int32",
             "o_shippriority": "int32"}
    scales = {"revenue": (C.host(C.abs_sums(rev, inv, g)[perm]), "f64")}
    return C.Answer(cols, types, scales)
