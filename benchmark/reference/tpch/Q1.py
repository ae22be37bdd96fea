"""TPC-H Q1 (2.4.1, DELTA = 90): the pricing summary report."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import tpch_data as D
from benchmark.reference.tpch import common as C

SHIPDATE = D.days(1998, 12, 1) - 90


def answer(raw, lower=False) -> C.Answer:
    li = raw["lineitem"]
    f64, f32 = C.dtypes(lower)
    m = li["l_shipdate"] <= SHIPDATE
    rf = li["l_returnflag"].view(torch.int32)[m].to(torch.int64)  # no uint32 indexing on CUDA
    ls = li["l_linestatus"].view(torch.int32)[m].to(torch.int64)
    qty = li["l_quantity"][m].to(torch.int64)
    price = li["l_extendedprice"][m]
    disc = li["l_discount"][m].to(f64)
    tax = li["l_tax"][m].to(f64)
    # the codes sort as their strings, so (flag, status) code order is ORDER BY's
    uk, inv, cnt = torch.unique(rf * 256 + ls, return_inverse=True, return_counts=True)
    g = uk.shape[0]
    n = cnt.to(torch.float64)
    disc_price = price.to(f64) * (1 - disc)
    charge = disc_price * (1 + tax)
    sum_qty = torch.zeros(g, dtype=torch.int64, device=qty.device).index_add_(0, inv, qty)
    sums = {"sum_base_price": (price, f32), "sum_disc_price": (disc_price, f64),
            "sum_charge": (charge, f64)}
    cols = {"l_returnflag": D.RETURNFLAGS[C.host(uk >> 8)],
            "l_linestatus": D.LINESTATUSES[C.host(uk & 255)],
            "sum_qty": C.host(sum_qty).astype(np.int32)}
    scales = {}
    for name, (x, dt) in sums.items():
        cols[name] = C.host(C.sums(x, inv, g, dt, lower).to(torch.float64))
        scales[name] = (C.host(C.abs_sums(x, inv, g)), "f32" if dt == f32 else "f64")
    means = {"avg_qty": (qty, f32), "avg_price": (price, f32), "avg_disc": (disc, f64)}
    for name, (x, dt) in means.items():
        if lower:
            mean = C.sums(x, inv, g, dt, True) / cnt.to(dt)
        else:
            mean = C.exact_sums(x, inv, g) / n
        cols[name] = C.host(mean.to(torch.float64))
        scales[name] = (C.host(C.abs_sums(x, inv, g) / n), "f32" if dt == f32 else "f64")
    cols["count_order"] = C.host(cnt).astype(np.int32)
    types = {"l_returnflag": "str", "l_linestatus": "str", "sum_qty": "int32",
             "sum_base_price": "float32", "sum_disc_price": "float64", "sum_charge": "float64",
             "avg_qty": "float32", "avg_price": "float32", "avg_disc": "float64",
             "count_order": "int32"}
    return C.Answer({k: cols[k] for k in types}, types, scales)
