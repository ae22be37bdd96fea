"""TPC-H LINEITEM, ORDERS and CUSTOMER (specification v3, clause 4.2.3),
made on the device from a ``torch.Generator``, rows in random order.

A frozen copy of the generator the port's chip check drives
(``tpch_sf10`` and ``facade_tables``), cut down to these three tables.
Departures from dbgen: O_COMMENT's Q13 predicate NOT LIKE
'%special%requests%' is a seeded flag (``o_special``); C_MKTSEGMENT is a
uniform code into its dictionary; L_EXTENDEDPRICE is L_QUANTITY times a
drawn retail price; decimals are float32 (L_EXTENDEDPRICE) or float64;
dates are int32 days since 1970-01-01; flags and segments are uint32 codes
into sorted dictionaries whose entry 0 is ``""``.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch


def days(y, m, d) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


# 4.2.3: STARTDATE, ENDDATE, CURRENTDATE
STARTDATE, ENDDATE, CURRENTDATE = days(1992, 1, 1), days(1998, 12, 31), days(1995, 6, 17)
RETURNFLAGS = np.array(["", "A", "N", "R"])
LINESTATUSES = np.array(["", "F", "O"])
SEGMENTS = np.array(["", "AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"])
DICTIONARIES = {"l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUSES,
                "c_mktsegment": SEGMENTS}


def _codes(chars, vocab):
    """uint8 character codes -> uint32 codes into ``vocab``."""
    lut = torch.zeros(256, dtype=torch.int32, device=chars.device)
    for i, v in enumerate(vocab[1:], 1):
        lut[ord(v)] = i
    return lut[chars.to(torch.int64)].view(torch.uint32)


def generate(gen: torch.Generator, cfg: dict) -> dict:
    """{table name: {column name: tensor}} on ``gen``'s device. ``cfg``
    gives ``orders``, ``customers``, ``lineitems_per_order`` ([lo, hi]) and
    ``special_share`` (the share of orders Q13's predicate drops)."""
    dev = gen.device
    n_orders, n_customers = cfg["orders"], cfg["customers"]

    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    i = torch.arange(n_orders, dtype=torch.int64, device=dev)
    orderkey = (i // 8) * 32 + i % 8 + 1  # sparse keys: 8 of every 32 used
    # O_CUSTKEY: uniform over the customers whose key is not a multiple of 3
    u = draw(0, n_customers * 2 // 3, n_orders)
    custkey = 3 * (u // 2) + 1 + u % 2
    totalprice = draw(85_771, 55_528_517, n_orders).to(torch.float64) / 100
    lo, hi = cfg["lineitems_per_order"]
    per_order = draw(lo, hi + 1, n_orders)
    l_orderkey = torch.repeat_interleave(orderkey, per_order)
    n_li = l_orderkey.shape[0]
    quantity = draw(1, 51, n_li)
    retail = (90_000 + draw(0, 110_001, n_li)) / 100
    extendedprice = (quantity * retail).to(torch.float32)
    o_perm = torch.randperm(n_orders, generator=gen, device=dev)
    l_perm = torch.randperm(n_li, generator=gen, device=dev)
    c_perm = torch.randperm(n_customers, generator=gen, device=dev)
    orderdate = draw(STARTDATE, ENDDATE - 151 + 1, n_orders).to(torch.int32)
    order_of = torch.repeat_interleave(torch.arange(n_orders, device=dev), per_order)
    shipdate = orderdate[order_of] + draw(1, 122, n_li).to(torch.int32)
    receiptdate = shipdate + draw(1, 31, n_li).to(torch.int32)
    del order_of
    returned = torch.where(draw(0, 2, n_li) == 0, ord("R"), ord("A"))
    returnflag = torch.where(receiptdate <= CURRENTDATE, returned, ord("N")).to(torch.uint8)
    linestatus = torch.where(shipdate > CURRENTDATE, ord("O"), ord("F")).to(torch.uint8)
    del returned, receiptdate
    discount = draw(0, 11, n_li).to(torch.float64) / 100
    tax = draw(0, 9, n_li).to(torch.float64) / 100
    segment = draw(1, len(SEGMENTS), n_customers).to(torch.int32).view(torch.uint32)
    special = torch.rand(n_orders, generator=gen, device=dev) < cfg["special_share"]
    return {
        "lineitem": {
            "l_orderkey": l_orderkey[l_perm].to(torch.int32).view(torch.uint32),
            "l_returnflag": _codes(returnflag[l_perm], RETURNFLAGS),
            "l_linestatus": _codes(linestatus[l_perm], LINESTATUSES),
            "l_quantity": quantity[l_perm].to(torch.int32),
            "l_extendedprice": extendedprice[l_perm],
            "l_discount": discount[l_perm],
            "l_tax": tax[l_perm],
            "l_shipdate": shipdate[l_perm],
        },
        "orders": {
            "o_orderkey": orderkey[o_perm].to(torch.int32).view(torch.uint32),
            "o_custkey": custkey[o_perm],
            "o_orderdate": orderdate[o_perm],
            "o_totalprice": totalprice[o_perm],
            "o_shippriority": torch.zeros(n_orders, dtype=torch.int32, device=dev),
            "o_special": special,
        },
        "customer": {"c_custkey": c_perm + 1, "c_mktsegment": segment},
    }
