"""The generators are deterministic per seed and differ across seeds, and the
plain references agree with the program at a tiny size on the CPU."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from benchmark import distributions as D
from benchmark import tpch_data
from benchmark.drivers import sort_pairs as SP
from benchmark.reference import sort_pairs as R
from benchmark.reference.tpch import common as C
from benchmark.tests.conftest import REPO

TRAFFIC = {"uniform": {"keys": "uniform"}, "zipf": {"keys": "zipf", "key_params": {"s": 1.1}},
           "step": {"keys": "step_uniform", "key_params": {"steps": 1000}}}
QUERIES = sorted(p.stem for p in (REPO / "benchmark" / "queries").glob("*.json"))
SMALL_TPCH = {"orders": 20_000, "customers": 2_000, "lineitems_per_order": [1, 7],
              "special_share": 0.01}


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("kind", sorted(TRAFFIC))
def test_keys_deterministic_and_distinct(kind, dtype):
    a = SP.make_keys(gen(3), 4096, dtype, TRAFFIC[kind])
    b = SP.make_keys(gen(3), 4096, dtype, TRAFFIC[kind])
    c = SP.make_keys(gen(2**31 + 5), 4096, dtype, TRAFFIC[kind])
    assert a.dtype == dtype
    assert torch.equal(a.view(R.SIGNED[dtype]), b.view(R.SIGNED[dtype]))
    assert not torch.equal(a.view(R.SIGNED[dtype]), c.view(R.SIGNED[dtype]))


def test_key_distributions():
    n = 1 << 16
    z = SP.make_keys(gen(1), n, torch.uint64, TRAFFIC["zipf"]).view(torch.int64)
    assert int(torch.unique(z).numel()) < n // 2  # duplicate-heavy
    assert bool((z != 0).all())  # Zipf over [1, 2**64)
    s = SP.make_keys(gen(1), n, torch.uint32, TRAFFIC["step"]).view(torch.int32)
    assert int(torch.unique(s).numel()) == 1000
    u = D.uniform(gen(1), n, torch.uint64).view(torch.int64)
    assert int(torch.unique(u).numel()) == n
    assert bool((u < 0).any()) and bool((u > 0).any())  # the top bit is drawn too


def test_tpch_deterministic_and_distinct():
    a, b = tpch_data.generate(gen(9), SMALL_TPCH), tpch_data.generate(gen(9), SMALL_TPCH)
    c = tpch_data.generate(gen(10), SMALL_TPCH)
    for t in a:
        for k in a[t]:
            assert torch.equal(a[t][k], b[t][k]), k
    assert not torch.equal(a["lineitem"]["l_extendedprice"], c["lineitem"]["l_extendedprice"])
    li = a["lineitem"]
    assert 20_000 <= li["l_orderkey"].numel() <= 7 * 20_000
    assert sorted(np.unique(tpch_data.RETURNFLAGS[li["l_returnflag"].view(torch.int32)])) == \
        ["A", "N", "R"]
    assert int(a["orders"]["o_special"].sum()) < 20_000 // 20


@pytest.mark.parametrize("dtype", [torch.uint32, torch.uint64])
@pytest.mark.parametrize("kind", sorted(TRAFFIC))
def test_sort_reference_matches_program(kind, dtype):
    import radix_sort_tpu_torch as rst

    g = gen(4)
    n = 1 << 20  # uniform u64 keys share their upper half in ~128 pairs
    keys = SP.make_keys(g, n, dtype, TRAFFIC[kind])
    values = D.uniform(g, n, torch.uint64)
    got = rst.sort_pairs(keys, values)
    assert R.mismatched(*got, *R.sort_rows(keys, values)) == 0
    if kind == "step":  # 1000 steps differ in their upper half: no control reading
        return
    # the control, the key at half its width, sorts other rows
    assert R.mismatched(*R.sort_rows(keys, values, key_bits=4 * keys.element_size()),
                        *R.sort_rows(keys, values)) > 0


@pytest.fixture(scope="module")
def tpch_tables():
    import radix_sort_tpu_torch as rst

    raw = tpch_data.generate(gen(11), SMALL_TPCH)
    tables = {name: rst.Table(cols, dictionaries={k: v for k, v in
                                                   tpch_data.DICTIONARIES.items() if k in cols},
                              device="cpu")
              for name, cols in raw.items()}
    return raw, tables


@pytest.mark.parametrize("query", QUERIES)
def test_tpch_reference_matches_program(query, tpch_tables, reg):
    import radix_sort_tpu_torch as rst

    raw, tables = tpch_tables
    q = reg.data("queries", query)
    out, ovf = rst.sql(q["sql"], tables, **q["kw"]).collect(return_overflow=True)
    assert not bool(ovf)
    ans = importlib.import_module(f"benchmark.reference.tpch.{q['answer']}").answer(raw)
    assert len(next(iter(ans.columns.values()))) > 0
    mism, gaps = C.compare(out.to_numpy(), ans)
    assert mism == 0
    assert all(v < 1e-3 for v in gaps.values()), gaps
    lower = importlib.import_module(f"benchmark.reference.tpch.{q['answer']}").answer(
        raw, lower=True).as_result()
    if q["limits"]:  # its float aggregates move in the lower precision
        mism_l, gaps_l = C.compare(lower, ans)
        assert max(gaps_l.values()) > 1e3 * max(max(gaps.values()), 1e-16)


def test_compare_counts_each_kind_of_mismatch():
    ans = C.Answer({"k": np.array([1, 2, 3], np.int32), "s": np.array([10.0, 20.0, 30.0]),
                    "name": np.array(["a", "b", "c"])},
                   {"k": "int32", "s": "float64", "name": "str"},
                   {"s": (np.array([10.0, 20.0, 30.0]), "f64")})
    same = {"k": np.array([1, 2, 3], np.int32), "s": np.array([10.0, 20.0, 30.0]),
            "name": np.array(["a", "b", "c"])}
    assert C.compare(same, ans) == (0, {"f64": 0.0})
    assert C.compare(dict(same, k=np.array([1, 5, 3], np.int32)), ans)[0] == 1
    assert C.compare(dict(same, k=np.array([1, 2, 3], np.int64)), ans)[0] == 3  # dtype
    assert C.compare(dict(same, k=np.array([1, 2], np.int32)), ans)[0] == 1  # a row short
    assert C.compare(dict(same, name=np.array(["a", "x", "c"])), ans)[0] == 1
    assert C.compare(dict(same, extra=np.zeros(3)), ans)[0] == 3
    assert C.compare({k: v for k, v in same.items() if k != "name"}, ans)[0] == 3
    mism, gaps = C.compare(dict(same, s=np.array([10.0, 21.0, np.nan])), ans)
    assert mism == 0 and gaps["f64"] == C.BIG
    assert C.compare(dict(same, s=np.array([10.0, 21.0, 30.0])), ans)[1]["f64"] == 1 / 20
