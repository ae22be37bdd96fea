"""Port parity: sql.py, on the CPU.

Each case compiles the same SQL text in both packages over the same seeded
numpy tables (the JAX package's ``Table`` and the port's
``Table(..., device="cpu")``), requires the same ``explain()`` text and the
same result: column names and order, dtypes, values (floats by their bits),
NULL masks and the row count. Float aggregates may differ by summation order
only: within (n - 1) * u of their value, all summed values being positive
(u the column type's unit roundoff, n <= N rows a group); transcendental
functions within 2 ULP. The families follow ``tests/test_sql.py``. The ASOF
qualifier and the rename-shadow cases are held to a numpy oracle (the JAX
package's behaviour there is a recorded fault), and small TPC-H Q1, Q3, Q13
and Q18 run as SQL against the port's own ``Table`` pipeline too.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from radix_sort_tpu.sql import SqlError as JSqlError  # noqa: E402
from radix_sort_tpu.sql import sql as jsql  # noqa: E402
from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu_torch import SqlError as TSqlError  # noqa: E402
from radix_sort_tpu_torch import col, sql as tsql  # noqa: E402
from radix_sort_tpu_torch.table import Table as TTable  # noqa: E402
from test_torch_table import same  # noqa: E402

N = 64
U32 = 2.0 ** -24
U64 = 2.0 ** -53
F32_SUM = (N - 1) * U32  # relative bound of a float32 sum of <= N positive values


def _db(seed=7):
    rng = np.random.default_rng(seed)
    orders = {
        "oid": np.arange(N, dtype=np.uint32),
        "cust": rng.integers(0, 8, N).astype(np.uint32),
        "item": rng.choice(["bolt", "nut", "gear", "cam"], size=N),
        "qty": rng.integers(1, 20, N).astype(np.int32),
        "price": (rng.random(N) * 9 + 1).astype(np.float32),
        "day": np.datetime64("2024-01-01") + rng.integers(0, 90, N).astype("timedelta64[D]"),
        "bonus": np.ma.MaskedArray(rng.integers(-5, 5, N).astype(np.int32),
                                   rng.random(N) < 0.25),
        "note": [None if r < 0.3 else w for r, w in
                 zip(rng.random(N), rng.choice(["ok", "late", "lost"], N))],
    }
    custs = {
        "cust": np.arange(8, dtype=np.uint32),
        "region": np.array(["north", "south"] * 4),
        "seg": np.array(["A", "B", "C", "A", "B", "C", "A", "B"]),
    }
    two_a = {"k": np.array([1, 2, 3, 4, 5], np.uint32), "s": ["a", "b", "c", "b", "a"]}
    two_b = {"k": np.array([3, 4, 5, 6, 7], np.uint32), "s": ["c", "x", "a", "y", "z"]}
    tree = {"id": np.arange(8, dtype=np.int32),
            "par": np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32),
            "v": np.arange(8, dtype=np.int32) * 10}
    nt = {"k": np.ma.MaskedArray([3, 1, 2, 9, 5], [False, True, False, True, False]),
          "v": np.arange(5, dtype=np.int32)}
    t5 = {"k": np.array([1, 2, 3, 2, 1], np.int32),
          "v": np.array([10., 20., 30., 40., 50.], np.float32)}
    tiers = {"lo": np.array([0, 5, 10], np.int32), "hi": np.array([4, 9, 19], np.int32),
             "tier": np.array(["low", "mid", "high"])}
    return {"orders": orders, "custs": custs, "t1": two_a, "t2": two_b, "tree": tree,
            "nt": nt, "t5": t5, "tiers": tiers}


DB = _db()


def _tables(names, db=DB):
    jt = {n: JTable(db[n]) for n in names}
    tt = {n: TTable(db[n], device="cpu") for n in names}
    return jt, tt


def parity(q, names, float_cols=(), rtol=0.0, **kw):
    jt, tt = _tables(names)
    jl, tl = jsql(q, jt, **kw), tsql(q, tt, **kw)
    assert tl.explain() == jl.explain()
    same(jl.collect(), tl.collect(), float_cols=float_cols, rtol=rtol)


O, OC = ("orders",), ("orders", "custs")
CASES = {
    # SELECT, WHERE, CASE
    "select_where_order_limit": ("SELECT oid, qty FROM orders WHERE qty >= 10 "
                                 "ORDER BY qty DESC, oid ASC LIMIT 5", O),
    "computed_and_case": ("SELECT oid, qty * 2 + 1 AS qq, price * 2.5 AS p25, "
                          "qty / 4 AS q4, qty * 2.5 AS qf, "
                          "CASE WHEN qty >= 10 THEN 1 ELSE 0 END AS big, "
                          "CASE WHEN qty > 15 THEN 'hi' WHEN qty > 5 THEN 'mid' END AS band "
                          "FROM orders", O),
    "string_predicates": ("SELECT oid FROM orders WHERE item = 'gear' OR item < 'cam' "
                          "OR item >= 'nut'", O),
    "in_between_not_like": ("SELECT oid, item FROM orders WHERE item IN ('nut', 'cam') "
                            "AND qty NOT BETWEEN 5 AND 15 OR item LIKE '%e%' "
                            "AND item NOT LIKE 'g__r'", O),
    "nulls_and_coalesce": ("SELECT oid, bonus, COALESCE(bonus, 0) AS b0, "
                           "NULLIF(qty, 3) AS nq, IFNULL(note, 'none') AS nn, "
                           "bonus IS NULL AS bn, note IS NOT NULL AS has "
                           "FROM orders WHERE bonus + qty > 3 OR bonus IS NULL", O),
    "string_functions": ("SELECT oid, UPPER(item) AS u, LENGTH(item) AS n, "
                         "item || '-' || note AS cat, SUBSTR(item, 2, 2) AS sub "
                         "FROM orders WHERE note IS NOT NULL", O),
    "date_functions": ("SELECT oid, day, YEAR(day) AS y, MONTH(day) AS m, "
                       "DAYOFWEEK(day) AS w, DATE_TRUNC('month', day) AS t, "
                       "day + INTERVAL 1 MONTH AS nxt FROM orders "
                       "WHERE day >= DATE '2024-02-01' AND day < DATE '2024-03-15'", O),
    "scalar_math_exact": ("SELECT FLOOR(price) AS f, CEILING(price) AS c, ROUND(price) AS r, "
                          "ROUND(price, 1) AS r1, SIGN(price - 5) AS s, SQRT(price) AS sq, "
                          "ABS(bonus) AS ab, POWER(qty, 2) AS p2, MOD(qty, 3) AS m, "
                          "LEAST(qty, 5, 7) AS lo, GREATEST(qty, 5, 7) AS hi, "
                          "CAST(qty AS DOUBLE) / 3 AS d3, CAST(price AS INT) AS pi "
                          "FROM orders", O),
    "distinct": ("SELECT DISTINCT item FROM orders", O),
    "limit_offset_topk": ("SELECT qty FROM orders ORDER BY qty LIMIT 7 OFFSET 5", O),
    "limit_offset_plain": ("SELECT oid FROM orders LIMIT 4 OFFSET 50", O),
    "limit_past_end": ("SELECT oid FROM orders ORDER BY oid LIMIT 5 OFFSET 300", O),
    # GROUP BY, HAVING, GROUP BY ALL
    "group_by_having": ("SELECT item, SUM(qty) AS total, COUNT(*) AS n, MIN(price) AS lo "
                        "FROM orders GROUP BY item HAVING total >= 0 ORDER BY item", O),
    "global_aggregate": ("SELECT SUM(qty) AS s, COUNT(DISTINCT cust) AS nc, "
                         "COUNT(bonus) AS nb, MAX(bonus) AS mb FROM orders", O),
    "having_inline": ("SELECT cust, COUNT(*) AS n FROM orders GROUP BY cust "
                      "HAVING SUM(qty) > 60 AND MIN(price) < 5", O),
    "expression_aggregates": ("SELECT item, SUM(price * qty) AS rev, AVG(price) AS ap "
                              "FROM orders GROUP BY item ORDER BY item", O),
    "computed_group_keys": ("SELECT qty % 5 AS r, COUNT(*) AS n, SUM(qty) AS s "
                            "FROM orders GROUP BY r ORDER BY r", O),
    "quantile_string_minmax": ("SELECT cust, QUANTILE(qty, 0.9) AS q90, MEDIAN(qty) AS md, "
                               "MIN(item) AS lo, MAX(item) AS hi "
                               "FROM orders GROUP BY cust ORDER BY cust", O),
    "group_by_all": ("SELECT cust, item, SUM(qty) AS s FROM orders GROUP BY ALL "
                     "ORDER BY ALL", O),
    "order_by_all_desc": ("SELECT cust, qty FROM orders ORDER BY ALL DESC LIMIT 6", O),
    # window clauses
    "window_running": ("SELECT oid, cust, ROW_NUMBER() OVER (PARTITION BY cust ORDER BY oid) "
                       "AS rn, SUM(qty) OVER (PARTITION BY cust ORDER BY oid) AS run, "
                       "SUM(qty) OVER (PARTITION BY cust) AS tot FROM orders", O),
    "window_frames": ("SELECT oid, SUM(qty) OVER (ORDER BY oid ROWS BETWEEN 2 PRECEDING "
                      "AND CURRENT ROW) AS roll, LAG(qty, 1, -1) OVER (ORDER BY oid) AS prev, "
                      "RANK() OVER (ORDER BY qty DESC) AS rk, "
                      "FIRST_VALUE(qty) OVER (PARTITION BY item ORDER BY oid) AS fv, "
                      "COUNT(*) OVER (PARTITION BY item) AS cnt FROM orders", O),
    "window_range": ("SELECT oid, SUM(qty) OVER (ORDER BY day RANGE BETWEEN "
                     "INTERVAL 7 DAY PRECEDING AND CURRENT ROW) AS wk FROM orders", O),
    "window_over_group": ("SELECT cust, SUM(qty) AS s, RANK() OVER (ORDER BY SUM(qty) DESC) "
                          "AS rk, LAG(SUM(qty), 1, 0) OVER (ORDER BY cust) AS prev "
                          "FROM orders GROUP BY cust ORDER BY cust", O),
    # ROLLUP / CUBE / GROUPING SETS
    "rollup": ("SELECT cust, item, SUM(qty) AS s, COUNT(*) AS n, GROUPING(item) AS gi "
               "FROM orders GROUP BY ROLLUP (cust, item) ORDER BY cust, item", O),
    "cube": ("SELECT item, cust, COUNT(*) AS n FROM orders GROUP BY CUBE (item, cust)", O),
    "grouping_sets": ("SELECT item, cust, SUM(qty) AS s FROM orders "
                      "GROUP BY GROUPING SETS ((item), (cust), ())", O),
    # set operations, derived tables
    "union": ("SELECT k FROM t1 UNION SELECT k FROM t2", ("t1", "t2")),
    "union_all": ("SELECT k, s FROM t1 UNION ALL SELECT k, s FROM t2", ("t1", "t2")),
    "intersect_except": ("SELECT s FROM t1 INTERSECT SELECT s FROM t2 UNION "
                         "(SELECT s FROM t1 EXCEPT SELECT s FROM t2)", ("t1", "t2")),
    "compound_order_limit": ("SELECT k FROM t1 UNION SELECT k FROM t2 ORDER BY k DESC "
                             "LIMIT 3", ("t1", "t2")),
    "derived_tables": ("SELECT s, COUNT(*) AS n FROM t1 JOIN (SELECT k FROM t2 WHERE k <= 5) "
                       "sub ON k = k GROUP BY s ORDER BY s", ("t1", "t2"), (), 0.0,
                       {"capacity": 16}),
    # joins: ON, USING, band, CROSS, self join
    "inner_join_group": ("SELECT region, SUM(qty) AS total FROM orders JOIN custs "
                         "ON orders.cust = custs.cust GROUP BY region ORDER BY region",
                         OC, (), 0.0, {"capacity": 2 * N, "max_groups": 8}),
    "left_join_filter": ("SELECT oid, region, seg FROM orders LEFT JOIN custs USING (cust) "
                         "WHERE qty > 12 ORDER BY oid", OC, (), 0.0, {"capacity": 2 * N}),
    "join_rows_no_aggregate": ("SELECT oid, price, region FROM custs JOIN orders "
                               "ON custs.cust = orders.cust WHERE seg = 'A'", OC, (), 0.0,
                               {"capacity": 2 * N}),
    "right_full_joins": ("SELECT k, s, tier FROM t1 RIGHT JOIN (SELECT k, tier FROM t2 "
                         "CROSS JOIN tiers WHERE lo = 5) x USING (k) ORDER BY k",
                         ("t1", "t2", "tiers"), (), 0.0, {"capacity": 16}),
    "full_join": ("SELECT k, s, s_r FROM t1 FULL JOIN t2 USING (k) ORDER BY k", ("t1", "t2"),
                  (), 0.0, {"capacity": 16}),
    "semi_anti_keywords": ("SELECT oid FROM orders SEMI JOIN custs ON orders.cust = custs.cust "
                           "WHERE qty > 10 UNION ALL SELECT oid FROM orders ANTI JOIN "
                           "(SELECT cust FROM custs WHERE seg = 'A') a ON orders.cust = a.cust",
                           OC),
    "not_exists": ("SELECT oid FROM orders WHERE NOT EXISTS (SELECT cust FROM custs "
                   "WHERE seg = 'Z')", OC),
    "band_join": ("SELECT oid, qty, tier FROM orders JOIN tiers ON qty BETWEEN lo AND hi "
                  "ORDER BY oid", ("orders", "tiers"), (), 0.0, {"capacity": 2 * N}),
    "band_conjunct": ("SELECT oid, tier FROM orders LEFT JOIN tiers ON qty >= lo "
                      "ORDER BY oid", ("orders", "tiers"), (), 0.0, {"capacity": 4 * N}),
    "cross_join": ("SELECT k, tier FROM t1 CROSS JOIN tiers", ("t1", "tiers"), (), 0.0,
                   {"capacity": 16}),
    "self_join_alias": ("SELECT id, par, v, v_r FROM tree c JOIN tree p ON c.par = p.id "
                        "ORDER BY id", ("tree",), (), 0.0, {"capacity": 16}),
    # IN / EXISTS, CTEs, scalar subqueries
    "in_subquery": ("SELECT oid, cust FROM orders WHERE cust IN "
                    "(SELECT cust FROM custs WHERE region = 'north')", OC),
    "not_in_subquery": ("SELECT oid FROM orders WHERE qty NOT IN "
                        "(SELECT qty FROM orders WHERE qty >= 10) AND oid < 40", O),
    "having_in": ("SELECT cust, SUM(qty) AS s FROM orders GROUP BY cust "
                  "HAVING cust IN (SELECT cust FROM custs WHERE region = 'south')", OC),
    "exists": ("SELECT oid FROM orders WHERE EXISTS (SELECT cust FROM custs "
               "WHERE seg = 'C')", OC),
    "ctes": ("WITH big AS (SELECT cust, qty FROM orders WHERE qty > 10), "
             "agg AS (SELECT cust, COUNT(*) AS n FROM big GROUP BY cust) "
             "SELECT cust, n FROM agg ORDER BY cust", O),
    "scalar_subqueries": ("SELECT oid, qty - (SELECT MIN(qty) FROM orders) AS rel FROM orders "
                          "WHERE qty > (SELECT AVG(qty) FROM orders)", O),
    # NULLS FIRST / LAST, simple CASE, IS DISTINCT FROM, percentiles
    "nulls_first": ("SELECT v FROM nt ORDER BY k NULLS FIRST LIMIT 3", ("nt",)),
    "nulls_desc": ("SELECT v, k FROM nt ORDER BY k DESC", ("nt",)),
    "simple_case": ("SELECT CASE k WHEN 1 THEN 10 WHEN 2 THEN 20 ELSE 0 END AS c "
                    "FROM t5", ("t5",)),
    "count_distinct_expr": ("SELECT COUNT(DISTINCT k % 2) AS n FROM t5", ("t5",)),
    "is_distinct_from": ("SELECT v FROM t5 WHERE k IS DISTINCT FROM 2", ("t5",)),
    "percentile_cont": ("SELECT k, PERCENTILE_CONT(v, 0.25) AS p, PERCENTILE_DISC(v, 0.25) "
                        "AS d FROM t5 GROUP BY k ORDER BY k", ("t5",)),
    "percentile_cont_global": ("SELECT PERCENTILE_CONT(price, 0.7) AS p FROM orders", O),
}


def _case(spec):
    q, names, *rest = spec
    float_cols, rtol, kw = rest if rest else ((), 0.0, {})
    return q, names, float_cols, rtol, kw


FLOATS = {"expression_aggregates": (("rev", "ap"), F32_SUM)}


@pytest.mark.parametrize("name", list(CASES))
def test_query_matches_reference(name):
    q, names, float_cols, rtol, kw = _case(CASES[name])
    if name in FLOATS:
        float_cols, rtol = FLOATS[name]
    parity(q, names, float_cols=float_cols, rtol=rtol, **kw)


def test_transcendental_functions_within_two_ulp():
    q = ("SELECT EXP(0 - price) AS e, LN(price) AS l, LOG10(price) AS l10, "
         "LOG2(price) AS l2, POWER(price, 1.5) AS p FROM orders")
    parity(q, O, float_cols=("e", "l", "l10", "l2", "p"), rtol=2 * 2.0 ** -23)


@pytest.mark.parametrize("q", [
    "SELECT cust, SUM(qty) AS total FROM orders WHERE qty > 5 GROUP BY cust",
    "SELECT oid, price FROM orders WHERE qty > 3 ORDER BY price DESC LIMIT 4",
])
def test_unoptimized_plan_matches(q):
    jt, tt = _tables(O)
    jl, tl = jsql(q, jt), tsql(q, tt)
    assert tl.explain(optimize_plan=False) == jl.explain(optimize_plan=False)
    same(jl.collect(optimize_plan=False), tl.collect(optimize_plan=False))
    same(tl.collect(), tl.collect(optimize_plan=False))


@pytest.mark.parametrize("q,match", [
    ("SELECT FROM orders", None),
    ("SELECT oid FROM nope", "unknown table"),
    ("SELECT item + 1 AS x FROM orders", None),
    ("SELECT k FROM t1 UNION SELECT k, s FROM t2", "same column names"),
    ("SELECT oid FROM orders WHERE qty > (SELECT oid, qty FROM orders)", "exactly one"),
    ("SELECT COUNT(*) AS n FROM orders GROUP BY ALL", "no plain"),
    ("SELECT cust AS c, COUNT(*) AS n FROM orders GROUP BY ALL", None),
    ("SELECT v FROM nt ORDER BY k NULLS MAYBE", "FIRST or LAST"),
    ("SELECT SUM(price * qty) FROM orders GROUP BY cust", None),
])
def test_errors_match_reference(q, match):
    jt, tt = _tables(("orders", "t1", "t2", "nt"))
    errs = []
    for run, tabs in ((jsql, jt), (tsql, tt)):
        with pytest.raises((JSqlError, TSqlError, TypeError)) as info:
            run(q, tabs).collect()
        errs.append(info.value)
    assert type(errs[0]).__name__ == type(errs[1]).__name__
    assert str(errs[0]) == str(errs[1])
    if match is not None:
        assert match in str(errs[1])


# ---- ASOF and the rename shadow, against a numpy oracle


def _asof_oracle(lt, rt, rv, direction):
    """The nearest right value at-or-before (backward) / at-or-after
    (forward) each left key, or None."""
    out = []
    for t in lt:
        ok = rt <= t if direction == "backward" else rt >= t
        if not ok.any():
            out.append(None)
            continue
        cand = np.flatnonzero(ok)
        pick = cand[np.argmax(rt[cand])] if direction == "backward" else cand[np.argmin(rt[cand])]
        out.append(rv[pick])
    return out


def _asof_tables(rng):
    a = {"t": rng.integers(0, 100, 30).astype(np.int32), "x": np.arange(30, dtype=np.int32)}
    rt = np.unique(rng.integers(0, 100, 12).astype(np.int32))
    b = {"t": rt, "y": (np.arange(rt.size, dtype=np.int32) + 1) * 10}
    return a, b


@pytest.mark.parametrize("on,direction", [
    ("a.t >= b.t", "backward"),
    ("b.t <= a.t", "backward"),
    ("a.t <= b.t", "forward"),
    ("b.t >= a.t", "forward"),
])
def test_asof_qualifier_chooses_the_side(on, direction):
    a, b = _asof_tables(np.random.default_rng(3))
    out = tsql(f"SELECT x, y FROM a ASOF LEFT JOIN b ON {on}",
               {"a": TTable(a, device="cpu"), "b": TTable(b, device="cpu")}
               ).collect().to_numpy()
    want = _asof_oracle(a["t"], b["t"], b["y"], direction)
    np.testing.assert_array_equal(out["x"], a["x"])
    np.testing.assert_array_equal(out["y"], [0 if v is None else v for v in want])


def test_asof_aliases_and_errors():
    a, b = _asof_tables(np.random.default_rng(4))
    tabs = {"a": TTable(a, device="cpu"), "b": TTable(b, device="cpu")}
    out = tsql("SELECT x, y FROM a AS l ASOF JOIN b AS r ON r.t <= l.t",
               tabs).collect().to_numpy()
    want = _asof_oracle(a["t"], b["t"], b["y"], "backward")
    keep = [i for i, v in enumerate(want) if v is not None]
    np.testing.assert_array_equal(out["x"], a["x"][keep])
    np.testing.assert_array_equal(out["y"], [want[i] for i in keep])
    with pytest.raises(TSqlError, match="on both sides; qualify"):
        tsql("SELECT x, y FROM a ASOF JOIN b ON t >= t", tabs)
    with pytest.raises(TSqlError, match="names neither side"):
        tsql("SELECT x, y FROM a ASOF JOIN b ON c.t >= b.t", tabs)
    with pytest.raises(TSqlError, match="one side must name a left"):
        tsql("SELECT x, y FROM a ASOF JOIN b ON b.t >= b.y", tabs)


def test_asof_rename_shadow_raises():
    rng = np.random.default_rng(5)
    a = {"t": rng.integers(0, 50, 10).astype(np.int32), "x": np.arange(10, dtype=np.int32)}
    b = {"qt": np.array([3, 20, 40], np.int32), "t": np.array([7, 8, 9], np.int32)}
    tabs = {"a": TTable(a, device="cpu"), "b": TTable(b, device="cpu")}
    with pytest.raises(TSqlError, match="shadow the right column 't'"):
        tsql("SELECT x FROM a ASOF JOIN b ON a.t >= b.qt", tabs)
    # without the clash the differently named key renames onto the left's
    out = tsql("SELECT x, px FROM a ASOF LEFT JOIN c ON a.t >= c.qt",
               {"a": tabs["a"], "c": TTable({"qt": b["qt"], "px": b["t"]}, device="cpu")}
               ).collect().to_numpy()
    want = _asof_oracle(a["t"], b["qt"], b["t"], "backward")
    np.testing.assert_array_equal(out["px"], [0 if v is None else v for v in want])


def test_asof_unambiguous_matches_reference():
    a, b = _asof_tables(np.random.default_rng(6))
    b = {"qt": b["t"], "y": b["y"]}
    q = "SELECT t, x, y FROM a ASOF JOIN b ON qt <= t"
    jt = {"a": JTable(a), "b": JTable(b)}
    tt = {"a": TTable(a, device="cpu"), "b": TTable(b, device="cpu")}
    same(jsql(q, jt).collect(), tsql(q, tt).collect())


# ---- small TPC-H queries as SQL text


def _tpch(rng, n_orders=40, n_cust=12):
    per = rng.integers(1, 4, n_orders)
    okeys = rng.permutation(np.arange(1, 4 * n_orders, 4))[:n_orders].astype(np.int32)
    n = int(per.sum())
    lineitem = {
        "l_orderkey": np.repeat(okeys, per),
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.random(n) * 1000 + 900, 2),
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_tax": rng.integers(0, 9, n) / 100.0,
        "l_returnflag": rng.choice(["A", "N", "R"], n),
        "l_linestatus": rng.choice(["F", "O"], n),
        "l_shipdate": np.datetime64("1995-01-01") + rng.integers(0, 300, n).astype("timedelta64[D]"),
    }
    orders = {
        "o_orderkey": okeys,
        "o_custkey": rng.integers(0, n_cust, n_orders).astype(np.int32),
        "o_orderdate": np.datetime64("1995-01-01") + rng.integers(0, 200, n_orders).astype("timedelta64[D]"),
        "o_shippriority": np.zeros(n_orders, np.int32),
        "o_totalprice": np.round(rng.random(n_orders) * 5000, 2),
        "o_special": rng.random(n_orders) < 0.1,
    }
    customer = {
        "c_custkey": np.arange(n_cust + 3, dtype=np.int32),
        "c_mktsegment": rng.choice(["BUILDING", "MACHINERY", "AUTOMOBILE"], n_cust + 3),
    }
    return {"lineitem": lineitem, "orders": orders, "customer": customer}


Q1 = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
      "SUM(l_extendedprice) AS sum_base_price, "
      "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
      "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
      "AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price, "
      "AVG(l_discount) AS avg_disc, COUNT(*) AS count_order FROM lineitem "
      "WHERE l_shipdate <= DATE '1995-09-02' GROUP BY l_returnflag, l_linestatus "
      "ORDER BY l_returnflag, l_linestatus")
# the join renames the right key onto the left's name: l_orderkey is o_orderkey
Q3 = ("SELECT o_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
      "o_orderdate, o_shippriority FROM customer "
      "JOIN orders ON c_custkey = o_custkey JOIN lineitem ON o_orderkey = l_orderkey "
      "WHERE c_mktsegment = 'BUILDING' AND o_orderdate < DATE '1995-04-15' "
      "AND l_shipdate > DATE '1995-04-15' "
      "GROUP BY o_orderkey, o_orderdate, o_shippriority "
      "ORDER BY revenue DESC, o_orderdate LIMIT 10")
Q13 = ("SELECT c_count, COUNT(*) AS custdist FROM "
       "(SELECT c_custkey, COUNT(o_orderkey) AS c_count FROM customer "
       "LEFT OUTER JOIN (SELECT o_orderkey, o_custkey FROM orders WHERE NOT o_special) o "
       "ON c_custkey = o_custkey GROUP BY c_custkey) c_orders "
       "GROUP BY c_count ORDER BY custdist DESC, c_count DESC")
Q18 = ("SELECT c_custkey, o_orderkey, o_orderdate, o_totalprice, "
       "SUM(l_quantity) AS sum_qty FROM customer "
       "JOIN orders ON c_custkey = o_custkey JOIN lineitem ON o_orderkey = l_orderkey "
       "WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey "
       "HAVING SUM(l_quantity) > 100) "
       "GROUP BY c_custkey, o_orderkey, o_orderdate, o_totalprice "
       "ORDER BY o_totalprice DESC, o_orderdate LIMIT 100")
TPCH_KW = {"capacity": 128}


def _day(s):
    return int(np.datetime64(s, "D").astype(int))


def _q1_pipeline(t):
    li = t["lineitem"]
    f = li.filter(col("l_shipdate") <= _day("1995-09-02"))
    f = f.with_columns(disc_price=col("l_extendedprice") * (1 - col("l_discount")))
    f = f.with_columns(charge=col("disc_price") * (1 + col("l_tax")))
    out = f.aggregate(["l_returnflag", "l_linestatus"], {
        "sum_qty": ("sum", "l_quantity"), "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", "disc_price"), "sum_charge": ("sum", "charge"),
        "avg_qty": ("mean", "l_quantity"), "avg_price": ("mean", "l_extendedprice"),
        "avg_disc": ("mean", "l_discount"), "count_order": "count"})
    return out.sort_by(["l_returnflag", "l_linestatus"])


def _q3_pipeline(t):
    cap = TPCH_KW["capacity"]
    c = t["customer"].filter(col("c_mktsegment") == "BUILDING")
    o = t["orders"].filter(col("o_orderdate") < _day("1995-04-15")).select(
        "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority").rename(
        {"o_custkey": "c_custkey"})
    co, _ = c.join(o, "c_custkey", capacity=cap)
    li = t["lineitem"].filter(col("l_shipdate") > _day("1995-04-15")).select(
        "l_orderkey", "l_extendedprice", "l_discount").rename({"l_orderkey": "o_orderkey"})
    rows, _ = co.join(li, "o_orderkey", capacity=cap)
    rows = rows.with_columns(rev=col("l_extendedprice") * (1 - col("l_discount")))
    agg = rows.aggregate(["o_orderkey", "o_orderdate", "o_shippriority"],
                         {"revenue": ("sum", "rev")})
    return agg.sort_by(["revenue", "o_orderdate"], descending=[True, False]).limit(10)


def _q13_pipeline(t):
    o = t["orders"].filter(~col("o_special")).select("o_orderkey", "o_custkey").rename(
        {"o_custkey": "c_custkey"})
    co, _ = t["customer"].join(o, "c_custkey", how="left", capacity=TPCH_KW["capacity"])
    per = co.aggregate("c_custkey", {"c_count": ("count", "o_orderkey")})
    return per.aggregate("c_count", {"custdist": "count"}).sort_by(
        ["custdist", "c_count"], descending=True)


def _q18_pipeline(t):
    cap = TPCH_KW["capacity"]
    li = t["lineitem"].select("l_orderkey", "l_quantity")
    big = li.aggregate("l_orderkey", {"s": ("sum", "l_quantity")}).filter(
        col("s") > 100).select("l_orderkey").rename({"l_orderkey": "o_orderkey"})
    o = t["orders"].select("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice").rename(
        {"o_custkey": "c_custkey"})
    co, _ = t["customer"].select("c_custkey").join(o, "c_custkey", capacity=cap)
    rows, _ = co.join(li.rename({"l_orderkey": "o_orderkey"}), "o_orderkey", capacity=cap)
    rows, _ = rows.join(big, "o_orderkey", how="semi")
    agg = rows.aggregate(["c_custkey", "o_orderkey", "o_orderdate", "o_totalprice"],
                         {"sum_qty": ("sum", "l_quantity")})
    return agg.sort_by(["o_totalprice", "o_orderdate"], descending=[True, False]).limit(100)


PIPELINES = {"q1": _q1_pipeline, "q3": _q3_pipeline, "q13": _q13_pipeline,
             "q18": _q18_pipeline}
Q_FLOATS = {
    "q1": ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
           "avg_price", "avg_disc"),
    "q3": ("revenue",),
    "q13": (),
    "q18": ("sum_qty",),
}


@pytest.mark.parametrize("name,q", [("q1", Q1), ("q3", Q3), ("q13", Q13), ("q18", Q18)],
                         ids=["q1", "q3", "q13", "q18"])
def test_tpch_as_sql(name, q):
    db = _tpch(np.random.default_rng(11))
    jt, tt = _tables(tuple(db), db)
    jl, tl = jsql(q, jt, **TPCH_KW), tsql(q, tt, **TPCH_KW)
    assert tl.explain() == jl.explain()
    # every value is positive: a float sum agrees to (n - 1) * u, n < 200
    got = tl.collect()
    same(jl.collect(), got, float_cols=Q_FLOATS[name], rtol=200 * U64)
    same(got, tl.collect(optimize_plan=False), float_cols=Q_FLOATS[name], rtol=200 * U64)
    same(got, PIPELINES[name](tt).select(*got.column_names),
         float_cols=Q_FLOATS[name], rtol=200 * U64)
