"""Port parity: SQL, strings and band joins over DistTable
(parallel/dist_table.py through plan.py and sql.py).

The companion of ``test_torch_dist_table.py`` (whose helpers it uses): the
same 4-slot CPU mesh and the same comparisons against the JAX package's
single-device ``Table`` and ``sql`` on the same seeded numpy columns. SQL
text over DistTable sources runs the planner's distributed plan (the
eager-aggregation rewrite's broadcast lookup join, the fused WHERE,
ROLLUP's re-aggregation) and must give the rows the JAX package gives over
Tables: integers, strings, dates and NULL masks exact, float sums within
the tolerance each test states.
"""

import numpy as np
import pytest

pytest.importorskip("jax")


import radix_sort_tpu as jrst  # noqa: E402
import radix_sort_tpu_torch as trst  # noqa: E402
from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu_torch.parallel import runtime  # noqa: E402
from radix_sort_tpu_torch.parallel.dist_table import DistTable  # noqa: E402
from radix_sort_tpu_torch.table import Table as TTable  # noqa: E402
from test_torch_dist_table import BIG, N, P, WORDS, pair, same  # noqa: E402


@pytest.fixture
def mesh():
    return runtime.data_mesh(P, device="cpu")


@pytest.fixture
def tbl(rng):
    return {"k": rng.integers(0, 13, N).astype(np.uint32),
            "v": rng.integers(-500, 500, N).astype(np.int32),
            "w": rng.standard_normal(N).astype(np.float32)}


class TestEagerAggregation:
    def test_sql_eager_aggregation_matches_single_device(self, tbl, mesh):
        """Float MAX exact, integer sums and counts exact."""
        j, d = pair(tbl, mesh)
        ccols = {"k": np.repeat(np.arange(32, dtype=np.uint32), 2),
                 "seg": np.tile(np.arange(32, dtype=np.int32) % 3, 2)}
        q = ("SELECT k, SUM(v) AS s, COUNT(*) AS cnt, MAX(w) AS mx FROM l JOIN c USING (k) "
             "WHERE seg = 1 GROUP BY k ORDER BY k")
        lt = trst.sql(q, {"l": d, "c": DistTable(ccols, mesh)}, max_groups=64,
                      capacity_per_shard=2048)
        assert "join[lookup on k]" in lt.explain()
        same(jrst.sql(q, {"l": j, "c": JTable(ccols)}).collect(), lt.collect())


# ------------------------------------------------------------------ strings


@pytest.fixture
def scols(rng):
    n = P * 32
    return {"w": np.array([WORDS[i] for i in rng.integers(0, 8, n)]),
            "v": rng.integers(-50, 50, n).astype(np.int32)}


def spair(cols, mesh):
    return JTable(cols), DistTable(cols, mesh)


class TestDistStrings:
    def test_filter_on_string_fn(self, scols, mesh):
        j, d = spair(scols, mesh)
        same(j.filter((jrst.col("w").length() > 3) & jrst.col("w").contains("a")),
             d.filter((trst.col("w").length() > 3) & trst.col("w").contains("a")))

    def test_with_columns_computed_string(self, scols, mesh):
        j, d = spair(scols, mesh)
        jd = j.with_columns(u=jrst.concat(jrst.col("w").upper(), "-x"))
        dd = d.with_columns(u=trst.concat(trst.col("w").upper(), "-x"))
        assert dd.is_string("u")
        same(jd, dd)

    @pytest.mark.parametrize("q", [
        "SELECT UPPER(w) AS u, COUNT(*) AS n, SUM(v) AS s FROM t GROUP BY UPPER(w) "
        "ORDER BY u LIMIT 6",
        "SELECT v FROM t WHERE LOWER(w) = 'ada' OR w > 'f' ORDER BY v",
        "SELECT w, COUNT(*) AS n, SUM(v) AS s, GROUPING(w) AS g FROM t "
        "GROUP BY ROLLUP(w) ORDER BY g, w",
        "SELECT w, COUNT(*) AS n, GROUPING(w) AS g FROM t WHERE v > 0 "
        "GROUP BY ROLLUP(w) ORDER BY g, w",
    ], ids=["group_order_limit", "string_compare_chain", "rollup", "where_rollup"])
    def test_sql(self, scols, mesh, q):
        j, d = spair(scols, mesh)
        same(jrst.sql(q, {"t": j}).collect(), trst.sql(q, {"t": d}, max_groups=16).collect())

    def test_where_fused_aggregate(self, scols, mesh):
        j, d = spair(scols, mesh)
        q = ("SELECT w, COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 0 GROUP BY w "
             "ORDER BY w")
        lt = trst.sql(q, {"t": d}, max_groups=16)
        assert "; where]" in lt.explain()
        same(jrst.sql(q, {"t": j}).collect(), lt.collect())

    def test_facade_sets_match(self, scols, mesh):
        j, d = spair(scols, mesh)
        same(j.aggregate_sets([["w"], []], {"n": "count"}),
             d.aggregate_sets([["w"], []], {"n": "count"}, max_groups=16))

    def test_replicated_reaggregation_full_matrix(self, scols, mesh):
        """Coarse levels re-aggregate the finest level's single-device result;
        every re-combinable aggregation, mean included (hidden sum and count
        columns), matches: means within 1e-5."""
        j, d = spair(scols, mesh)
        aggs = {"n": "count", "s": ("sum", "v"), "mn": ("min", "v"), "mx": ("max", "v"),
                "av": ("mean", "v"), "any_": ("any", "v"), "all_": ("all", "v"),
                "wmin": ("min", "w")}
        sets = [["w", "v"], ["w"], []]
        b = d.aggregate_sets(sets, aggs, grouping={"g": "w"}, max_groups=256)
        assert "__gs_s_av" not in b.column_names
        same(j.aggregate_sets(sets, aggs, grouping={"g": "w"}), b, float_cols=("av",),
             rtol=1e-5)

    def test_string_join_keys_unify(self, rng, mesh):
        a = {"w": np.array([WORDS[i] for i in rng.integers(0, 5, N)]),
             "v": np.arange(N, dtype=np.int32)}
        b = {"w": np.array([WORDS[i] for i in rng.integers(3, 8, N)]),
             "p": np.arange(N, dtype=np.int32)}
        dj, ovf = DistTable(a, mesh).join(DistTable(b, mesh), "w", capacity_per_shard=64 * N,
                                          exchange_capacity_factor=4.0)
        jj, _ = JTable(a).join(JTable(b), "w", capacity=BIG)
        assert not bool(ovf)
        same(jj, dj, multiset=True)


# --------------------------------------------------------------- band joins


class TestBandJoin:
    def test_broadcast_band_through_sql(self, rng, mesh):
        lx = rng.integers(0, 40, 32).astype(np.int32)
        d = DistTable({"x": lx, "ia": np.arange(32, dtype=np.int32)}, mesh)
        b = TTable({"y": np.array([10, 25], np.int32), "ib": np.array([1, 2], np.int32)},
                   device="cpu")
        out = trst.sql("SELECT ia, ib FROM d JOIN b ON d.x < b.y", {"d": d, "b": b},
                       capacity_per_shard=64).collect()
        got = sorted(zip(*(out.to_table().to_numpy()[c].tolist() for c in ("ia", "ib"))))
        assert got == sorted((i, ib) for i in range(32) for y, ib in ((10, 1), (25, 2))
                             if lx[i] < y)

    def test_both_sides_filtered_flags(self, mesh):
        """The reference's band-join flag regression: left padding (flag 1)
        must never equi-match right padding, which takes flag 2."""
        m2 = runtime.data_mesh(2, device="cpu")
        d = DistTable({"x": np.array([5, 6, 7, 8, 100, 100, 100, 100], np.int32),
                       "ia": np.arange(8, dtype=np.int32)}, m2)
        d = d.filter(lambda t: t["x"] < 10)
        r = TTable({"y": np.array([10, 10, 200, 200], np.int32),
                    "pay": np.array([111, 222, 333, 444], np.int32)}, device="cpu")
        r = r.filter(lambda t: t["pay"] < 300)
        out, ovf = d.join_band(r, "x", "<", "y", capacity_per_shard=32)
        got = out.to_table().to_numpy()
        assert not bool(ovf) and len(got["ia"]) == 8  # 4 kept left rows x 2 kept right
        assert set(got["pay"].tolist()) == {111, 222} and (got["x"] < 10).all()

    def test_nullable_band_col_and_no_false_overflow(self, mesh):
        m2 = runtime.data_mesh(2, device="cpu")
        d = DistTable({"x": np.arange(8, dtype=np.int32), "ia": np.arange(8, dtype=np.int32)},
                      m2)
        r = TTable({"y": np.ma.MaskedArray(np.array([4, 99], np.int32), [False, True]),
                    "ib": np.array([1, 2], np.int32)}, device="cpu")
        out, _ = d.join_band(r, "x", "<", "y", capacity_per_shard=32)
        got = out.to_table().to_numpy()
        assert got["ia"].tolist() == [0, 1, 2, 3] and set(got["ib"].tolist()) == {1}
        df = d.filter(lambda t: t["x"] < 2)
        r2 = TTable({"y": np.array([10], np.int32), "ib": np.array([5], np.int32)},
                    device="cpu")
        out2, ovf2 = df.join_band(r2, "x", "<", "y", capacity_per_shard=4, how="left")
        assert not bool(ovf2)
        assert sorted(out2.to_table().to_numpy()["ia"].tolist()) == [0, 1]

    @pytest.mark.parametrize("op,how", [("between", "inner"), (">=", "left"), ("<", "anti")])
    def test_matches_jax_table(self, tbl, mesh, op, how):
        j, d = pair(tbl, mesh)
        lo = np.arange(-500, 500, 100, dtype=np.int32)
        tiers = {"lo": lo, "hi": lo + 99 + 20 * (np.arange(10) % 2).astype(np.int32),
                 "tier": np.arange(10, dtype=np.int32)}
        rhs = ("lo", "hi") if op == "between" else "lo"
        dj, ovf = d.join_band(TTable(tiers, 7, device="cpu"), "v", op, rhs,
                              capacity_per_shard=16 * N, how=how)
        jj, jovf = j.join_band(JTable(tiers, 7), "v", op, rhs, capacity=BIG, how=how)
        assert not bool(ovf) and not bool(jovf)
        same(jj, dj, multiset=True)

    def test_equality_keys_lead_as_in_table(self, rng, mesh):
        """``on=`` keys come first in the output, as Table.join_band orders
        them (the JAX DistTable keeps the left columns' order instead)."""
        j, d = pair({"c": rng.integers(0, 8, N).astype(np.int32),
                     "x": rng.integers(0, 100, N).astype(np.int32)}, mesh)
        win = {"c": np.arange(8, dtype=np.int32).repeat(2),
               "lo": rng.integers(0, 50, 16).astype(np.int32),
               "hi": rng.integers(50, 100, 16).astype(np.int32)}
        dj, ovf = d.join_band(TTable(win, device="cpu"), "x", "between", ("lo", "hi"), on="c",
                              capacity_per_shard=4 * N)
        jj, _ = j.join_band(JTable(win), "x", "between", ("lo", "hi"), on="c", capacity=BIG)
        assert not bool(ovf) and dj.column_names[0] == "c"
        same(jj, dj)

    def test_cross_join_rejected(self, mesh):
        d = DistTable({"x": np.arange(8, dtype=np.int32)}, mesh)
        b = TTable({"y": np.arange(4, dtype=np.int32)}, device="cpu")
        with pytest.raises(TypeError, match="single-chip"):
            trst.sql("SELECT x FROM d CROSS JOIN b", {"d": d, "b": b}).collect()


# ------------------------------------------------------------ TPC-H as SQL


def tpch(rng, n_orders=64, n_cust=16):
    """Small TPC-H tables whose row counts divide the mesh: every order has
    three line items."""
    per = 3
    okeys = rng.permutation(np.arange(1, 4 * n_orders, 4))[:n_orders].astype(np.int32)
    n = per * n_orders
    lineitem = {
        "l_orderkey": np.repeat(okeys, per),
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.random(n) * 1000 + 900, 2),
        "l_discount": rng.integers(0, 11, n) / 100.0,
        "l_tax": rng.integers(0, 9, n) / 100.0,
        "l_returnflag": rng.choice(["A", "N", "R"], n),
        "l_linestatus": rng.choice(["F", "O"], n),
        "l_shipdate": np.datetime64("1995-01-01") + rng.integers(0, 300, n).astype(
            "timedelta64[D]"),
    }
    orders = {
        "o_orderkey": okeys,
        # the last four customers have no orders (Q13's zero counts)
        "o_custkey": rng.integers(0, n_cust - 4, n_orders).astype(np.int32),
        "o_orderdate": np.datetime64("1995-01-01") + rng.integers(0, 200, n_orders).astype(
            "timedelta64[D]"),
        "o_shippriority": np.zeros(n_orders, np.int32),
        "o_totalprice": np.round(rng.random(n_orders) * 5000, 2),
        "o_special": rng.random(n_orders) < 0.1,
    }
    customer = {
        "c_custkey": np.arange(n_cust, dtype=np.int32),
        "c_mktsegment": rng.choice(["BUILDING", "MACHINERY", "AUTOMOBILE"], n_cust),
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


@pytest.mark.parametrize("name,q,floats", [
    ("q1", Q1, ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
                "avg_price", "avg_disc")),
    ("q3", Q3, ("revenue",)),
    ("q13", Q13, ()),
    ("q18", Q18, ("sum_qty",)),
], ids=["q1", "q3", "q13", "q18"])
def test_tpch_sql_over_disttable(rng, mesh, name, q, floats):
    """TPC-H Q1, Q3, Q13 and Q18 as SQL text over DistTable sources against
    the JAX package's SQL over Tables; float64 sums within 1e-9 relative."""
    data = tpch(rng)
    jt = {k: JTable(v) for k, v in data.items()}
    dt = {k: DistTable(v, mesh) for k, v in data.items()}
    kw = dict(capacity_per_shard=4096, max_groups=256, max_unique=256,
              exchange_capacity_factor=4.0)
    got = trst.sql(q, dt, **kw).collect()
    same(jrst.sql(q, jt, capacity=BIG).collect(), got, float_cols=floats, rtol=1e-9)
