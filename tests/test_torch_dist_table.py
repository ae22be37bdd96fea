"""Port parity: DistTable, the sharded relation facade
(parallel/dist_table.py): every verb, NULL masks, fallbacks and the
broadcast lookup join (SQL, strings and band joins over it are in
``test_torch_dist_sql.py``).

The port's DistTable lies on a 4-slot CPU mesh in one process
(``runtime.data_mesh(4, device="cpu")``). ``DistTable.from_table(t)``
keeps t's rows at their global positions, so every case runs the same
calls on the JAX package's single-device ``Table`` over the same seeded
numpy columns and compares ``to_numpy()``: row-shaped verbs by their valid
rows in global order (joins, whose per-slot order is the routing's, as
multisets of rows), reduction-shaped verbs directly. Integers, orders,
counts, flags and NULL masks are exact; float aggregates within the
tolerance each test states (the summation order differs). Outer joins mark
the cells of unmatched rows NULL on both (the JAX ``DistTable`` fills them
with 0 and counts them, a recorded fault: ROADMAP.md Queue 3, held to
numpy in ``test_left_join_count_skips_unmatched``). The
``*_matches_jax_mesh`` case holds a pipeline against the JAX ``DistTable``
on a 4-device mesh under ``jax.jit``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
import radix_sort_tpu_torch as trst  # noqa: E402
from radix_sort_tpu.parallel.dist_table import DistTable as JDistTable  # noqa: E402
from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu_torch.parallel import dist_window as DW  # noqa: E402
from radix_sort_tpu_torch.parallel import runtime  # noqa: E402
from radix_sort_tpu_torch.parallel.dist_table import DistTable  # noqa: E402
from radix_sort_tpu_torch.table import Table as TTable  # noqa: E402

P = 4
N = P * 128
BIG = 1 << 17  # JAX join capacities past its interpret-mode expansion gate
WORDS = ["ada", "grace", "alan", "Ada", "", "bob", "eve", "mallory"]


@pytest.fixture
def mesh():
    return runtime.data_mesh(P, device="cpu")


@pytest.fixture
def tbl(rng):
    return {"k": rng.integers(0, 13, N).astype(np.uint32),
            "v": rng.integers(-500, 500, N).astype(np.int32),
            "w": rng.standard_normal(N).astype(np.float32)}


def pair(cols, mesh, frac=0.7):
    """The same padded relation as a JAX Table and a port DistTable."""
    count = None if frac is None else int(N * frac)
    j = JTable({k: jnp.asarray(v) for k, v in cols.items()},
               None if count is None else jnp.int32(count))
    d = DistTable.from_table(TTable(cols, count, device="cpu"), mesh)
    return j, d


def np_cols(x):
    """``to_numpy()`` of either package: a nullable column's values (0 under
    its mask) and, as ``name.null``, its mask."""
    out = {}
    for k, v in x.to_numpy().items():
        if isinstance(v, np.ma.MaskedArray):
            out[k] = np.ma.filled(v, np.zeros((), v.dtype))
            out[k + ".null"] = np.ma.getmaskarray(v)
        else:
            out[k] = np.asarray(v)
    return out


def rows(cols):
    names = sorted(cols)
    return sorted(zip(*[cols[n].tolist() for n in names]))


def same(j, d, multiset=False, float_cols=(), rtol=0.0):
    """JAX result ``j`` against the port's ``d``: the same columns, the same
    rows (in order unless ``multiset``), floats in ``float_cols`` to
    ``rtol`` (relative, with an absolute floor of ``rtol``)."""
    a, b = np_cols(j), np_cols(d)
    assert list(a) == list(b) or (multiset and sorted(a) == sorted(b)), (list(a), list(b))
    if multiset:
        assert rows(a) == rows(b)
        return
    for n in a:
        if n in float_cols:
            np.testing.assert_allclose(b[n], a[n], rtol=rtol, atol=rtol, err_msg=n)
        else:
            assert b[n].dtype == a[n].dtype, (n, b[n].dtype, a[n].dtype)
            np.testing.assert_array_equal(b[n], a[n], err_msg=n)


# ---------------------------------------------------------------- basics


class TestBasics:
    def test_from_table_counts_and_roundtrip(self, tbl, mesh):
        j, d = pair(tbl, mesh, 0.6)
        assert d.counts.dtype == torch.int32 and d.counts.shape == (P,)
        assert int(d.counts.sum()) == int(N * 0.6) == int(d.total_count())
        same(j, d)

    def test_fully_valid(self, tbl, mesh):
        j, d = pair(tbl, mesh, None)
        assert d.counts is None and int(d.total_count()) == N
        same(j, d)

    def test_numpy_strings_and_dates(self, rng, mesh):
        cols = {"s": np.array([WORDS[i] for i in rng.integers(0, 8, N)]),
                "d": np.datetime64("2024-01-01") + rng.integers(0, 90, N).astype(
                    "timedelta64[D]"),
                "v": rng.integers(0, 9, N).astype(np.int64)}
        d = DistTable(cols, mesh)
        j = JTable(cols)
        assert d.is_string("s") and list(d.dictionary("s")) == list(j.dictionary("s"))
        same(j, d)
        same(j.sort_by(["s", "d"]), d.sort_by(["s", "d"]))

    def test_projection(self, tbl, mesh):
        _, d = pair(tbl, mesh)
        assert d.select("k", "v").column_names == ["k", "v"]
        assert d.drop("w").column_names == ["k", "v"]
        assert d.rename({"k": "key"}).column_names == ["key", "v", "w"]
        d2 = d.with_columns(z=torch.arange(N, dtype=torch.int32), one=1,
                            e=trst.col("v") * 2)
        assert d2.column_names == ["k", "v", "w", "z", "one", "e"]
        got = d2.to_numpy()
        np.testing.assert_array_equal(got["e"], got["v"] * 2)
        assert (got["one"] == 1).all() and isinstance(d2["z"], runtime.Sharded)

    def test_to_table(self, tbl, mesh):
        j, d = pair(tbl, mesh, 0.5)
        back = d.to_table()
        assert isinstance(back, TTable) and back.num_rows == N
        same(j, back)

    def test_validation(self, mesh):
        with pytest.raises(ValueError, match="divide"):
            DistTable({"k": np.zeros(N + 1, np.int32)}, mesh)
        with pytest.raises(ValueError, match="counts"):
            DistTable({"k": np.zeros(N, np.int32)}, mesh, torch.zeros(3, dtype=torch.int32))

    def test_nullable_columns(self, rng, mesh):
        """Masks ride the row verbs and aggregates skip NULLs as Table's do
        (float sums within 1e-5); nullable keys raise."""
        cols = {"k": rng.integers(0, 5, N).astype(np.int32),
                "m": np.ma.MaskedArray(rng.integers(-9, 9, N).astype(np.int32),
                                       rng.random(N) < 0.3),
                "f": np.ma.MaskedArray(rng.standard_normal(N), rng.random(N) < 0.2)}
        j, d = JTable(cols), DistTable(cols, mesh)
        assert d.nullable_columns == ["m", "f"]
        same(j, d)
        same(j.filter(jrst.col("m") > 0), d.filter(trst.col("m") > 0))
        same(j.sort_by(["m", "k"]), d.sort_by(["m", "k"]))
        aggs = {"n": ("count", "m"), "s": ("sum", "m"), "mn": ("min", "m"),
                "mf": ("mean", "f"), "mx": ("max", "f"), "fm": ("first", "m")}
        same(j.aggregate("k", aggs), d.aggregate("k", aggs, max_groups=16),
             float_cols=("mf",), rtol=1e-5)
        with pytest.raises(TypeError, match="nullable"):
            d.aggregate("m", {"n": "count"}, max_groups=16)
        with pytest.raises(TypeError, match="nullable"):
            d.join(d, "m", capacity_per_shard=N)


# ----------------------------------------------------------- row-shaped verbs


class TestRowShaped:
    def test_filter(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        same(j.filter(lambda x: x["v"] > 0), d.filter(lambda x: x["v"] > 0))
        same(j.filter(jrst.col("v") > 0), d.filter(trst.col("v") > 0))

    def test_sort_by(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        same(j.sort_by(["k", "v"], descending=[False, True]),
             d.sort_by(["k", "v"], descending=[False, True]))

    def test_sort_by_all_valid(self, tbl, mesh):
        j, d = pair(tbl, mesh, None)
        same(j.sort_by("v"), d.sort_by("v"))
        same(j.sort_by("w", descending=True), d.sort_by("w", descending=True))

    def test_window(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        ops = {"rn": "row_number", "s": ("sum", "v"), "prev": ("lag", "v", 1),
               "roll": ("rolling_sum", "v", 3, 1), "nth": ("nth_value", "v", 2),
               "rng": ("range_count", 0.5, 0.5)}
        same(j.window(ops, partition_by="k", order_by="w"),
             d.window(ops, partition_by="k", order_by="w"))
        assert DW._last_fallback is False

    def test_window_descending(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        ops = {"rn": "row_number", "cs": ("cumsum", "v")}
        same(j.window(ops, partition_by="k", order_by="w", descending=True),
             d.window(ops, partition_by="k", order_by="w", descending=True))

    def test_window_fallback_flag_not_stale(self, tbl, mesh):
        """An unbounded RANGE window replicates and says so; the next
        sharded window reports False again."""
        j, d = pair(tbl, mesh)
        ops = {"r": ("range_sum", "v", None, 0.5)}
        same(j.window(ops, partition_by="k", order_by="w"),
             d.window(ops, partition_by="k", order_by="w"))
        assert DW._last_fallback is True
        ops = {"r": ("range_sum", "v", 0.5, 0.5)}
        same(j.window(ops, partition_by="k", order_by="w"),
             d.window(ops, partition_by="k", order_by="w"))
        assert DW._last_fallback is False

    def test_unnest(self, tbl, mesh):
        j, d = pair(tbl, mesh, 0.5)
        c = np.tile([2, 0, 1, 3], N // 4).astype(np.int32)
        dd, ovf = d.with_columns(c=c).unnest("c", total_size_per_shard=N)
        jj, jovf = j.with_columns(c=jnp.asarray(c)).unnest("c", total_size=8 * N)
        assert not bool(ovf) and not bool(jovf)
        same(jj, dd)

    def test_unnest_overflow_flag(self, tbl, mesh):
        _, d = pair(tbl, mesh, None)
        _, ovf = d.with_columns(c=np.full(N, 100, np.int32)).unnest(
            "c", total_size_per_shard=8)
        assert bool(ovf)

    def test_concat(self, tbl, rng, mesh):
        j, d = pair(tbl, mesh, 0.5)
        j2, d2 = pair({k: rng.permutation(v) for k, v in tbl.items()}, mesh, 0.25)
        same(j.concat(j2), d.concat(d2))
        assert int(d.concat(d2).total_count()) == int(N * 0.75)
        jf, df = pair(tbl, mesh, None)
        same(jf.concat(j2), df.concat(d2))

    @pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "right", "full"])
    def test_join(self, rng, mesh, how):
        lt = {"k": rng.integers(0, 97, N).astype(np.uint32),
              "v": rng.integers(-500, 500, N).astype(np.int32)}
        j, d = pair(lt, mesh)
        rcols = {"k": rng.integers(0, 97, N).astype(np.uint32),
                 "p": rng.integers(0, 9999, N).astype(np.int32)}
        rj = JTable({k: jnp.asarray(v) for k, v in rcols.items()}, jnp.int32(N // 2))
        rd = DistTable.from_table(TTable(rcols, N // 2, device="cpu"), mesh)
        dj, dovf = d.join(rd, "k", capacity_per_shard=N * 4, how=how,
                          exchange_capacity_factor=4.0)
        jj, jovf = j.join(rj, "k", capacity=BIG, how=how)
        assert not bool(dovf) and not bool(jovf)
        same(jj, dj, multiset=True)

    @pytest.mark.parametrize("slot_capacity", [N // P + 64, 4 * N // P])
    def test_join_output_padding_does_not_skew(self, rng, mesh, monkeypatch, slot_capacity):
        """A join's output pads each slot with zero rows. Joined again, its
        padding routes by position (29% padding), or the side is compacted
        first (75% padding): the exchange stays within 1.5 x its rows, so no
        slot overflows into the replicated join."""
        from radix_sort_tpu_torch.parallel import dist_query

        def no_fallback(*a, **kw):
            raise AssertionError("the replicated fallback join ran")

        lt = {"k": rng.integers(0, 100, N).astype(np.uint32),
              "v": rng.integers(-500, 500, N).astype(np.int32)}
        rt = {"k": np.arange(100, dtype=np.uint32), "p": np.arange(100, dtype=np.int32)}
        rt2 = {"k": np.arange(100, dtype=np.uint32), "q": -np.arange(100, dtype=np.int32)}
        monkeypatch.setattr(dist_query.Q, "hash_join", no_fallback)
        d1, ovf1 = DistTable(lt, mesh).join(DistTable(rt, mesh), "k",
                                            capacity_per_shard=slot_capacity)
        d2, ovf2 = d1.join(DistTable(rt2, mesh), "k", capacity_per_shard=slot_capacity,
                           exchange_capacity_factor=1.5)
        monkeypatch.undo()
        j1, _ = JTable(lt).join(JTable(rt), "k", capacity=BIG)
        j2, _ = j1.join(JTable(rt2), "k", capacity=BIG)
        assert not bool(ovf1) and not bool(ovf2)
        same(j2, d2, multiset=True)

    def test_join_asof(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        rcols = {"k": np.arange(N, dtype=np.uint32) * 3,
                 "px": np.arange(N, dtype=np.int32) + 1000}
        rj = JTable({k: jnp.asarray(v) for k, v in rcols.items()})
        rd = DistTable(rcols, mesh)
        for direction in ("backward", "forward"):
            same(j.join_asof(rj, "k", direction=direction, matched_col="m"),
                 d.join_asof(rd, "k", direction=direction, matched_col="m"))
        same(j.join_asof(rj, "k", direction="nearest", tolerance=1),
             d.join_asof(rd, "k", direction="nearest", tolerance=1))

    def test_join_asof_needs_valid_right(self, tbl, mesh):
        _, d = pair(tbl, mesh)
        with pytest.raises(ValueError, match="fully-valid"):
            d.join_asof(d, "k")


# ------------------------------------------------------ reduction-shaped verbs


class TestReductionShaped:
    def test_aggregate(self, tbl, mesh):
        """Exact integer aggregates; the float std within 1e-4 relative."""
        j, d = pair(tbl, mesh)
        aggs = {"s": ("sum", "v"), "m": ("median", "v"), "am": ("argmin", "v"),
                "sd": ("std", "w"), "n": "count"}
        got = d.aggregate("k", aggs, max_groups=64, exchange_capacity_factor=4.0)
        assert isinstance(got, TTable)
        same(j.aggregate("k", aggs), got, float_cols=("sd",), rtol=1e-4)

    def test_aggregate_where_and_no_keys(self, tbl, mesh):
        """Float sums within 1e-4 relative (summation order)."""
        j, d = pair(tbl, mesh)
        aggs = {"s": ("sum", "w"), "n": "count", "mx": ("max", "v")}
        same(j.aggregate(None, aggs, where=jrst.col("v") > 0),
             d.aggregate(None, aggs, max_groups=8, where=trst.col("v") > 0),
             float_cols=("s",), rtol=1e-4)

    def test_distinct(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        same(j.distinct("k"), d.distinct("k", max_unique=64))

    def test_top_k(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        same(j.top_k(10, "v"), d.top_k(10, "v"))
        same(j.top_k(10, ["k", "w"], largest=False), d.top_k(10, ["k", "w"], largest=False))

    def test_limit(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        same(j.limit(7, 3), d.limit(7, 3))

    def test_quantiles(self, tbl, mesh):
        qs = [0.0, 0.25, 0.5, 1.0]
        for frac in (0.7, None):
            j, d = pair(tbl, mesh, frac)
            for method in ("lower", "higher", "nearest"):
                np.testing.assert_array_equal(d.quantiles("v", qs, method=method).numpy(),
                                              np.asarray(j.quantiles("v", qs, method=method)))

    def test_set_ops(self, tbl, rng, mesh):
        j, d = pair(tbl, mesh)
        j2, d2 = pair({k: rng.permutation(v) for k, v in tbl.items()}, mesh, 0.4)
        for op in ("union", "intersect", "difference"):
            same(getattr(j, op)(j2, "k"), getattr(d, op)(d2, "k", max_unique=64))


def test_pipeline(tbl, mesh):
    """filter -> window -> aggregate composed, as the reference's jit
    pipeline (a plain call here)."""
    d = DistTable(tbl, mesh)
    d = d.filter(lambda x: x["v"] > -200)
    d = d.window({"rn": "row_number"}, partition_by="k", order_by="w")
    got = d.aggregate("k", {"s": ("sum", "v"), "top": ("max", "rn")}, max_groups=64)
    j = JTable({k: jnp.asarray(v) for k, v in tbl.items()})
    j = j.filter(j["v"] > -200)
    j = j.window({"rn": "row_number"}, partition_by="k", order_by="w")
    same(j.aggregate("k", {"s": ("sum", "v"), "top": ("max", "rn")}), got)


# ------------------------------------------------------------- lookup joins


class TestBroadcastLookupJoin:
    def test_facade_matches_oracle(self, tbl, mesh):
        j, d = pair(tbl, mesh)
        nc = 13
        cc = {"k": np.arange(0, nc, 2, dtype=np.uint32),
              "m": (np.arange(0, nc, 2) * 10).astype(np.int32)}
        out, dup = d.join(TTable(cc, device="cpu"), "k", how="lookup")
        assert not bool(dup)
        jout, _ = j.join(JTable(cc), "k", how="lookup")
        same(jout, out)
        got = out.to_numpy()
        np.testing.assert_array_equal(got["m"], got["k"] * 10)
        # a right side that is not key-unique raises (never a silent drop)
        c2 = TTable({"k": np.array([0, 0, 2], np.uint32), "m": np.zeros(3, np.int32)},
                    device="cpu")
        with pytest.raises(TypeError, match="not key-unique"):
            d.join(c2, "k", how="lookup")
        _, dup2 = d.join(c2, "k", how="lookup", assume_unique=True)
        assert bool(dup2)


def test_left_join_count_skips_unmatched(rng, mesh):
    """COUNT(col) over a DistTable left join counts only the matched rows.
    The JAX DistTable zero-fills the unmatched right cells without a mask,
    so its count is 1 for a customer without orders (ROADMAP.md Queue 3);
    this holds the port to numpy."""
    cust = np.arange(P * 4, dtype=np.int32)
    okey = np.arange(1, P * 8 + 1, dtype=np.int32)
    ocust = rng.integers(0, P * 4 - 3, P * 8).astype(np.int32)  # 3 customers without
    d = DistTable({"c_custkey": cust}, mesh)
    o = DistTable({"c_custkey": ocust, "o_orderkey": okey}, mesh)
    co, ovf = d.join(o, "c_custkey", capacity_per_shard=P * 16, how="left")
    got = co.aggregate("c_custkey", {"n": ("count", "o_orderkey")}, max_groups=64).to_numpy()
    assert not bool(ovf)
    np.testing.assert_array_equal(got["c_custkey"], cust)
    np.testing.assert_array_equal(got["n"], [int((ocust == c).sum()) for c in cust])
    assert (got["n"][-3:] == 0).all()


# -------------------------------------------------------- the JAX DistTable


def test_matches_jax_mesh(tbl, mesh):
    """filter -> window -> aggregate over the JAX DistTable on a 4-device
    mesh under ``jax.jit``, against the port's DistTable."""
    jmesh = JMesh(np.array(jax.devices()[:P]), ("x",))

    def run(k, v, w):
        d = JDistTable({"k": k, "v": v, "w": w}, jmesh)
        d = d.filter(d["v"] > -200)
        d = d.window({"rn": "row_number", "cs": ("cumsum", "v")}, partition_by="k",
                     order_by="w")
        out = d.aggregate("k", {"s": ("sum", "cs"), "top": ("max", "rn")}, max_groups=64)
        return out["k"], out["s"], out["top"], out.count

    jk, js, jtop, jcnt = jax.jit(run)(*(jnp.asarray(tbl[c]) for c in ("k", "v", "w")))
    d = DistTable(tbl, mesh)
    d = d.filter(lambda x: x["v"] > -200)
    d = d.window({"rn": "row_number", "cs": ("cumsum", "v")}, partition_by="k", order_by="w")
    got = d.aggregate("k", {"s": ("sum", "cs"), "top": ("max", "rn")}, max_groups=64)
    cnt = int(jcnt)
    assert int(got.count) == cnt
    out = got.to_numpy()
    for name, want in (("k", jk), ("s", js), ("top", jtop)):
        np.testing.assert_array_equal(out[name], np.asarray(want)[:cnt], err_msg=name)
