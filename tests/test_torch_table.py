"""Port parity: table.py (Table), on the CPU.

Every test builds the same seeded numpy columns into the JAX package's
``Table`` and the port's ``Table(..., device="cpu")``, runs the same method
calls on both and compares ``to_numpy()``: column names and order, dtypes,
values (floats by their bits, strings as decoded), NULL masks and the row
count. Where a column holds float sums or means, it may differ by the
summation order only, and the test states its bound. The slice test runs
small TPC-H Q1, Q3 and Q13 through both.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from radix_sort_tpu.table import Table as JTable  # noqa: E402
from radix_sort_tpu_torch import nulls as TN  # noqa: E402
from radix_sort_tpu_torch import strings as TS  # noqa: E402
from radix_sort_tpu_torch.table import Table as TTable  # noqa: E402
from radix_sort_tpu import nulls as JN  # noqa: E402
from radix_sort_tpu import strings as JS  # noqa: E402

N = 40
WORDS = np.array(["", "apple", "kiwi", "fig", "banana", "zucchini", "date"])


def tables(cols, **kw):
    return JTable(cols, **kw), TTable(cols, device="cpu", **kw)


def data(rng, n=N, nulls=True):
    """Ints with ties, floats, a uint32 column, strings, dates (days and
    microseconds) and, with ``nulls``, two nullable columns."""
    cols = {
        "k": rng.integers(0, 5, n).astype(np.int32),
        "g": rng.integers(0, 3, n).astype(np.int64),
        "v": np.round(rng.standard_normal(n) * 100, 2),
        "f": rng.standard_normal(n).astype(np.float32),
        "u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        "s": rng.choice(WORDS[1:5], n),
        "d": np.datetime64("2024-01-01") + rng.integers(0, 60, n).astype("timedelta64[D]"),
        "ts": (np.datetime64("2024-01-01T00:00:00", "us")
               + rng.integers(0, 10**9, n).astype("timedelta64[us]")),
    }
    if nulls:
        cols["m"] = np.ma.MaskedArray(rng.integers(-9, 9, n).astype(np.int32),
                                      rng.random(n) < 0.3)
        cols["ms"] = [None if r < 0.25 else w for r, w in
                      zip(rng.random(n), rng.choice(WORDS[2:], n))]
    return cols


def same(j, t, float_cols=(), rtol=0.0):
    """``to_numpy()`` of the JAX table ``j`` against the port's ``t``.
    ``float_cols`` are sums or means whose summation order may differ:
    they agree to ``rtol``."""
    a, b = j.to_numpy(), t.to_numpy()
    assert list(a) == list(b), (list(a), list(b))
    for name in a:
        x, y = a[name], b[name]
        assert x.dtype == y.dtype, (name, x.dtype, y.dtype)
        assert x.shape == y.shape, (name, x.shape, y.shape)
        assert isinstance(x, np.ma.MaskedArray) == isinstance(y, np.ma.MaskedArray), name
        if isinstance(x, np.ma.MaskedArray):
            np.testing.assert_array_equal(np.ma.getmaskarray(y), np.ma.getmaskarray(x),
                                          err_msg=name)
            x, y = np.ma.getdata(x), np.ma.getdata(y)
        if name in float_cols:
            np.testing.assert_allclose(y, x, rtol=rtol, atol=0, err_msg=name)
        elif x.dtype.kind in "fc":
            np.testing.assert_array_equal(y.view(f"u{x.itemsize}"), x.view(f"u{x.itemsize}"),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(y, x, err_msg=name)


def jitted(f, *args):
    """``f(*args)`` for JAX tables, run as one ``jax.jit`` program (one
    compile instead of one per operation; the same operations), rebuilt as
    a Table. A ``(Table, overflow)`` result keeps its shape."""
    meta = {}

    def g():
        out = f(*args)
        t = out[0] if isinstance(out, tuple) else out
        meta.update(dicts=t._dicts, tuple=isinstance(out, tuple), names=list(t._cols))
        return list(t._cols.values()), t._count, (out[1] if isinstance(out, tuple) else None)

    cols, cnt, ovf = jax.jit(g)()  # a list: a dict would come back in sorted key order
    t = JTable(dict(zip(meta["names"], cols)), cnt, dictionaries=meta["dicts"])
    return (t, ovf) if meta["tuple"] else t


def both(f, j, t, **kw):
    same(jitted(f, j), f(t), **kw)


# ---------------------------------------------------------------- construction

def test_constructor_converts_every_kind(rng):
    cols = data(rng)
    cols["b"] = rng.random(N) < 0.5
    cols["i8"] = rng.integers(-100, 100, N).astype(np.int8)
    cols["u64"] = rng.integers(0, 2**63, N, dtype=np.uint64) * 2 + 1
    cols["nums"] = [None if i % 7 == 0 else float(i) for i in range(N)]
    j, t = tables(cols)
    same(j, t)
    assert t.device == torch.device("cpu")
    assert t.is_string("s") and t.is_string("ms") and not t.is_string("k")
    assert t["s"].dtype == torch.uint32 and t["d"].dtype == torch.int32
    assert t["ts"].dtype == torch.int64  # microseconds, no x64 switch in the port
    assert t.nullable_columns == ["m", "ms", "nums"]
    np.testing.assert_array_equal(t.dictionary("s"), np.asarray(j.dictionary("s")))


def test_constructor_masked_column_count_and_explicit_masks(rng):
    v = rng.integers(0, 9, N).astype(np.int32)
    m = rng.random(N) < 0.4
    codes, vocab = TS.encode(rng.choice(WORDS, N))
    j = JTable({"x": JN.MaskedColumn(v, m), "c": codes, "y": v}, count=25,
               dictionaries={"c": vocab}, null_masks={"y": m})
    t = TTable({"x": TN.MaskedColumn(torch.from_numpy(v), torch.from_numpy(m)), "c": codes,
                "y": v}, count=25, dictionaries={"c": vocab}, null_masks={"y": m},
               device="cpu")
    same(j, t)
    assert int(t.count) == 25 and t.num_rows == N


def test_device_defaults_to_the_gpu(rng):
    """No ``device``: the columns go to "cuda"; without a GPU that raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert TTable({"x": np.arange(3)}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTable({"x": np.arange(3)})


def test_constructor_rejects_bad_input():
    with pytest.raises(ValueError, match="at least one column"):
        TTable({}, device="cpu")
    with pytest.raises(ValueError, match="length"):
        TTable({"a": np.arange(3), "b": np.arange(4)}, device="cpu")
    with pytest.raises(ValueError, match="NUL"):
        TTable({"a\x00b": np.arange(3)}, device="cpu")
    with pytest.raises(ValueError, match="unknown column"):
        TTable({"a": np.arange(3)}, null_masks={"b": np.zeros(3, bool)}, device="cpu")


# ---------------------------------------------------------------- projection

PROJECTIONS = {
    "select": lambda t: t.select("s", "m", "k"),
    "drop": lambda t: t.drop("m", "f", "ts"),
    "rename": lambda t: t.rename({"m": "mm", "s": "ss"}),
    "limit": lambda t: t.limit(7, offset=3),
    "limit_past_end": lambda t: t.limit(100, offset=35),
    "filter_then_limit": lambda t: t.filter(lambda q: q["k"] != 2).limit(9, offset=4),
    "filter_callable": lambda t: t.filter(lambda q: (q["k"] > 1) & (q["g"] < 2)),
    "filter_twice": lambda t: t.filter(lambda q: q["k"] > 0).filter(lambda q: q["g"] != 1),
    "filter_scalar": lambda t: t.filter(lambda q: q["k"][0] >= 0),
}


@pytest.mark.parametrize("case", list(PROJECTIONS))
def test_projection_and_filter(rng, case):
    both(PROJECTIONS[case], *tables(data(rng)))


def test_with_columns_every_kind(rng):
    cols = data(rng)
    j, t = tables(cols)
    m = rng.random(N) < 0.5
    vals = rng.integers(0, 50, N).astype(np.int16)
    codes, vocab = JS.encode(rng.choice(WORDS, N))
    jt = j.with_columns(a=j["k"] * 2 + j["g"], b=JN.MaskedColumn(vals, m),
                        c=JS.DictColumn(codes, vocab, m), e=np.ma.MaskedArray(vals, m),
                        lit=np.int32(7),
                        strs=WORDS[np.arange(N) % 7], k=j["f"])
    tt = t.with_columns(a=t["k"] * 2 + t["g"], b=TN.MaskedColumn(torch.from_numpy(vals), m),
                        c=TS.DictColumn(torch.from_numpy(codes), vocab, torch.from_numpy(m)),
                        e=np.ma.MaskedArray(vals, m), lit=np.int32(7),
                        strs=WORDS[np.arange(N) % 7], k=t["f"])
    same(jt, tt)
    # a callable takes the table (a port extension): the same column
    same(jt, t.with_columns(a=lambda q: q["k"] * 2 + q["g"], b=TN.MaskedColumn(vals, m),
                            c=TS.DictColumn(codes, vocab, m), e=np.ma.MaskedArray(vals, m),
                            lit=np.int32(7), strs=WORDS[np.arange(N) % 7],
                            k=lambda q: q["f"]))
    # replacing a nullable or string column with a plain one drops its mask
    # and dictionary
    same(j.with_columns(m=j["k"], s=j["g"]), t.with_columns(m=t["k"], s=t["g"]))


# ---------------------------------------------------------------- ordering

SORTS = {
    "one_key": dict(by="v"),
    "strings_desc": dict(by=["s", "k"], descending=[True, False]),
    "nulls_default": dict(by=["m", "d"]),
    "nulls_desc": dict(by="m", descending=True),
    "nulls_first": dict(by=["ms", "m"], nulls_last=[False, True]),
    "nulls_last_desc": dict(by="ms", descending=True, nulls_last=True),
    "floats": dict(by=["f", "u"], descending=[False, True]),
}


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("case", list(SORTS))
def test_sort_by(rng, case, filtered):
    cols = data(rng)
    cols["f"][:6] = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)
    j, t = tables(cols)
    if filtered:
        j, t = (x.filter(lambda q: q["k"] != 1) for x in (j, t))
    both(lambda x: x.sort_by(**SORTS[case]), j, t)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("by,k", [("v", 5), (["m", "s"], 9), (["k", "d"], 100)])
def test_top_k(rng, by, k, largest):
    j, t = tables(data(rng))
    both(lambda x: x.top_k(k, by, largest=largest), j, t)
    both(lambda x: x.filter(lambda q: q["g"] != 0).top_k(k, by, largest=largest), j, t)


@pytest.mark.parametrize("subset", [None, "s", ["ms", "k"], ["m"], ["d", "g"]])
def test_distinct(rng, subset):
    cols = data(rng)
    del cols["v"], cols["f"], cols["ts"], cols["u"]
    j, t = tables(cols)
    both(lambda x: x.distinct(subset), j, t)
    both(lambda x: x.filter(lambda q: q["k"] < 3).distinct(subset), j, t)


# ---------------------------------------------------------------- aggregation

AGGS = {
    "c": "count", "n": ("count", "m"), "sv": ("sum", "v"), "sm": ("sum", "m"),
    "mv": ("mean", "v"), "mm": ("mean", "m"), "lo": ("min", "m"), "hi": ("max", "s"),
    "his": ("max", "ms"), "a": ("any", "m"), "al": ("all", "m"), "fi": ("first", "ms"),
    "la": ("last", "m"), "md": ("median", "s"), "mo": ("mode", "k"), "vr": ("var", "v"),
    "sd": ("std", "f"), "cd": ("count_distinct", "s"), "am": ("argmin", "v"),
    "ax": ("argmax", "d"), "q": ("quantile:0.25", "v"), "qc": ("quantile_cont:0.5", "v"),
}
FLOAT_AGGS = ("sv", "mv", "mm", "vr", "sd")


@pytest.mark.parametrize("by", [None, "k", ["s", "g"], ["ms"], ["m", "d"]])
def test_aggregate(rng, by):
    j, t = tables(data(rng))
    both(lambda x: x.aggregate(by, AGGS), j, t, float_cols=FLOAT_AGGS, rtol=1e-5)
    both(lambda x: x.filter(lambda q: q["k"] != 4).aggregate(by, AGGS), j, t,
         float_cols=FLOAT_AGGS, rtol=1e-5)


def test_aggregate_where_and_no_aggs(rng):
    j, t = tables(data(rng))
    both(lambda x: x.aggregate("k", {"sv": ("sum", "v"), "c": "count"},
                               where=lambda q: q["g"] > 0), j, t, float_cols=("sv",), rtol=1e-9)
    both(lambda x: x.aggregate(["s", "k"], {}, where=lambda q: q["g"] > 0), j, t)
    with pytest.raises(TypeError, match="string"):
        t.aggregate("k", {"x": ("sum", "s")})
    with pytest.raises(TypeError, match="NULLABLE"):
        t.aggregate("k", {"x": ("median", "m")})


@pytest.mark.parametrize("case", ["rollup", "cube_median", "grouping"])
def test_aggregate_sets(rng, case):
    j, t = tables(data(rng))
    if case == "rollup":  # every aggregation shares one sort per chain
        sets, aggs, grouping = [["s", "k"], ["s"], []], {"c": "count", "sm": ("sum", "m"),
                                                         "lo": ("min", "v")}, None
    elif case == "cube_median":  # a holistic aggregation: one aggregate per set
        sets, aggs, grouping = [["k", "ms"], ["k"], ["ms"], []], {"md": ("median", "v")}, None
    else:
        sets, aggs, grouping = [["g", "s"], ["g"]], {"mv": ("mean", "v")}, {"gs": "s"}
    both(lambda x: x.aggregate_sets(sets, aggs, grouping), j, t, float_cols=("mv",),
         rtol=1e-12)


# ---------------------------------------------------------------- joins

def _join_tables(rng):
    """Two tables sharing a nullable string key ``s`` (different
    vocabularies: the join unifies them) and an int key ``k``; the right
    side is filtered, so its padding flags are in play."""
    left = data(rng, 30)
    right = {"k": rng.integers(0, 6, 24).astype(np.int32),
             "s": [None if i % 9 == 0 else w for i, w in
                   enumerate(rng.choice(WORDS[3:], 24))],
             "w": rng.standard_normal(24).astype(np.float32),
             "m": np.ma.MaskedArray(rng.integers(0, 5, 24), rng.random(24) < 0.3)}
    jl, tl = tables(left)
    jr, tr = tables(right)
    jr, tr = (x.filter(lambda q: q["k"] != 5) for x in (jr, tr))
    return jl, tl, jr, tr


@pytest.mark.parametrize("on", ["k", "s", ["s", "k"]])
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti", "lookup"])
def test_join(rng, how, on):
    jl, tl, jr, tr = _join_tables(rng)
    if how == "lookup":  # a key-unique right side
        jr, tr = (x.distinct(on) for x in (jr, tr))
        jr, tr = (x.with_columns(z=x[x.column_names[0]]) for x in (jr, tr))
    cap = 400  # under the reference's kernel gate: its gather route, fast here
    jo, jovf = jitted(lambda a, b: a.join(b, on, capacity=cap, how=how), jl, jr)
    to, tovf = tl.join(tr, on, capacity=cap, how=how)
    same(jo, to)
    assert bool(jovf) == bool(tovf)


def test_join_lookup_duplicates_overflow_and_cross(rng):
    jl, tl, jr, tr = _join_tables(rng)
    # duplicate right keys: lookup runs the exact inner join
    both(lambda x: x[0].join(x[1], "k", capacity=512, how="lookup")[0], (jl, jr), (tl, tr))
    jo, jovf = jitted(lambda a, b: a.join(b, "k", capacity=16), jl, jr)
    to, tovf = tl.join(tr, "k", capacity=16)
    same(jo, to)
    assert bool(jovf) and bool(tovf)
    both(lambda x: x[0].select("k", "g").limit(6).cross_join(x[1].select("w", "s").limit(10))[0],
         (jl, jr), (tl, tr))


def test_join_keeps_bool_columns(rng):
    """A bool payload column stays bool through the joins; the reference's
    ``where(matched, c[g], 0)`` promotes it to int64 (ROADMAP.md Queue 3).
    Values agree once cast."""
    left = {"k": rng.integers(0, 5, 20).astype(np.int32), "b": rng.random(20) < 0.5}
    right = {"k": rng.integers(0, 5, 12).astype(np.int32), "c": rng.random(12) < 0.5}
    jl, tl = tables(left)
    jr, tr = tables(right)
    for call, gathered in ((lambda a, b: a.join(b, "k", capacity=256, how="left")[0], "bc"),
                           (lambda a, b: a.join_band(b, "k", "<", "k", capacity=256)[0], "bc"),
                           (lambda a, b: a.join_asof(b, "k"), "c")):
        jo, to = call(jl, jr).to_numpy(), call(tl, tr).to_numpy()
        for name in gathered:
            assert jo[name].dtype == np.int64 and to[name].dtype == np.bool_
            np.testing.assert_array_equal(np.ma.getdata(to[name]).astype(np.int64),
                                          np.ma.getdata(jo[name]))


BAND_CASES = [("<", "inner", None), ("<=", "left", "g"), (">", "semi", None),
              (">=", "anti", "g"), ("lt", "left", None), ("ge", "inner", "g")]


@pytest.mark.parametrize("op,how,on", BAND_CASES)
def test_join_band(rng, op, how, on):
    left = data(rng, 30)
    right = {"y": np.ma.MaskedArray(rng.integers(-10, 10, 13).astype(np.int32),
                                    rng.random(13) < 0.2),
             "g": rng.integers(0, 3, 13).astype(np.int64), "w": np.arange(13.0)}
    jl, tl = tables(left)
    jr, tr = tables(right)
    jr, tr = (x.filter(lambda q: q["w"] != 3.0) for x in (jr, tr))
    both(lambda x: x[0].join_band(x[1], "m", op, "y", on=on, capacity=400, how=how)[0],
         (jl, jr), (tl, tr))


@pytest.mark.parametrize("on", [None, "g"])
def test_join_band_between_dates(rng, on):
    left = data(rng, 30)
    lo = np.datetime64("2024-01-01") + rng.integers(0, 60, 12).astype("timedelta64[D]")
    right = {"lo": lo, "hi": lo + rng.integers(-3, 20, 12).astype("timedelta64[D]"),
             "g": rng.integers(0, 3, 12).astype(np.int64), "p": np.arange(12, dtype=np.int32)}
    jl, tl = tables(left)
    jr, tr = tables(right)
    both(lambda x: x[0].join_band(x[1], "d", "between", ("lo", "hi"), on=on,
                                  capacity=512)[0], (jl, jr), (tl, tr))
    with pytest.raises(TypeError, match="string"):
        tl.join_band(tr, "s", "<", "p", capacity=8)
    with pytest.raises(TypeError, match="capacity"):
        tl.join_band(tr, "d", "<", "lo")


@pytest.mark.parametrize("direction,tolerance", [("backward", None), ("forward", 5),
                                                 ("nearest", None)])
def test_join_asof(rng, direction, tolerance):
    left = data(rng, 30)
    right = {"k": rng.integers(0, 6, 16).astype(np.int32),
             "w": rng.standard_normal(16), "s": rng.choice(WORDS, 16),
             "m": np.ma.MaskedArray(rng.integers(0, 5, 16), rng.random(16) < 0.3)}
    jl, tl = tables(left)
    jr, tr = tables(right)
    jr, tr = (x.filter(lambda q: q["k"] != 2) for x in (jr, tr))
    both(lambda x: x[0].join_asof(x[1], "k", direction=direction, tolerance=tolerance,
                                  matched_col="hit"), (jl, jr), (tl, tr))
    both(lambda x: x[0].join_asof(x[1], "s", direction="backward"), (jl, jr), (tl, tr))


@pytest.mark.parametrize("op", ["union", "intersect", "difference"])
def test_set_operators(rng, op):
    a = {"s": rng.choice(WORDS[:5], 30), "k": rng.integers(0, 3, 30).astype(np.int32),
         "m": np.ma.MaskedArray(rng.integers(0, 2, 30), rng.random(30) < 0.3)}
    b = {"s": rng.choice(WORDS[2:], 20), "k": rng.integers(0, 3, 20).astype(np.int32),
         "m": rng.integers(0, 2, 20)}
    ja, ta = tables(a)
    jb, tb = tables(b)
    jb, tb = (x.filter(lambda q: q["k"] != 1) for x in (jb, tb))
    both(lambda x: getattr(x[0], op)(x[1]), (ja, jb), (ta, tb))
    both(lambda x: getattr(x[0], op)(x[1], subset=["s"]), (ja, jb), (ta, tb))


def test_concat(rng):
    a, b = data(rng, 20), data(rng, 15)
    b["s"] = rng.choice(WORDS[3:], 15)  # another vocabulary
    b["m"] = rng.integers(-9, 9, 15).astype(np.int32)  # no mask: non-NULLs
    ja, ta = tables(a)
    jb, tb = tables(b)
    both(lambda x: x[0].concat(x[1]), (ja, jb), (ta, tb))
    both(lambda x: x[0].filter(lambda q: q["k"] > 1).concat(x[1].filter(lambda q: q["k"] < 3)),
         (ja, jb), (ta, tb))
    with pytest.raises(ValueError, match="names"):
        ta.concat(tb.drop("k"))


# ---------------------------------------------------------------- windows

WINDOWS = {
    "ranks": dict(ops={"rn": "row_number", "rk": "rank", "dr": "dense_rank", "pr": "percent_rank",
                       "cd": "cume_dist", "nt": ("ntile", 3), "c": "count"},
                  partition_by="s", order_by="d"),
    "values": dict(ops={"cs": ("cumsum", "k"), "mn": ("min", "v"), "lg": ("lag", "m", 2),
                        "ld": ("lead", "ms"), "fv": ("first_value", "ms"),
                        "nv": ("nth_value", "m", 2), "lv": ("last_value", "s"),
                        "rs": ("rolling_sum", "k", 2, 1), "rx": ("rolling_max", "s", 1, 1)},
                   partition_by=["g"], order_by=["k", "d"], descending=[True, False]),
    "range": dict(ops={"r": ("range_sum", "k", ("interval", 5, 0), 0),
                       "rc": ("range_count", None, ("interval", 2, 0)),
                       "rm": ("range_min", "v", 7, 7)},
                  partition_by="g", order_by="d"),
    "nullable_keys": dict(ops={"rn": "row_number", "lg": ("lag", "v")}, partition_by="ms",
                          order_by="m", descending=True),
    "one_partition": dict(ops={"rn": "row_number", "cm": ("cummax", "f"), "sm": ("sum", "v")},
                          order_by="v"),
}


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("case", list(WINDOWS))
def test_window(rng, case, filtered):
    j, t = tables(data(rng))
    if filtered:
        j, t = (x.filter(lambda q: q["k"] != 0) for x in (j, t))
    both(lambda x: x.window(**WINDOWS[case]), j, t, float_cols=("sm",), rtol=1e-12)


def test_window_rejects_nullable_values_and_string_sums(rng):
    _, t = tables(data(rng))
    with pytest.raises(TypeError, match="NULLABLE"):
        t.window({"x": ("sum", "m")}, partition_by="k")
    with pytest.raises(TypeError, match="string"):
        t.window({"x": ("sum", "s")}, partition_by="k")


# ---------------------------------------------------------------- UNNEST, quantiles

def test_unnest(rng):
    j, t = tables(data(rng))
    counts = rng.integers(0, 4, N).astype(np.int32)
    for f in (lambda x, c: x.unnest(c, 128), lambda x, c: x.unnest(c, 20),
              lambda x, c: x.filter(lambda q: q["k"] > 1).unnest(c, 128)):
        jo, jovf = jitted(f, j, counts)
        to, tovf = f(t, torch.from_numpy(counts))
        same(jo, to)
        assert bool(jovf) == bool(tovf)
    both(lambda x: x.with_columns(n=counts).unnest("n", 128)[0], j, t)


@pytest.mark.parametrize("method", ["lower", "higher", "nearest"])
@pytest.mark.parametrize("column", ["v", "m", "d"])
def test_quantiles(rng, column, method):
    j, t = tables(data(rng))
    qs = [0.0, 0.1, 0.5, 0.77, 1.0]
    for f in (lambda x: x, lambda x: x.filter(lambda q: q["k"] != 3)):
        want = np.asarray(jax.jit(lambda: f(j).quantiles(column, qs, method=method))())
        got = f(t).quantiles(column, qs, method=method).numpy()
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError, match="string"):
        t.quantiles("s", [0.5])


# ---------------------------------------------------------------- TPC-H Q1, Q3, Q13

def tpch(rng, n_cust=60, n_orders=200):
    """A tiny TPC-H (4.2.3 columns the three queries read): strings as host
    string data, dates as datetime64[D]."""
    seg = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"])
    customer = {"c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
                "c_mktsegment": rng.choice(seg, n_cust)}
    okey = rng.permutation(np.arange(1, n_orders + 1, dtype=np.int64) * 4)
    odate = np.datetime64("1992-01-01") + rng.integers(0, 2400, n_orders).astype(
        "timedelta64[D]")
    # customers whose key is a multiple of 3 place no order (4.2.3)
    custs = np.array([c for c in range(1, n_cust + 1) if c % 3])
    orders = {"o_orderkey": okey, "o_custkey": rng.choice(custs, n_orders),
              "o_orderdate": odate, "o_shippriority": np.zeros(n_orders, np.int32),
              "o_special": rng.random(n_orders) < 0.01}
    per = rng.integers(1, 8, n_orders)
    li = np.repeat(np.arange(n_orders), per)
    n = li.shape[0]
    ship = odate[li] + rng.integers(1, 122, n).astype("timedelta64[D]")
    receipt = ship + rng.integers(1, 31, n).astype("timedelta64[D]")
    current = np.datetime64("1995-06-17")
    flag = np.where(receipt <= current, rng.choice(["R", "A"], n), "N")
    lineitem = {"l_orderkey": okey[li], "l_quantity": rng.integers(1, 51, n).astype(np.float64),
                "l_extendedprice": np.round(rng.uniform(900, 105000, n), 2),
                "l_discount": rng.integers(0, 11, n) / 100, "l_tax": rng.integers(0, 9, n) / 100,
                "l_returnflag": flag, "l_linestatus": np.where(ship > current, "O", "F"),
                "l_shipdate": ship}
    return customer, orders, lineitem


def q1(li, day):
    t = li.filter(lambda x: x["l_shipdate"] <= day)
    t = t.with_columns(disc_price=t["l_extendedprice"] * (1 - t["l_discount"]))
    t = t.with_columns(charge=t["disc_price"] * (1 + t["l_tax"]))
    t = t.aggregate(["l_returnflag", "l_linestatus"], {
        "sum_qty": ("sum", "l_quantity"), "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", "disc_price"), "sum_charge": ("sum", "charge"),
        "avg_qty": ("mean", "l_quantity"), "avg_price": ("mean", "l_extendedprice"),
        "avg_disc": ("mean", "l_discount"), "count_order": "count"})
    return t.sort_by(["l_returnflag", "l_linestatus"])


def q3(cust, orders, li, building, day):
    c = cust.filter(lambda x: x["c_mktsegment"] == building)
    o = orders.filter(lambda x: x["o_orderdate"] < day).rename({"o_custkey": "c_custkey"})
    co, _ = c.join(o, "c_custkey", capacity=512)
    co = co.rename({"o_orderkey": "l_orderkey"})
    lf = li.filter(lambda x: x["l_shipdate"] > day)
    col, _ = co.join(lf, "l_orderkey", capacity=4096)
    col = col.with_columns(revenue=col["l_extendedprice"] * (1 - col["l_discount"]))
    agg = col.aggregate(["l_orderkey", "o_orderdate", "o_shippriority"],
                        {"revenue": ("sum", "revenue")})
    return agg.sort_by(["o_orderdate"]).top_k(10, "revenue")


def q13(cust, orders):
    o = orders.filter(lambda x: ~x["o_special"]).rename({"o_custkey": "c_custkey"})
    co, _ = cust.join(o, "c_custkey", capacity=1024, how="left")
    per = co.aggregate("c_custkey", {"c_count": ("count", "o_orderkey")})
    dist = per.aggregate("c_count", {"custdist": "count"})
    return dist.sort_by(["custdist", "c_count"], descending=True)


def test_tpch_q1_q3_q13(rng):
    """The slice as a user composes it: TPC-H Q1 (2.4.1), Q3 (2.4.3) and
    Q13 (2.4.13, its o_comment NOT LIKE filter replaced by a 1% flag)
    through Table calls in both packages; float sums agree to 1e-12
    relative (float64)."""
    cust, orders, li = tpch(rng)
    jc, tc = tables(cust)
    jo, to = tables(orders)
    jl, tl = tables(li)
    cutoff = int(np.datetime64("1998-12-01").astype(np.int64)) - 90
    fl = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
          "avg_price", "avg_disc")
    same(jitted(q1, jl, cutoff), q1(tl, cutoff), float_cols=fl, rtol=1e-12)
    out = q1(tl, cutoff).to_numpy()
    assert set(out["l_returnflag"]) <= {"A", "N", "R"} and out["count_order"].sum() > 0
    day = int(np.datetime64("1995-03-15").astype(np.int64))
    same(jitted(q3, jc, jo, jl, jc.code("c_mktsegment", "BUILDING"), day),
         q3(tc, to, tl, tc.code("c_mktsegment", "BUILDING"), day),
         float_cols=("revenue",), rtol=1e-12)
    same(jitted(q13, jc, jo), q13(tc, to))
    got = q13(tc, to).to_numpy()
    assert got["custdist"].sum() == len(cust["c_custkey"])  # every customer once
