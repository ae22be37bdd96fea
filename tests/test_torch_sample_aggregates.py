"""The port's sample statistics and hoisted SELECT aggregates, which the JAX
package lacks, against a numpy oracle: ``var_samp`` / ``std_samp`` /
``corr`` in ``ops/query.py``, ``Table.aggregate`` (NULLs skipped, NULL
where undefined), SQL ``VAR_SAMP`` / ``STDDEV_SAMP`` / ``CORR`` and
aggregate calls inside SELECT expressions; the aggregate and window
counters and profiler ranges.

No JAX here: there is nothing to hold parity with.
"""

import numpy as np
import pytest
import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch import SqlError
from radix_sort_tpu_torch.ops import query as Q
from radix_sort_tpu_torch.ops import window as W

# two-pass float64 moments of at most a few hundred values of at most 1e3:
# a few ULP of the result, with room
RTOL = 1e-12


def _oracle(keys, x, y=None, keep=None):
    """{key: (var_samp, std_samp, corr)} in float64 with numpy, NaN where
    undefined (fewer than 2 kept rows; corr: a constant column)."""
    keep = np.ones(len(keys), bool) if keep is None else keep
    out = {}
    for k in np.unique(keys):
        m = (keys == k) & keep
        xs = x[m].astype(np.float64)
        if m.sum() < 2:
            out[k] = (np.nan, np.nan, np.nan)
            continue
        var = xs.var(ddof=1) if np.ptp(xs) else 0.0
        corr = np.nan
        if y is not None:
            ys = y[m].astype(np.float64)
            if np.ptp(xs) and np.ptp(ys):
                corr = np.corrcoef(xs, ys)[0, 1]
        out[k] = (var, np.sqrt(var), corr)
    return out


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=RTOL, err_msg=what)


def _data(dtype, n=3000, seed=0):
    """Keys with one-row and constant groups among random ones."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 60, n).astype(np.int32)
    keys[:3] = [100, 101, 101]  # a one-row group and a two-row one
    if np.dtype(dtype).kind == "f":
        x = (rng.random(n) * 1000).astype(dtype)
        y = (rng.random(n) * 10 - 5).astype(dtype)
    else:
        x = rng.integers(-20, 20, n).astype(dtype)
        y = rng.integers(0, 7, n).astype(dtype)
    x[keys == 7] = x[keys == 7][0]  # a constant column in group 7
    x[keys == 8] = 0.1 if np.dtype(dtype).kind == "f" else 3  # 0.1 sums inexactly
    y[keys == 9] = y[keys == 9][0]
    return keys, x, y


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64])
def test_sample_stats_against_numpy(dtype):
    keys, x, y = _data(dtype)
    tk, tx, ty = (torch.from_numpy(a) for a in (keys, x, y))
    uk, (var, std, corr), cnt = rst.hash_aggregate(tk, [tx, tx, (tx, ty)],
                                                   ["var_samp", "std_samp", "corr"])
    n = int(cnt)
    want = _oracle(keys, x, y)
    assert uk[:n].tolist() == sorted(want)
    for i, name in enumerate(("var_samp", "std_samp", "corr")):
        got = [v for v in (var, std, corr)[i][:n].tolist()]
        _close(got, [want[k][i] for k in uk[:n].tolist()], name)
    assert var.dtype == std.dtype == corr.dtype == torch.float64
    g = uk[:n].tolist()
    assert var[g.index(7)] == 0 and var[g.index(8)] == 0  # constant: exactly 0
    assert np.isnan(corr[g.index(7)].item()) and np.isnan(corr[g.index(9)].item())
    assert np.isnan(var[g.index(100)].item())  # one row


def test_single_aggregate_call_and_keep_column():
    keys, x, y = _data(np.float64, seed=1)
    keep = np.random.default_rng(2).random(len(keys)) < 0.7
    keep[keys == 7] = True
    tk, tx, ty, tm = (torch.from_numpy(a) for a in (keys, x, y, keep))
    want = _oracle(keys, x, y, keep)
    uk, corr, cnt = rst.hash_aggregate(tk, (tx, ty, tm), "corr")
    _, var, _ = rst.hash_aggregate(tk, (tx, tm), "var_samp")
    _, std, _ = rst.hash_aggregate(tk, tx, "std_samp")
    ks = uk[:int(cnt)].tolist()
    _close(corr[:len(ks)], [want[k][2] for k in ks], "corr with keep")
    _close(var[:len(ks)], [want[k][0] for k in ks], "var_samp with keep")
    _close(std[:len(ks)], [_oracle(keys, x)[k][1] for k in ks], "std_samp")
    with pytest.raises(ValueError, match="pair of columns"):
        rst.hash_aggregate(tk, tx, "corr")
    with pytest.raises(ValueError, match="optional"):
        rst.hash_aggregate(tk, (tx, ty, tm, tm), "corr")


def test_table_skips_nulls_and_is_null_where_undefined():
    keys, x, y = _data(np.float64, seed=3)
    rng = np.random.default_rng(4)
    xm = rng.random(len(keys)) < 0.2
    ym = rng.random(len(keys)) < 0.2
    xm[keys == 101] = [True, False]  # one non-NULL row left: NULL result
    ym[keys == 7] = False
    t = rst.Table({"k": keys, "x": np.ma.MaskedArray(x, xm), "y": np.ma.MaskedArray(y, ym),
                   "i": y.astype(np.int32)}, device="cpu")
    out = t.aggregate("k", {"v": ("var_samp", "x"), "s": ("std_samp", "i"),
                            "c": ("corr", "x", "y"), "n": "count"}).to_numpy()
    want_v = _oracle(keys, x, keep=~xm)
    want_c = _oracle(keys, x, y, keep=~xm & ~ym)
    want_s = _oracle(keys, y.astype(np.int32))
    ks = out["k"].tolist()
    for name, col, want in (("v", 0, want_v), ("s", 1, want_s), ("c", 2, want_c)):
        got = out[name]
        assert isinstance(got, np.ma.MaskedArray)
        exp = np.array([want[k][col] for k in ks])
        assert np.array_equal(got.mask, np.isnan(exp)), name
        _close(got.data[~got.mask], exp[~np.isnan(exp)], name)
    assert out["v"].mask[ks.index(101)] and out["v"].mask[ks.index(100)]
    assert out["c"].mask[ks.index(7)] and not out["v"].mask[ks.index(7)]
    with pytest.raises(ValueError, match="two value columns"):
        t.aggregate("k", {"c": ("corr", "x")})


def _sql_table(n=4000, seed=5):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 25, n).astype(np.int32),
            "s": np.array(["a", "bb", "c"])[rng.integers(0, 3, n)],
            "a": rng.integers(1, 6, n).astype(np.int32),
            "b": rng.integers(1, 16, n).astype(np.int32),
            "v": np.round(rng.random(n) * 100, 6)}
    return cols, rst.Table(cols, device="cpu")


def _by_group(cols, keys):
    kv = np.stack([np.unique(cols[k], return_inverse=True)[1] for k in keys], 1)
    groups = {}
    for i, row in enumerate(map(tuple, kv)):
        groups.setdefault(row, []).append(i)
    return {g: np.array(ix) for g, ix in groups.items()}


def test_sql_sample_aggregates_and_expressions():
    cols, t = _sql_table()
    q = ("SELECT k, s, VAR_SAMP(v) AS va, STDDEV_SAMP(a) AS sd, CORR(a, b) AS r, "
         "POW(CORR(a, b), 2) AS r2, MAX(a) - MIN(b) AS rng, "
         "SUM(a) * 2 + COUNT(*) AS z FROM x GROUP BY k, s")
    out = rst.sql(q, {"x": t}).collect().to_numpy()
    assert list(out) == ["k", "s", "va", "sd", "r", "r2", "rng", "z"]
    assert out["rng"].dtype == np.int32 and out["r2"].dtype == np.float64
    groups = _by_group(cols, ["k", "s"])
    assert len(out["k"]) == len(groups)
    for row in range(len(out["k"])):
        ix = np.flatnonzero((cols["k"] == out["k"][row]) & (cols["s"] == out["s"][row]))
        a, b, v = cols["a"][ix], cols["b"][ix], cols["v"][ix]
        r = np.corrcoef(a, b)[0, 1]
        np.testing.assert_allclose(out["va"][row], v.var(ddof=1), rtol=RTOL)
        np.testing.assert_allclose(out["sd"][row], a.std(ddof=1), rtol=RTOL)
        np.testing.assert_allclose(out["r"][row], r, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(out["r2"][row], r * r, rtol=RTOL, atol=RTOL)
        assert out["rng"][row] == a.max() - b.min()
        assert out["z"][row] == 2 * a.sum() + len(ix)


def test_sql_aggregates_inside_expressions_with_having_group_by_all_and_no_group_by():
    cols, t = _sql_table(seed=6)
    out = rst.sql("SELECT k, MAX(v) - MIN(v) AS w, PERCENTILE_CONT(v, 0.5) * 2 AS m2 "
                  "FROM x GROUP BY k HAVING COUNT(*) > 160", {"x": t}).collect().to_numpy()
    for row, k in enumerate(out["k"]):
        v = cols["v"][cols["k"] == k]
        assert len(v) > 160
        assert out["w"][row] == v.max() - v.min()
        np.testing.assert_allclose(out["m2"][row], 2 * np.median(v), rtol=1e-15)
    assert set(out["k"]) == {k for k in np.unique(cols["k"]) if (cols["k"] == k).sum() > 160}
    out_all = rst.sql("SELECT k, MAX(v) - MIN(v) AS w FROM x GROUP BY k",
                      {"x": t}).collect().to_numpy()
    ga = rst.sql("SELECT k, MAX(v) - MIN(v) AS w FROM x GROUP BY ALL",
                 {"x": t}).collect().to_numpy()
    assert ga["k"].tolist() == out_all["k"].tolist() and np.array_equal(ga["w"], out_all["w"])
    g = rst.sql("SELECT MAX(a) - MIN(b) AS r, CORR(a, v) AS c, COUNT(*) AS n FROM x",
                {"x": t}).collect().to_numpy()
    assert g["r"].tolist() == [cols["a"].max() - cols["b"].min()]
    np.testing.assert_allclose(g["c"], [np.corrcoef(cols["a"], cols["v"])[0, 1]], rtol=RTOL)
    assert g["n"].tolist() == [len(cols["a"])]


@pytest.mark.parametrize("q,match", [
    ("SELECT k, a + SUM(b) AS z FROM x GROUP BY k", "must be a GROUP BY key"),
    ("SELECT k FROM x WHERE SUM(a) > 1 GROUP BY k", "not in this expression"),
    ("SELECT k, CORR(a) AS r FROM x GROUP BY k", "exactly 2 column"),
    ("SELECT k, SUM(a) + 1 FROM x GROUP BY k", "needs an alias"),
])
def test_sql_errors(q, match):
    _, t = _sql_table(n=100)
    with pytest.raises(SqlError, match=match):
        rst.sql(q, {"x": t}).collect()


def test_counters_and_ranges():
    """One aggregate call is one AGG_CALLS and one range; six 32-bit keys
    are three 64-bit key passes; PERCENTILE_CONT's (key, value) sort adds
    its own passes; a window call is one CALLS and one range."""
    cols, t = _sql_table(n=500)
    t6 = rst.Table({f"k{i}": cols["k"] for i in range(6)} | {"v": cols["v"]}, device="cpu")
    calls, passes, wcalls = Q.AGG_CALLS, Q.AGG_KEY_PASSES, W.CALLS
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t6.aggregate([f"k{i}" for i in range(6)], {"s": ("sum", "v")})
    assert (Q.AGG_CALLS - calls, Q.AGG_KEY_PASSES - passes) == (1, 3)
    names = [e.name for e in prof.events()]
    assert names.count(Q.AGG_RANGE) == 1
    calls, passes = Q.AGG_CALLS, Q.AGG_KEY_PASSES
    t.aggregate("k", {"m": ("quantile_cont:0.5", "v"), "s": ("std_samp", "v")})
    # one call: the key sort (one pass) and the (key, value) sort (32 + 64 bits: two)
    assert (Q.AGG_CALLS - calls, Q.AGG_KEY_PASSES - passes) == (1, 3)
    with torch.profiler.profile(activities=acts) as prof:
        t.window({"rn": "row_number"}, partition_by="k", order_by="v")
    assert W.CALLS - wcalls == 1
    assert [e.name for e in prof.events()].count(W.WINDOW_RANGE) == 1
