"""Port parity: the aggregation family of ops/query.py (hash_aggregate with
every aggregation, the multi-aggregate, ROLLUP levels).

The same seeded numpy inputs go through the JAX package and the port on the
CPU. Integer, order-statistic, mask and count outputs -- padded tails
included -- must agree bit for bit (floats by their bits). The float
aggregates (float sums, mean, var, std, ``quantile_cont``) may differ by the
ROADMAP parity rule's few ULP, as their summation order is the scatter's:
each test states its bound (:func:`assert_float_close`).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_query import F32_SPECIALS, assert_same, both, col  # noqa: E402

import radix_sort_tpu_torch as trst  # noqa: E402
from radix_sort_tpu.ops import query as jq  # noqa: E402
from radix_sort_tpu_torch.ops import query as tq  # noqa: E402

N = 240
F64_SPECIALS = np.array([0x0, 0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
                         0x7FF8000000000000, 0xFFF8000000000001], np.uint64).view(np.float64)
AGGS = list(jq.AGGREGATIONS) + ["quantile:0.3", "quantile_cont:0.7"]
FLOAT_AGGS = ("mean", "var", "std")  # plus float sums and quantile_cont


def is_float_agg(agg, vdtype):
    return (agg in FLOAT_AGGS or jq.quantile_is_cont(agg)
            or (agg == "sum" and np.issubdtype(vdtype, np.floating)))


def assert_float_close(j, t, tol, what):
    """Equal dtype and NaN positions; elsewhere |port - ref| <= ``tol``."""
    ja, ta = np.asarray(j), t.numpy()
    assert ja.dtype == ta.dtype and ja.shape == ta.shape, (what, ja.dtype, ta.dtype)
    nan = np.isnan(ja)
    np.testing.assert_array_equal(np.isnan(ta), nan, err_msg=what)
    np.testing.assert_allclose(ta[~nan], ja[~nan], rtol=0, atol=tol, err_msg=what)


def float_tol(agg, values, out_dtype):
    """The parity bound of a float aggregate, from the whole value column:
    4 ULP of sum(|x|) for sums, means and quantile_cont; 8 ULP of sum(x**2)
    for var; its square root for std (|sqrt(a) - sqrt(b)| <= sqrt(|a - b|))."""
    x = np.asarray(values).astype(np.float64)
    x = x[~np.isnan(x)]
    if agg in ("var", "std"):
        tol = 8 * np.spacing(out_dtype.type(np.sum(x * x)))
        return float(np.sqrt(tol)) if agg == "std" else float(tol)
    return float(4 * np.spacing(out_dtype.type(np.sum(np.abs(x)))))


def pooled(rng, dtype, n, size=24, specials=True):
    """``n`` draws from a pool of ``size`` bit patterns of ``dtype`` (runs of
    equal values), with NaNs, +-0.0 and infinities for floats."""
    pool = col(rng, dtype, size)
    sp = {np.dtype(np.float32): F32_SPECIALS, np.dtype(np.float64): F64_SPECIALS}.get(
        np.dtype(dtype))
    if specials and sp is not None:
        k = min(len(sp), size // 2)
        pool[:k] = sp[:k]
    return pool[rng.integers(0, size, n)]


def numeric(rng, dtype, n):
    """Finite values for float aggregates (normal floats near 100, a NaN and
    a -0.0), or small-range integers."""
    if np.issubdtype(dtype, np.floating):
        v = (rng.standard_normal(n) * 100).astype(dtype)
        v[rng.integers(0, n, 3)] = -0.0
        v[rng.integers(0, n)] = np.nan
        return v
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), n).astype(dtype)


KEY_CASES = ["i8", "u32", "i64", "f32", "f64", "composite"]


def make_keys(rng, case, n=N):
    if case == "i8":
        return rng.integers(-128, 128, 20).astype(np.int8)[rng.integers(0, 20, n)]
    if case == "u32":
        return pooled(rng, np.uint32, n, 30)
    if case == "i64":
        return pooled(rng, np.int64, n, 25)
    if case == "f32":
        return pooled(rng, np.float32, n, 20)
    if case == "f64":
        return pooled(rng, np.float64, n, 20)
    return [pooled(rng, np.uint8, n, 3), pooled(rng, np.float64, n, 6),
            rng.integers(-2, 2, n).astype(np.int32)]


# value dtypes rotate with the key case, so every dtype meets every family
INT_VALUES = [np.int8, np.uint32, np.int64, np.uint16, np.int32, np.uint64]
FLOAT_VALUES = [np.float32, np.float64]
BITS_VALUES = [np.float32, np.int16, np.uint64, np.float64, np.uint8, np.int32]


def make_values(rng, agg, i, n=N):
    if agg in ("sum", "mean", "var", "std") or jq.quantile_is_cont(agg):
        dt = FLOAT_VALUES[i % 2] if i % 3 != 2 else INT_VALUES[i]
        return numeric(rng, dt, n)
    if agg in ("any", "all"):
        v = pooled(rng, BITS_VALUES[i], n, 6)
        v[rng.random(n) < 0.4] = 0
        return v
    if agg == "count":
        return col(rng, INT_VALUES[i], n)
    return pooled(rng, BITS_VALUES[i], n, 12)  # order statistics, runs, arg*


def check_agg(j, t, agg, values, what):
    """One (keys, aggregates, count) result: keys and count bit for bit, the
    aggregates bit for bit or within the float bound."""
    assert_same((j[0], j[2]), (t[0], t[2]), what)
    if is_float_agg(agg, values.dtype):
        out = np.asarray(j[1])
        assert_float_close(j[1], t[1], float_tol(agg, values, out.dtype), what)
    else:
        assert_same(j[1], t[1], what)


@pytest.mark.parametrize("case", KEY_CASES)
@pytest.mark.parametrize("agg", AGGS)
def test_hash_aggregate_matches_reference(rng, agg, case):
    i = KEY_CASES.index(case)
    keys = make_keys(rng, case)
    values = make_values(rng, agg, i)
    (jk, tk), (jv, tv) = both(keys), both(values)
    j = jq.hash_aggregate(jk, jv, agg)
    t = trst.hash_aggregate(tk, tv, agg)
    check_agg(j, t, agg, values, f"{agg} keys={case} values={values.dtype}")


def test_hash_aggregate_multi_matches_reference(rng):
    """All 18 aggregations in one call over composite keys: the shared sort,
    the shared filters and the delegated (key, value) sorts."""
    for case in ("composite", "u32"):
        keys = make_keys(rng, case)
        values = [make_values(rng, a, k % 6) for k, a in enumerate(AGGS)]
        (jk, tk), (jv, tv) = both(keys), both(values)
        j = jq.hash_aggregate(jk, jv, AGGS)
        t = trst.hash_aggregate(tk, tv, AGGS)
        for a, v, ja, ta in zip(AGGS, values, j[1], t[1]):
            check_agg((j[0], ja, j[2]), (t[0], ta, t[2]), a, v, f"multi {case} {a}")


@pytest.mark.parametrize("multi", [False, True])
def test_positions_override(rng, multi):
    keys = make_keys(rng, "u32")
    values = pooled(rng, np.float32, N, 10)
    positions = rng.permutation(N).astype(np.int32) * 3
    (jk, tk), (jv, tv), (jp, tp) = both(keys), both(values), both(positions)
    for agg in ("argmin", "argmax"):
        a = [agg, "sum"] if multi else agg
        v_j, v_t = ([jv, jv], [tv, tv]) if multi else (jv, tv)
        j = jq.hash_aggregate(jk, v_j, a, _positions=jp)
        t = trst.hash_aggregate(tk, v_t, a, _positions=tp)
        assert_same((j[0], j[1][0] if multi else j[1], j[2]),
                    (t[0], t[1][0] if multi else t[1], t[2]), agg)


@pytest.mark.parametrize("keys_kind", ["u32", "composite"])
def test_hash_aggregate_levels_matches_reference(rng, keys_kind):
    """ROLLUP over three key columns, levels (3, 2, 1, 0), every level
    aggregation over int, float and bool values."""
    keys = ([pooled(rng, np.uint8, N, 3), pooled(rng, np.float32, N, 4),
             rng.integers(-2, 2, N).astype(np.int32)] if keys_kind == "composite"
            else [pooled(rng, np.uint32, N, 5), pooled(rng, np.int64, N, 3)])
    levels = list(range(len(keys), -1, -1))
    aggs = list(jq.LEVEL_AGGREGATIONS) + ["sum", "mean", "min", "any"]
    values = [numeric(rng, np.float32, N), numeric(rng, np.int8, N),
              numeric(rng, np.float64, N), pooled(rng, np.float32, N, 8),
              pooled(rng, np.uint64, N, 8), numeric(rng, np.int32, N) % 3,
              pooled(rng, np.uint16, N, 3), numeric(rng, np.float32, N),
              numeric(rng, np.int64, N), numeric(rng, np.uint32, N) * 5_000_000,
              rng.random(N) < 0.5, pooled(rng, np.int16, N, 6), rng.random(N) < 0.3]
    (jk, tk), (jv, tv) = both(keys), both(values)
    j = jq.hash_aggregate_levels(jk, jv, aggs, levels)
    t = tq.hash_aggregate_levels(tk, tv, aggs, levels)
    assert len(j) == len(t) == len(levels)
    for c, jl, tl in zip(levels, j, t):
        assert isinstance(tl[0], list) and len(tl[0]) == c
        for a, v, ja, ta in zip(aggs, values, jl[1], tl[1]):
            check_agg((jl[0], ja, jl[2]), (tl[0], ta, tl[2]), a, v, f"level {c} {a}")


def test_empty_inputs():
    """n = 0: empty outputs of the dtype a non-empty input gives. The
    reference returns the value dtype for quantile_cont and a bool sum
    (ROADMAP.md Queue 3); the port returns float64 and int64 there."""
    e = np.zeros(0, np.uint32)
    for values in (np.zeros(0, np.float32), np.zeros(0, np.int16)):
        (jk, tk), (jv, tv) = both(e), both(values)
        for agg in AGGS:
            if jq.quantile_is_cont(agg):
                uk, out, cnt = trst.hash_aggregate(tk, tv, agg)
                assert out.dtype == torch.float64 and out.shape == (0,) and int(cnt) == 0
                continue
            assert_same(jq.hash_aggregate(jk, jv, agg), trst.hash_aggregate(tk, tv, agg), agg)
        assert_same(jq.hash_aggregate(jk, [jv, jv], ["sum", "argmax"]),
                    trst.hash_aggregate(tk, [tv, tv], ["sum", "argmax"]), "multi")
        assert_same(jq.hash_aggregate_levels([jk, jk], [jv], ["var"], [2, 1, 0]),
                    tq.hash_aggregate_levels([tk, tk], [tv], ["var"], [2, 1, 0]), "levels")


@pytest.mark.parametrize("dtype,high", [(np.int8, 128), (np.uint8, 256),
                                        (np.uint32, 2**32), (np.int64, 2**62)])
def test_integer_sums_wrap(rng, dtype, high):
    """Integer sums keep the value's width and wrap, as ``jnp.cumsum`` does:
    a group of int8 values near 127 and of uint32 values near 2**32."""
    keys = rng.integers(0, 4, 400).astype(np.int32)
    info = np.iinfo(dtype)
    values = rng.integers(max(info.min, high // 2), high, 400, dtype=np.uint64 if dtype ==
                          np.uint32 else np.int64).astype(dtype)
    (jk, tk), (jv, tv) = both(keys), both(values)
    t = trst.hash_aggregate(tk, tv, "sum")
    assert_same(jq.hash_aggregate(jk, jv, "sum"), t, "sum")
    assert_same(jq.hash_aggregate(jk, [jv, jv], ["sum", "mean"]),
                trst.hash_aggregate(tk, [tv, tv], ["sum", "mean"]), "multi")
    mod = 1 << info.bits  # the numpy oracle: exact sums in Python ints, reduced
    want = [sum(int(x) for x in values[keys == g]) % mod for g in range(4)]
    assert [int(x) % mod for x in t[1].numpy()[:4]] == want


def test_bool_values(rng):
    e = torch.zeros(0, dtype=torch.int32)
    assert trst.hash_aggregate(e, e > 0, "sum")[1].dtype == torch.int64
    assert trst.hash_aggregate_levels([e], [e > 0], ["sum"], [1])[0][1][0].dtype == torch.int64
    keys = rng.integers(0, 5, 100).astype(np.uint16)
    values = rng.random(100) < 0.5
    (jk, tk), (jv, tv) = both(keys), both(values)
    for agg in ("sum", "count", "any", "all", "first", "last", "mean"):
        t = trst.hash_aggregate(tk, tv, agg)
        check_agg(jq.hash_aggregate(jk, jv, agg), t, agg, values, agg)
    aggs = ["sum", "any", "all", "first", "last", "count", "mean"]
    j = jq.hash_aggregate(jk, [jv] * 7, aggs)
    t = trst.hash_aggregate(tk, [tv] * 7, aggs)
    for a, ja, ta in zip(aggs, j[1], t[1]):
        check_agg((j[0], ja, j[2]), (t[0], ta, t[2]), a, values, f"multi {a}")


def test_typed_errors():
    k = torch.arange(4, dtype=torch.int32)
    v = torch.arange(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="agg must be one of"):
        trst.hash_aggregate(k, v, "median_cont")
    with pytest.raises(ValueError, match="agg must be one of"):
        trst.hash_aggregate(k, v, "quantile:1.5")
    with pytest.raises(ValueError, match="BOTH"):
        trst.hash_aggregate(k, [v], "sum")
    with pytest.raises(ValueError, match="equal-length"):
        trst.hash_aggregate(k, [v, v], ["sum"])
    with pytest.raises(ValueError, match="same length"):
        trst.hash_aggregate(k, v[:3], "sum")
    with pytest.raises(ValueError, match="equal length"):
        trst.hash_aggregate([k, k[:3]], v, "sum")
    with pytest.raises(ValueError, match="at least one column"):
        trst.hash_aggregate([], v, "sum")
    with pytest.raises(ValueError, match="equal length"):
        trst.hash_aggregate(k, [v, v[:2]], ["sum", "min"])
    with pytest.raises(ValueError, match="supports"):
        trst.hash_aggregate_levels([k], [v], ["median"], [1])
    with pytest.raises(ValueError, match="out of range"):
        trst.hash_aggregate_levels([k], [v], ["sum"], [2])
    with pytest.raises(TypeError, match="unsupported key dtype"):
        trst.hash_aggregate(k, v > 1, "min")
    assert tq.quantile_q("quantile_cont:0.25") == 0.25 and tq.quantile_q("quantile:x") is None
    assert tq.valid_agg("quantile:1") and not tq.valid_agg("quantile:-0.1")
    assert trst.AGGREGATIONS == jq.AGGREGATIONS
    assert trst.COMBINABLE_AGGREGATIONS == jq.COMBINABLE_AGGREGATIONS
    assert tq.LEVEL_AGGREGATIONS == jq.LEVEL_AGGREGATIONS


def _lineitem(rng, n):
    """A small LINEITEM in chip_smoke.py's shape: flags as uint8 codes,
    dates as int32 days, quantity int32, prices float32/float64."""
    ship = rng.integers(8036, 10_500, n).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n).astype(np.int32)
    current = 9298  # 1995-06-17
    rf = np.where(receipt <= current, np.where(rng.random(n) < 0.5, ord("R"), ord("A")),
                  ord("N")).astype(np.uint8)
    ls = np.where(ship > current, ord("O"), ord("F")).astype(np.uint8)
    qty = rng.integers(1, 51, n).astype(np.int32)
    price = (qty * rng.integers(90_000, 200_001, n) / 100).astype(np.float32)
    disc = rng.integers(0, 11, n) / 100
    tax = rng.integers(0, 9, n) / 100
    return ship, rf, ls, qty, price, disc, tax


def test_q1_end_to_end(rng):
    """TPC-H Q1 (filter on the ship date, then one multi-aggregate grouped by
    return flag and line status) through both packages."""
    ship, rf, ls, qty, price, disc, tax = _lineitem(rng, 3000)
    mask = ship <= 10_471  # 1998-12-01 - 90 days
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    cols = [rf, ls, qty, price, disc_price, charge, disc]
    aggs = ["sum", "sum", "sum", "sum", "mean", "mean", "mean", "count"]
    out = {}
    for name, pkg, conv in (("jax", jq, jnp.asarray), ("torch", tq, torch.from_numpy)):
        *c, cnt = pkg.filter(conv(mask), *[conv(x) for x in cols])
        vals = [c[2], c[3], c[4], c[5], c[2], c[3], c[6], c[2]]
        out[name] = pkg.hash_aggregate([c[0], c[1]], vals, aggs)
    j, t = out["jax"], out["torch"]
    assert_same((j[0], j[2]), (t[0], t[2]), "Q1 groups")
    assert 3 <= int(t[2]) <= 4
    for a, x, ja, ta in zip(aggs, [qty, price, disc_price, charge, qty, price, disc, qty],
                            j[1], t[1]):
        check_agg((j[0], ja, j[2]), (t[0], ta, t[2]), a, x, f"Q1 {a} {x.dtype}")
