"""Port parity: ops/relational.py (join_asof, the set operators, quantiles).

The same seeded numpy inputs go through the JAX package and the port on the
CPU; every output -- values, masks, positions, padded tails and counts --
must agree bit for bit (floats by their bits).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402
from test_torch_query import F32_SPECIALS, assert_same, both, col  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
import radix_sort_tpu_torch as trst  # noqa: E402
from radix_sort_tpu.ops import relational as jr  # noqa: E402
from radix_sort_tpu_torch.ops import relational as tr  # noqa: E402


def pool_draw(rng, dtype, n, size):
    p = col(rng, dtype, size)
    if np.dtype(dtype) == np.float32:
        p[:6] = F32_SPECIALS[:6]
    return p[rng.integers(0, size, n)]


# ---------------------------------------------------------------- join_asof

ASOF_CASES = [
    # (key dtype, direction, tolerance)
    ("i32", "backward", None), ("i32", "forward", None), ("i32", "nearest", None),
    ("i32", "backward", 40), ("i32", "forward", 40), ("i32", "nearest", 40),
    ("u8", "nearest", 3), ("i16", "forward", 0), ("u32", "nearest", None),
    ("f32", "nearest", None), ("f32", "backward", 2.5), ("f32", "forward", 0.0),
    ("u64", "backward", None), ("f64", "forward", None), ("i64", "backward", None),
]
DT = {"i32": np.int32, "u8": np.uint8, "i16": np.int16, "u32": np.uint32, "f32": np.float32,
      "u64": np.uint64, "f64": np.float64, "i64": np.int64}


def _asof_keys(rng, kind, n):
    dt = DT[kind]
    if kind == "f32":
        k = (rng.standard_normal(n) * 50).astype(np.float32)
        k[:4] = F32_SPECIALS[:4]  # +-0.0, +-inf
        k[4] = np.nan
        return k
    if kind in ("i32", "i16", "u8"):
        lo, hi = (0, 250) if kind == "u8" else (-500, 500)
        return rng.integers(lo, hi, n).astype(dt)
    return col(rng, dt, n)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("kind,direction,tolerance", ASOF_CASES)
def test_join_asof_matches_reference(rng, kind, direction, tolerance, valid):
    n_l, n_r = 120, 200
    lk = _asof_keys(rng, kind, n_l)
    rk = _asof_keys(rng, kind, n_r)
    lk[:10] = rk[rng.integers(0, n_r, 10)]  # exact hits
    rv = col(rng, np.float64, n_r)
    rvalid = rng.random(n_r) < 0.7 if valid else None
    (jl, tl), (jrk, trk), (jv, tv) = both(lk), both(rk), both(rv)
    kw = dict(direction=direction, tolerance=tolerance)
    if valid:
        kw_j, kw_t = dict(kw, right_valid=both(rvalid)[0]), dict(kw, right_valid=both(rvalid)[1])
    else:
        kw_j = kw_t = kw
    assert_same(jr.join_asof(jl, jrk, jv, **kw_j), trst.join_asof(tl, trk, tv, **kw_t),
                f"{kind} {direction} tol={tolerance} valid={valid}")


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
def test_join_asof_distances_past_2_31(rng, direction):
    """uint32 and int32 keys whose distances exceed 2**31: the reference
    compares them as unsigned 32-bit differences."""
    for dt, keys in ((np.uint32, [0, 10, 3_000_000_000, 4_294_967_295]),
                     (np.int32, [-2_000_000_000, -5, 1_000_000_000, 2_147_483_647])):
        rk = np.array(keys, dt)
        lk = np.array(keys[:1] + [keys[1] + 1, keys[2] - 7, keys[3], keys[2] + 1], dt)
        lk = np.concatenate([lk, rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, 40,
                                              dtype=np.int64).astype(dt)])
        rv = np.arange(len(keys), dtype=np.int32) + 100
        (jl, tl), (jrk, trk), (jv, tv) = both(lk), both(rk), both(rv)
        for tol in (None, 2**31 + 5, 3_000_000_000, 2**33 + 1):
            if tol is None and direction != "nearest":
                continue
            assert_same(jr.join_asof(jl, jrk, jv, direction=direction, tolerance=tol),
                        trst.join_asof(tl, trk, tv, direction=direction, tolerance=tol),
                        f"{dt} tol={tol}")


def test_join_asof_fill_and_empty_sides(rng):
    lk = rng.integers(0, 50, 30).astype(np.int32)
    rk = rng.integers(20, 40, 12).astype(np.int32)
    rv = col(rng, np.uint32, 12)
    (jl, tl), (jrk, trk), (jv, tv) = both(lk), both(rk), both(rv)
    assert_same(jr.join_asof(jl, jrk, jv, fill=7), trst.join_asof(tl, trk, tv, fill=7), "fill")
    for a, b, c, d in ((jl[:0], tl[:0], jrk, trk), (jl, tl, jrk[:0], trk[:0])):
        vj, vt = (jv[:0], tv[:0]) if c.shape[0] == 0 else (jv, tv)
        assert_same(jr.join_asof(a, c, vj, fill=3), trst.join_asof(b, d, vt, fill=3), "empty")


def test_join_asof_rejects_bad_input():
    a = torch.arange(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="direction"):
        trst.join_asof(a, a, a, direction="sideways")
    with pytest.raises(ValueError, match="share a dtype"):
        trst.join_asof(a, a.to(torch.int64), a)
    with pytest.raises(ValueError, match="length mismatch"):
        trst.join_asof(a, a, a[:4])
    with pytest.raises(ValueError, match=">= 0"):
        trst.join_asof(a, a, a, tolerance=-1)
    with pytest.raises(ValueError, match="<=32-bit"):
        trst.join_asof(a.to(torch.int64), a.to(torch.int64), a, direction="nearest")


# ---------------------------------------------------------------- set operators

SET_OPS = ["set_union", "set_intersect", "set_difference"]


@pytest.mark.parametrize("op", SET_OPS)
@pytest.mark.parametrize("kind", ["f32", "u64", "composite"])
def test_set_ops_match_reference(rng, op, kind):
    n_a, n_b = 150, 90
    if kind == "composite":
        pa = [col(rng, np.int8, 6), col(rng, np.float64, 6)]
        ia, ib = rng.integers(0, 6, n_a), rng.integers(0, 6, n_b)
        a = [pa[0][ia], pa[1][rng.permutation(ia)]]
        b = [pa[0][ib], pa[1][rng.permutation(ib)]]
    else:
        dt = np.float32 if kind == "f32" else np.uint64
        p = pool_draw(rng, dt, 60, 60)
        a, b = p[rng.integers(0, 40, n_a)], p[rng.integers(20, 60, n_b)]
    (ja, ta), (jb, tb) = both(a), both(b)
    assert_same(getattr(jrst, op)(ja, jb), getattr(trst, op)(ta, tb), f"{op} {kind}")


@pytest.mark.parametrize("op", ["union", "intersect", "difference"])
def test_set_op_valid_masks(rng, op):
    want = {"union": lambda ha, hb: ha | hb, "intersect": lambda ha, hb: ha & hb,
            "difference": lambda ha, hb: ha & ~hb}[op]
    a = rng.integers(0, 30, 80).astype(np.int16)
    b = rng.integers(10, 40, 60).astype(np.int16)
    av, bv = rng.random(80) < 0.6, rng.random(60) < 0.6
    (ja, ta), (jb, tb), (jav, tav), (jbv, tbv) = both(a), both(b), both(av), both(bv)
    assert_same(jr._set_op(ja, jb, want, jav, jbv), tr._set_op(ta, tb, want, tav, tbv), op)
    assert_same(jr._set_op([ja, ja], [jb, jb], want, jav, None),
                tr._set_op([ta, ta], [tb, tb], want, tav, None), f"{op} composite")


def test_set_ops_empty_and_errors():
    e = np.zeros(0, np.int32)
    (je, te) = both(e)
    assert_same(jrst.set_union(je, je), trst.set_union(te, te), "empty")
    assert_same(jrst.set_difference(je, both(np.arange(3, dtype=np.int32))[0]),
                trst.set_difference(te, torch.arange(3, dtype=torch.int32)), "one empty")
    a = torch.arange(3)
    with pytest.raises(ValueError, match="single columns or column lists"):
        trst.set_union([a], a)
    with pytest.raises(ValueError, match="column count"):
        trst.set_union([a], [a, a])
    with pytest.raises(ValueError, match="dtypes must match"):
        trst.set_union(a, a.to(torch.int32))
    with pytest.raises(ValueError, match="equal length"):
        trst.set_union([a, a[:2]], [a, a])


# ---------------------------------------------------------------- quantiles


@pytest.mark.parametrize("method", ["lower", "higher", "nearest"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint64, np.int8, np.float64])
def test_quantiles_match_reference(rng, method, dtype):
    x = pool_draw(rng, dtype, 257, 90)
    qs = [0.0, 0.1, 0.25, 0.5, 0.77, 0.999, 1.0]
    jx, tx = both(x)
    assert_same(jrst.quantiles(jx, qs, method=method),
                trst.quantiles(tx, qs, method=method), f"{dtype} {method}")
    assert tr.quantile_ranks(257, qs, method) == jr.quantile_ranks(257, qs, method)


def test_quantiles_errors():
    with pytest.raises(ValueError, match="empty"):
        trst.quantiles(torch.zeros(0), [0.5])
    with pytest.raises(ValueError, match="method"):
        trst.quantiles(torch.ones(3), [0.5], method="linear")
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        trst.quantiles(torch.ones(3), [1.5])
    assert trst.ASOF_DIRECTIONS == jrst.ASOF_DIRECTIONS
    assert tr.QUANTILE_METHODS == jr.QUANTILE_METHODS


def test_package_exports_match_reference():
    """The port exports every public name of the JAX package, and lists the
    ``nulls`` and ``dates`` modules beside ``strings`` (the JAX package has
    them as submodules only)."""
    assert set(jrst.__all__) == set(trst.__all__) - {"nulls", "dates"}
    assert all(hasattr(trst, name) for name in trst.__all__)
