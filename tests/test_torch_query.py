"""Port parity: the join slice of the query operators (ops/query.py).

The same seeded numpy inputs go through the JAX package and the port on the
CPU; every output -- values, padding tails, counts and overflow flags --
must agree bit for bit (floats by their bits). In the port every inner and
left join expansion and every ``repeat`` runs kernel K2's whole-row expansion
(its plain version on the CPU); the reference picks a gather formulation
or its Pallas kernel (interpret mode here) by fanout, so both reference
routes are compared: fanout 20 at a capacity of at most 2**16 takes the
reference's kernel.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
import radix_sort_tpu_torch as trst  # noqa: E402
from radix_sort_tpu import keys as jk  # noqa: E402
from radix_sort_tpu.ops import query as jq  # noqa: E402
from radix_sort_tpu_torch import keys as tk  # noqa: E402
from radix_sort_tpu_torch.ops import expand as tx  # noqa: E402
from radix_sort_tpu_torch.ops import query as tq  # noqa: E402


def bits(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"u{a.dtype.itemsize}")


def assert_same(j, t, what=""):
    """A JAX result against the port's, recursively over tuples and lists."""
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), what
        for i, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{what}[{i}]")
        return
    ja, ta = np.asarray(j), t.numpy()
    assert ja.shape == ta.shape, (what, ja.shape, ta.shape)
    if ja.shape == ():  # counts and flags: same value, the port's own dtype
        assert ja.item() == ta.item() and ta.dtype in (np.int32, np.bool_), (what, ja, ta)
        return
    assert ja.dtype == ta.dtype, (what, ja.dtype, ta.dtype)
    np.testing.assert_array_equal(bits(ta), bits(ja), err_msg=what)


def both(x):
    """(JAX array, torch tensor) of one numpy array, or of a list of them."""
    if isinstance(x, list):
        return [jnp.asarray(a) for a in x], [torch.from_numpy(a.copy()) for a in x]
    return jnp.asarray(x), torch.from_numpy(x.copy())


def col(rng, dtype, n):
    """A column of every bit pattern of ``dtype`` (NaNs and -0.0 included)."""
    dtype = np.dtype(dtype)
    return rng.integers(0, 256, n * dtype.itemsize, dtype=np.uint8).view(dtype).copy()


F32_SPECIALS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00000, 0x7F800001, 0xFFFFFFFF], np.uint32).view(np.float32)


# ---------------------------------------------------------------- filter


def test_filter_matches_reference(rng):
    n = 300
    arrays = [col(rng, np.uint32, n), col(rng, np.float64, n), rng.random(n) < 0.5,
              col(rng, np.int16, n), col(rng, np.uint64, n)]
    mask = rng.random(n) < 0.4
    jm, tm = both(mask)
    ja, ta = both(arrays)
    assert_same(jq.filter(jm, *ja), trst.filter(tm, *ta), "filter")


# ---------------------------------------------------------------- searchsorted


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n_q", [10, 300])  # the binary-search and merge-rank branches
@pytest.mark.parametrize("dtype", [np.float32, np.uint64])
def test_searchsorted_matches_reference(rng, side, n_q, dtype):
    pool = col(rng, dtype, 40)
    if dtype == np.float32:
        pool[:len(F32_SPECIALS)] = F32_SPECIALS
    data = np.asarray(jrst.sort(jnp.asarray(pool[rng.integers(0, 40, 400)])))
    queries = pool[rng.integers(0, 40, n_q)]
    queries[:3] = col(rng, dtype, 3)  # keys absent from the data
    jd, td = both(data)
    jqy, tqy = both(queries)
    assert_same(jq.searchsorted(jd, jqy, side=side),
                trst.searchsorted(td, tqy, side=side), "searchsorted")


def test_searchsorted_empty_queries():
    out = trst.searchsorted(torch.arange(5), torch.zeros((0,), dtype=torch.int64))
    assert out.dtype == torch.int32 and out.shape == (0,)


# ---------------------------------------------------------------- unique


@pytest.mark.parametrize("kind", ["u32", "f32", "composite", "empty"])
def test_unique_matches_reference(rng, kind):
    n = 0 if kind == "empty" else 500
    if kind == "f32":
        pool = col(rng, np.float32, 30)
        pool[:len(F32_SPECIALS)] = F32_SPECIALS
        keys = pool[rng.integers(0, 30, n)]
    elif kind == "composite":
        keys = [col(rng, np.uint64, 20)[rng.integers(0, 20, n)],
                rng.integers(-3, 3, n).astype(np.int32)]
    else:
        keys = rng.integers(0, 80, n).astype(np.uint32)
    jkeys, tkeys = both(keys)
    assert_same(jq.unique(jkeys), trst.unique(tkeys), "unique")


# ---------------------------------------------------------------- merge rank


def _limbs(cols):
    """(JAX uint32 limbs, port int32 limbs) of the same key columns."""
    j = [w for c in cols for w in jk.encode_limbs(jnp.asarray(c))]
    t = [w for c in cols for w in tk.encode_limbs(torch.from_numpy(c.copy()))]
    return j, t


@pytest.mark.parametrize("case", ["single_few", "single_merge", "composite"])
def test_merge_rank_pair_matches_reference(rng, case):
    n_d, n_q = 400, (10 if case == "single_few" else 300)
    if case == "composite":
        pool = [col(rng, np.uint64, 30), rng.integers(-2, 2, 30).astype(np.int32)]
    else:
        pool = [col(rng, np.uint32, 30)]
    d_idx = np.sort(rng.integers(0, 30, n_d))
    data = [c[d_idx] for c in pool]
    order = np.lexsort([jnp.asarray(w) for w in reversed(_limbs(data)[0])])
    data = [c[order] for c in data]  # ascending in the limbs' order
    queries = [c[rng.integers(0, 30, n_q)] for c in pool]
    queries[0][:4] = col(rng, queries[0].dtype, 4)
    jd, td = _limbs(data)
    jqy, tqy = _limbs(queries)
    if len(jd) == 1:
        jd, td, jqy, tqy = jd[0], td[0], jqy[0], tqy[0]
    assert_same(jq.merge_rank_pair(jd, jqy), tq.merge_rank_pair(td, tqy), "merge_rank_pair")
    for side in ("left", "right"):
        assert_same(jq.merge_rank(jd, jqy, side), tq.merge_rank(td, tqy, side), side)


# ---------------------------------------------------------------- repeat


@pytest.mark.parametrize("case", [
    "mixed",        # zero, negative and over-capacity counts (reference: gather)
    "int32_wrap",   # counts [2**30]*3: the reference's int32 running sum wraps
    "fanout_100",   # long runs, past the size where the reference's kernel engages
    "wide_dtypes",  # i64, f64 and i16 values
    "empty",
])
def test_repeat_matches_reference(rng, case):
    if case == "mixed":
        values = col(rng, np.int32, 50)
        counts = rng.integers(-3, 6, 50).astype(np.int32)
        counts[7] = 10**6
        sizes = [40, 400]
    elif case == "int32_wrap":
        values, counts, sizes = np.array([5, 6, 7], np.int32), np.full(3, 2**30, np.int32), [64]
    elif case == "fanout_100":
        values = col(rng, np.uint32, 700)
        counts = rng.integers(0, 201, 700).astype(np.int32)
        sizes = [(1 << 16) + 8]
    elif case == "wide_dtypes":
        counts = rng.integers(0, 4, 30).astype(np.int64)
        values = None
        sizes = [64, 200]
    else:
        values, counts, sizes = np.zeros(0, np.float32), np.zeros(0, np.int32), [8]
    for total_size in sizes:
        for v in ([values] if values is not None else
                  [col(rng, np.int64, 30), col(rng, np.float64, 30), col(rng, np.int16, 30)]):
            jv, tv = both(v)
            jc, tc = both(counts)
            assert_same(jq.repeat(jv, jc, total_size=total_size),
                        trst.repeat(tv, tc, total_size=total_size), f"{case} {total_size}")


def test_repeat_long_counts_match_numpy(rng):
    """Counts above 2048 at high fanout, against ``np.repeat``: the
    reference's kernel route writes only the first 2048 rows of such a run
    (tests/test_torch_expand.py), so the JAX package is no oracle here."""
    values = col(rng, np.int32, 6)
    counts = np.array([3000, 0, 5, 2049, 1, 70_000], np.int64)
    out, count, overflow = trst.repeat(torch.from_numpy(values), torch.from_numpy(counts),
                                       total_size=1 << 16)
    want = np.repeat(values, counts)[:1 << 16]
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(count) == 1 << 16 and bool(overflow)


def test_expand_rows_moves_several_columns(rng):
    cols = [col(rng, np.uint64, 20), col(rng, np.float32, 20), col(rng, np.int8, 20)]
    counts = rng.integers(0, 5, 20).astype(np.int32)
    jc, tc = both(cols)
    jn, tn = both(counts)
    before = tx.LAUNCHES
    assert_same(jq._expand_rows(jc, jn, 48), tq._expand_rows(tc, tn, 48), "_expand_rows")
    assert tx.LAUNCHES == before  # CPU tensors never reach the CUDA kernel


# ---------------------------------------------------------------- hash_join

HOWS = list(jq.JOIN_HOWS) + ["lookup"]
CAPACITY = {1: 256, 4: 256, 20: 2048}  # fanout 20: the reference's kernel route


def _join_inputs(rng, fanout, n_l=40, n_keys=50):
    lk = rng.integers(0, n_keys, n_l).astype(np.uint32)
    rk = rng.integers(0, n_keys, n_l * fanout).astype(np.uint32)
    lv = col(rng, np.int32, n_l)
    rv = col(rng, np.float32, n_l * fanout)
    return lk, lv, rk, rv


def _both_joins(lk, lv, rk, rv, **kw):
    j = jq.hash_join(*[both(x)[0] for x in (lk, lv, rk, rv)], **kw)
    t = trst.hash_join(*[both(x)[1] for x in (lk, lv, rk, rv)], **kw)
    return j, t


@pytest.mark.parametrize("how,fanout", [(h, f) for h in HOWS for f in (1, 4)]
                         + [("inner", 20), ("left", 20)])
def test_hash_join_matches_reference(rng, how, fanout):
    j, t = _both_joins(*_join_inputs(rng, fanout), capacity=CAPACITY[fanout], how=how)
    assert_same(j, t, f"{how} fanout {fanout}")


def test_hash_join_lookup_unique_right(rng):
    lk = rng.integers(0, 80, 60).astype(np.uint32)
    rk = rng.permutation(80)[:50].astype(np.uint32)
    lv, rv = col(rng, np.int32, 60), col(rng, np.float64, 50)
    for capacity in (64, 20):  # the second overflows
        j, t = _both_joins(lk, lv, rk, rv, capacity=capacity, how="lookup")
        assert_same(j, t, f"lookup capacity {capacity}")


@pytest.mark.parametrize("how", HOWS)
def test_hash_join_composite_keys_list_payloads(rng, how):
    n_l, n_r = 40, 120
    pool = [col(rng, np.uint64, 12), rng.integers(-2, 2, 12).astype(np.int32)]
    li, ri = rng.integers(0, 12, n_l), rng.integers(0, 12, n_r)
    lk = [pool[0][li], pool[1][rng.permutation(li)]]
    rk = [pool[0][ri], pool[1][rng.permutation(ri)]]
    lv = [col(rng, np.int64, n_l), col(rng, np.float64, n_l)]
    rv = [col(rng, np.int16, n_r), col(rng, np.float64, n_r), col(rng, np.int64, n_r)]
    j, t = _both_joins(lk, lv, rk, rv, capacity=300, how=how)
    assert_same(j, t, how)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("side", ["left", "right", "both"])
def test_hash_join_empty_sides(rng, how, side):
    lk, lv, rk, rv = _join_inputs(rng, 2)
    if side in ("left", "both"):
        lk, lv = lk[:0], lv[:0]
    if side in ("right", "both"):
        rk, rv = rk[:0], rv[:0]
    j, t = _both_joins(lk, lv, rk, rv, capacity=32, how=how)
    assert_same(j, t, f"{how} empty {side}")


@pytest.mark.parametrize("how", ["inner", "left", "full", "semi"])
def test_hash_join_overflow(rng, how):
    j, t = _both_joins(*_join_inputs(rng, 4), capacity=20 if how == "semi" else 50, how=how)
    assert bool(t[4])
    assert_same(j, t, how)


def test_hash_join_j2_shape_left_join(rng):
    """CUSTOMER left join ORDERS as chip_smoke.py's J2 runs it, at a small
    size: i64 keys, i64 left values, f64 right values (one K2 launch on the
    card), a third of the customers without an order."""
    n_c, n_o = 90, 600
    ck = (rng.permutation(n_c) + 1).astype(np.int64)
    ok = rng.choice(ck[ck % 3 != 0], n_o).astype(np.int64)
    j, t = _both_joins(ck, rng.integers(-99_999, 10**6, n_c).astype(np.int64), ok,
                       col(rng, np.float64, n_o), capacity=1024, how="left")
    assert int(t[3]) == n_o + int((ck % 3 == 0).sum()) and not bool(t[4])
    assert_same(j, t, "J2 shape")


def test_hash_join_inner_long_unmatched_run(rng):
    """An inner join whose left side holds 20,000 consecutive unmatched rows
    (zero-emit runs, more than one kernel tile walks) between matched ones."""
    lk = np.concatenate([rng.integers(0, 40, 100), np.arange(1000, 21_000),
                         rng.integers(0, 40, 100)]).astype(np.uint32)
    rk = rng.integers(0, 40, 400).astype(np.uint32)
    j, t = _both_joins(lk, col(rng, np.int32, lk.shape[0]), rk, col(rng, np.float32, 400),
                       capacity=8192, how="inner")
    assert 0 < int(t[3]) < 8192
    assert_same(j, t, "long unmatched run")


def test_hash_join_int32_wrap(rng):
    """2.5e9 pairs of one key: the reference's int32 running sum wraps and
    its guard forces the overflow flag; the first rows stay exact."""
    n = 50_000
    keys = np.full(n, 7, np.uint32)
    j, t = _both_joins(keys, col(rng, np.int32, n), keys, col(rng, np.int32, n),
                       capacity=64, how="inner")
    assert bool(t[4]) and int(t[3]) == 64
    assert_same(j, t, "wrap")


def test_hash_join_rejects_bad_input():
    a = torch.arange(4)
    with pytest.raises(ValueError, match="how"):
        trst.hash_join(a, a, a, a, capacity=4, how="outer")
    with pytest.raises(ValueError, match="column lists"):
        trst.hash_join([a], a, a, a, capacity=4)
    with pytest.raises(ValueError, match="length mismatch"):
        trst.hash_join(a, a[:3], a, a, capacity=4)
