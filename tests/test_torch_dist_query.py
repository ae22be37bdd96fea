"""Port parity: the distributed query operators (parallel/dist_query.py)
and the join's padding masks (ops/query.py ``valid_left`` /
``valid_right``).

The port's mesh is 4 CPU slots in one process. Most cases hold the result
against the JAX package's single-device operator (``hash_aggregate``,
``hash_join``, ``unique``, ``top_k``, ``repeat``) on the same seeded
inputs; joins, whose per-slot order is the routing's, compare multisets of
rows. The ``*_matches_jax_mesh`` cases hold the per-slot layout, counts and
overflow bit for bit against the JAX distributed function on a virtual
4-device mesh. Integers, orders, counts and flags are exact; float
aggregates differ at most by ULP(group sum) (the port's parity rule: the
summation order is the scatter's), as each test states.

Join capacities stay above 2**16 rows where the reference is called with
one (its Pallas expansion would otherwise run in interpret mode, ~10 s a
call); the port's expansion is K2's plain version on the CPU either way.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
from radix_sort_tpu.ops import query as jq  # noqa: E402
from radix_sort_tpu.parallel import dist_query as jdq  # noqa: E402
from radix_sort_tpu_torch.ops import query as tq  # noqa: E402
from radix_sort_tpu_torch.parallel import dist_query as tdq  # noqa: E402
from radix_sort_tpu_torch.parallel import runtime  # noqa: E402

P = 4
BIG = 1 << 17  # a join capacity past the reference's interpret-mode kernel gate


@pytest.fixture
def mesh():
    return runtime.data_mesh(P, device="cpu")


def jmesh():
    return JMesh(np.array(jax.devices()[:P]), ("x",))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def bits(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"u{a.dtype.itemsize}")


def rows(*cols_and_counts):
    """Multiset of joined rows (per-slot valid prefixes) as sorted tuples."""
    *cols, counts = cols_and_counts
    return sorted(zip(*(runtime.valid_rows(c, counts).numpy().tolist() for c in cols)))


def jrows(k, lv, rv, cnt):
    c = int(cnt)
    return sorted(zip(*(np.asarray(a)[:c].tolist() for a in (k, lv, rv))))


def ulp_bound(x, groups):
    """ULP of each group's sum of |x| (the parity rule for float sums)."""
    s = np.array([np.abs(x[g]).astype(np.float64).sum() for g in groups])
    return np.spacing(s.astype(x.dtype)).astype(np.float64) * 8


# ---------------------------------------------------------------- aggregates


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max", "any", "all"])
def test_combinable_matches_jax_single_device(rng, mesh, agg):
    n = P * 1024
    keys = rng.integers(0, 37, n).astype(np.uint32)
    vals = rng.integers(0, 1000, n).astype(np.uint32)
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate(t(keys), t(vals), mesh, agg,
                                                      max_groups=64)
    juk, jav, jcnt = jq.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals), agg)
    assert not bool(ovf) and int(cnt) == int(jcnt) == 37
    np.testing.assert_array_equal(uk.numpy()[:37], np.asarray(juk)[:37])
    np.testing.assert_array_equal(av.numpy()[:37], np.asarray(jav)[:37])


def test_single_mean_is_the_group_mean(rng, mesh):
    """``agg="mean"`` alone runs the sum-and-count plan: the group mean.
    The reference's single-mean path combines per-shard means and pads
    with -inf (ROADMAP.md Queue 3), so this holds the port to numpy."""
    n = P * 256
    k = rng.integers(0, 40, n).astype(np.uint32)
    v = rng.standard_normal(n).astype(np.float32)
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate(t(k), t(v), mesh, "mean",
                                                      max_groups=64)
    groups = np.unique(k)
    assert not bool(ovf) and int(cnt) == len(groups) and av.dtype == torch.float32
    np.testing.assert_array_equal(uk.numpy()[:len(groups)], groups)
    want = np.array([v[k == g].astype(np.float64).mean() for g in groups])
    np.testing.assert_allclose(av.numpy()[:len(groups)], want, rtol=0, atol=1e-5)


def test_overflow_flag_and_exact_truncation(mesh):
    n = P * 1024
    keys = np.arange(n, dtype=np.uint32)  # every row its own group
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate(t(keys), t(np.ones(n, np.uint32)), mesh,
                                                      "sum", max_groups=16)
    assert bool(ovf) and int(cnt) == P * 16
    np.testing.assert_array_equal(uk.numpy(), keys[:P * 16])


def test_max_groups_exceeds_shard_rows(rng, mesh):
    n = P * 4
    keys = rng.integers(0, 3, n).astype(np.uint32)
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate(t(keys), t(np.ones(n, np.uint32)), mesh,
                                                      "sum", max_groups=16)
    want = np.unique(keys)
    assert not bool(ovf) and int(cnt) == len(want)
    np.testing.assert_array_equal(uk.numpy()[:len(want)], want)


def test_composite_key_aggregate(rng, mesh):
    n = P * 512
    a = rng.integers(0, 5, n).astype(np.int32)
    b = rng.integers(0, 4, n, dtype=np.uint64)
    v = rng.integers(0, 100, n).astype(np.uint32)
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate([t(a), t(b)], t(v), mesh, "sum",
                                                      max_groups=32)
    juk, jav, jcnt = jq.hash_aggregate([jnp.asarray(a), jnp.asarray(b)], jnp.asarray(v), "sum")
    m = int(jcnt)
    assert not bool(ovf) and int(cnt) == m
    for g, w in zip(uk, juk):
        np.testing.assert_array_equal(g.numpy()[:m], np.asarray(w)[:m])
    np.testing.assert_array_equal(av.numpy()[:m], np.asarray(jav)[:m])


def test_multi_aggregate_mixed(rng, mesh):
    """sum, min, count and mean in one call; the float mean within the
    ULP(group sum) rule divided by the group size."""
    n = P * 512
    k = rng.integers(0, 12, n).astype(np.uint32)
    a = rng.integers(0, 1000, n).astype(np.uint32)
    b = rng.standard_normal(n).astype(np.float32)
    aggs = ["sum", "min", "count", "mean"]
    uk, outs, cnt, ovf = tdq.distributed_hash_aggregate(t(k), [t(a), t(b), t(a), t(b)], mesh,
                                                        aggs, max_groups=32)
    juk, jouts, jcnt = jq.hash_aggregate(jnp.asarray(k), [jnp.asarray(x) for x in (a, b, a, b)],
                                         aggs)
    m = int(jcnt)
    assert not bool(ovf) and int(cnt) == m
    np.testing.assert_array_equal(uk.numpy()[:m], np.asarray(juk)[:m])
    for got, want in zip(outs[:3], jouts[:3]):
        np.testing.assert_array_equal(bits(got.numpy()[:m]), bits(np.asarray(want)[:m]))
    groups = [k == g for g in np.unique(k)]
    size = np.array([g.sum() for g in groups])
    err = np.abs(outs[3].numpy()[:m].astype(np.float64) - np.asarray(jouts[3])[:m])
    assert (err <= ulp_bound(b, groups) / size + np.spacing(np.float32(1))).all()


def test_multi_aggregate_composite_keys(rng, mesh):
    n = P * 256
    ka = rng.integers(0, 3, n).astype(np.int32)
    kb = rng.integers(0, 4, n).astype(np.uint16)
    v = rng.integers(0, 50, n).astype(np.int32)
    uk, outs, cnt, ovf = tdq.distributed_hash_aggregate([t(ka), t(kb)], [t(v), t(v)], mesh,
                                                        ["max", "sum"], max_groups=16)
    juk, jouts, jcnt = jq.hash_aggregate([jnp.asarray(ka), jnp.asarray(kb)],
                                         [jnp.asarray(v)] * 2, ["max", "sum"])
    m = int(jcnt)
    assert not bool(ovf) and int(cnt) == m
    for got, want in zip([*uk, *outs], [*juk, *jouts]):
        np.testing.assert_array_equal(got.numpy()[:m], np.asarray(want)[:m])


def test_bad_aggregate_args(mesh):
    k = t(np.zeros(P * 8, np.uint32))
    with pytest.raises(ValueError, match="BOTH"):
        tdq.distributed_hash_aggregate(k, [k], mesh, "sum", max_groups=8)
    with pytest.raises(ValueError, match="equal-length"):
        tdq.distributed_hash_aggregate(k, [k, k], mesh, ["sum"], max_groups=8)
    with pytest.raises(ValueError, match="agg must be"):
        tdq.distributed_hash_aggregate(k, k, mesh, "avg", max_groups=8)


@pytest.mark.parametrize("agg", ["first", "last", "median", "var", "std", "count_distinct",
                                 "mode", "argmin", "argmax", "quantile:0.75"])
def test_holistic_matches_jax_single_device(rng, mesh, agg):
    n = P * 256
    keys = rng.integers(0, 37, n).astype(np.uint32)
    vals = rng.integers(-100, 100, n).astype(np.int32)
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate(t(keys), t(vals), mesh, agg,
                                                      max_groups=64, exchange_capacity_factor=4.0)
    juk, jav, jcnt = jq.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals), agg)
    c = int(jcnt)
    assert not bool(ovf) and int(cnt) == c
    np.testing.assert_array_equal(uk.numpy()[:c], np.asarray(juk)[:c])
    if agg in ("var", "std"):
        # two-pass float statistics: within a few ULP of the group's result
        np.testing.assert_allclose(av.numpy()[:c], np.asarray(jav)[:c], rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(av.numpy()[:c], np.asarray(jav)[:c])


def test_holistic_multi_with_combinable_member(rng, mesh):
    n = P * 256
    keys = rng.integers(0, 20, n).astype(np.uint32)
    v1 = rng.integers(0, 1000, n).astype(np.uint32)
    v2 = rng.integers(-50, 50, n).astype(np.int32)
    aggs = ["sum", "median", "first"]
    uk, outs, cnt, ovf = tdq.distributed_hash_aggregate(t(keys), [t(v1), t(v2), t(v2)], mesh,
                                                        aggs, max_groups=64,
                                                        exchange_capacity_factor=4.0)
    juk, jouts, jcnt = jq.hash_aggregate(jnp.asarray(keys),
                                         [jnp.asarray(x) for x in (v1, v2, v2)], aggs)
    c = int(jcnt)
    assert not bool(ovf) and int(cnt) == c
    for got, want in zip([uk, *outs], [juk, *jouts]):
        np.testing.assert_array_equal(got.numpy()[:c], np.asarray(want)[:c])


def test_holistic_composite_keys(rng, mesh):
    n = P * 256
    k1 = rng.integers(0, 3, n).astype(np.uint32)
    k2 = rng.integers(0, 11, n).astype(np.int32)
    v = rng.integers(0, 100, n).astype(np.int32)
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate([t(k1), t(k2)], t(v), mesh, "median",
                                                      max_groups=64, exchange_capacity_factor=4.0)
    juk, jav, jcnt = jq.hash_aggregate([jnp.asarray(k1), jnp.asarray(k2)], jnp.asarray(v),
                                       "median")
    c = int(jcnt)
    assert not bool(ovf) and int(cnt) == c
    for got, want in zip([*uk, av], [*juk, jav]):
        np.testing.assert_array_equal(got.numpy()[:c], np.asarray(want)[:c])


def test_holistic_groups_on_one_slot(rng, mesh):
    """One key: every row routes to one slot, the others receive nothing
    (empty slots in the shuffle plan, no overflow at factor 4)."""
    n = P * 64
    keys = np.full(n, 5, np.uint32)
    vals = rng.integers(0, 100, n).astype(np.int32)
    aggs = ["median", "first", "argmax"]
    uk, outs, cnt, ovf = tdq.distributed_hash_aggregate(t(keys), [t(vals)] * 3, mesh, aggs,
                                                        max_groups=8,
                                                        exchange_capacity_factor=4.0)
    juk, jouts, jcnt = jq.hash_aggregate(jnp.asarray(keys), [jnp.asarray(vals)] * 3, aggs)
    assert not bool(ovf) and int(cnt) == int(jcnt) == 1
    assert int(uk[0]) == 5
    for got, want in zip(outs, jouts):
        assert int(got[0]) == int(np.asarray(want)[0])


# ---------------------------------------------------------------- fallbacks


@pytest.mark.parametrize("case", ["combinable", "multi", "holistic_skew", "holistic_factor"])
def test_aggregate_fallbacks_are_exact(rng, mesh, case):
    """A breached ``max_groups`` or receive buffer runs the exact
    single-device aggregate; ``overflow`` stays False while the global
    capacity holds."""
    n = P * 128
    if case.startswith("holistic"):
        keys = np.full(n, 42, np.uint32)
        vals = rng.integers(0, 10_000, n).astype(np.uint32)
        factor = 1.0 if case == "holistic_factor" else 2.0
        uk, av, cnt, ovf = tdq.distributed_hash_aggregate(
            t(keys), t(vals), mesh, "median", max_groups=8, exchange_capacity_factor=factor)
        assert not bool(ovf) and int(cnt) == 1 and int(uk[0]) == 42
        assert int(av[0]) == np.sort(vals)[(n - 1) // 2]
        return
    keys = rng.integers(0, 60, n).astype(np.uint32)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    aggs = "sum" if case == "combinable" else ["sum", "mean", "count"]
    vs = t(vals) if case == "combinable" else [t(vals)] * 3
    uk, av, cnt, ovf = tdq.distributed_hash_aggregate(t(keys), vs, mesh, aggs, max_groups=16)
    want = np.unique(keys)
    assert not bool(ovf) and int(cnt) == len(want)
    np.testing.assert_array_equal(uk.numpy()[:len(want)], want)
    s = av if case == "combinable" else av[0]
    np.testing.assert_array_equal(s.numpy()[:len(want)],
                                  [vals[keys == u].sum() for u in want])
    if case == "multi":
        np.testing.assert_allclose(av[1].numpy()[:len(want)],
                                   [vals[keys == u].mean() for u in want], rtol=1e-6)
        np.testing.assert_array_equal(av[2].numpy()[:len(want)],
                                      [(keys == u).sum() for u in want])


# ---------------------------------------------------------------- filter, unique, top-k


def test_filter_matches_local_filter(rng, mesh):
    n = P * 512
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    m = rng.random(n) < 0.4
    xc, cnts = tdq.distributed_filter(t(m), t(x), mesh=mesh)
    assert cnts.dtype == torch.int32 and cnts.shape == (P,)
    np.testing.assert_array_equal(runtime.valid_rows(xc, cnts).numpy(), x[m])


@pytest.mark.parametrize("case", ["int32", "shard_local", "composite"])
def test_unique_matches_jax_single_device(rng, mesh, case):
    n = P * 1024
    if case == "int32":
        keys = rng.integers(0, 41, n).astype(np.int32)
    elif case == "shard_local":
        keys = (np.arange(n) // 1024 * 100 + rng.integers(0, 3, n)).astype(np.uint32)
    else:
        keys = [rng.integers(0, 6, n).astype(np.uint16),
                (rng.random(n) * 3).round().astype(np.float32)]
    tk = [t(k) for k in keys] if case == "composite" else t(keys)
    jk = [jnp.asarray(k) for k in keys] if case == "composite" else jnp.asarray(keys)
    uk, cts, num, ovf = tdq.distributed_unique(tk, mesh, max_unique=32)
    juk, jcts, jnum = jq.unique(jk)
    m = int(jnum)
    assert not bool(ovf) and int(num) == m
    for g, w in zip(uk if case == "composite" else [uk], juk if case == "composite" else [juk]):
        np.testing.assert_array_equal(g.numpy()[:m], np.asarray(w)[:m])
    np.testing.assert_array_equal(cts.numpy()[:m], np.asarray(jcts)[:m])


def test_unique_overflow_and_fallback(rng, mesh):
    keys = np.arange(P * 256, dtype=np.uint32)
    assert bool(tdq.distributed_unique(t(keys), mesh, max_unique=16)[3])
    keys = rng.integers(0, 50, P * 128).astype(np.uint32)  # > 16 a slot, < 64 in all
    uk, cts, num, ovf = tdq.distributed_unique(t(keys), mesh, max_unique=16)
    want, wc = np.unique(keys, return_counts=True)
    assert not bool(ovf) and int(num) == len(want)
    np.testing.assert_array_equal(uk.numpy()[:len(want)], want)
    np.testing.assert_array_equal(cts.numpy()[:len(want)], wc)


@pytest.mark.parametrize("largest", [True, False])
def test_top_k_matches_jax_single_device(rng, mesh, largest):
    n = P * 1024
    keys = rng.integers(0, 200, n).astype(np.int32)  # heavy ties
    vals = np.arange(n, dtype=np.uint32)
    tk, tv = tdq.distributed_top_k(t(keys), 100, t(vals), mesh=mesh, largest=largest)
    jk, jv = jrst.top_k(jnp.asarray(keys), 100, jnp.asarray(vals), largest=largest)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_top_k_edge_cases(rng, mesh):
    keys = rng.integers(0, 1 << 30, P * 64).astype(np.uint32)
    (tk,) = tdq.distributed_top_k(t(keys), 200, mesh=mesh)  # k > rows a slot
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jrst.top_k(jnp.asarray(keys), 200)[0]))
    f = (rng.random(P * 128) * 2 - 1).astype(np.float32)
    f[[3, 77, 200, 400]] = [np.nan, np.inf, -np.inf, -0.0]
    (tk,) = tdq.distributed_top_k(t(f), 16, mesh=mesh)
    np.testing.assert_array_equal(bits(tk.numpy()), bits(jrst.top_k(jnp.asarray(f), 16)[0]))
    a = rng.integers(0, 4, P * 512).astype(np.int32)
    b = rng.standard_normal(P * 512).astype(np.float32)
    v = np.arange(P * 512, dtype=np.uint32)
    for largest in (True, False):
        (ta, tb), tv = tdq.distributed_top_k([t(a), t(b)], 37, t(v), mesh=mesh, largest=largest)
        (ja, jb), jv = jrst.top_k([jnp.asarray(a), jnp.asarray(b)], 37, jnp.asarray(v),
                                  largest=largest)
        for g, w in ((ta, ja), (tb, jb), (tv, jv)):
            np.testing.assert_array_equal(bits(g.numpy()), bits(w))
    with pytest.raises(ValueError, match="k must be"):
        tdq.distributed_top_k(t(keys), P * 64 + 1, mesh=mesh)


# ---------------------------------------------------------------- joins


def _join_inputs(rng, n, lhi=300, rhi=150):
    return (rng.integers(0, lhi, n).astype(np.uint32), rng.integers(0, 2**31, n).astype(np.uint32),
            rng.integers(0, rhi, n).astype(np.uint32), rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
def test_join_matches_jax_single_device(rng, mesh, how):
    n = P * 128
    lk, lv, rk, rv = _join_inputs(rng, n)
    jk, jlv, jrv, cnts, ovf = tdq.distributed_hash_join(
        t(lk), t(lv), t(rk), t(rv), mesh, capacity_per_shard=n * 8, how=how,
        exchange_capacity_factor=6.0)
    assert not bool(ovf) and cnts.dtype == torch.int32
    want = jq.hash_join(*map(jnp.asarray, (lk, lv, rk, rv)), capacity=BIG, how=how)
    assert rows(jk, jlv, jrv, cnts) == jrows(*want[:4])


def test_join_skewed_keys(rng, mesh):
    n = P * 128
    lk = (rng.integers(0, 4, n) * 1000).astype(np.uint32)
    rk = (rng.integers(0, 4, n) * 1000).astype(np.uint32)
    v = np.ones(n, np.uint32)
    _, _, _, cnts, ovf = tdq.distributed_hash_join(
        t(lk), t(v), t(rk), t(v), mesh, capacity_per_shard=n * n // 2,
        exchange_capacity_factor=10.0)
    assert not bool(ovf)
    assert int(cnts.sum()) == sum(int((lk == k).sum()) * int((rk == k).sum())
                                  for k in np.unique(lk))


@pytest.mark.parametrize("how", ["inner", "semi", "anti", "full"])
def test_composite_join_matches_jax_single_device(rng, mesh, how):
    n = P * 256
    la, lb = rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 3, n, dtype=np.uint64)
    ra, rb = rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 3, n, dtype=np.uint64)
    lv = np.arange(n, dtype=np.uint32)
    rv = np.arange(n, dtype=np.uint32) + 50_000
    (ka, kb), olv, orv, cnts, ovf = tdq.distributed_hash_join(
        [t(la), t(lb)], t(lv), [t(ra), t(rb)], t(rv), mesh, capacity_per_shard=1 << 19,
        how=how)
    assert not bool(ovf)
    (wa, wb), wlv, wrv, wc, wo = jrst.hash_join(
        [jnp.asarray(la), jnp.asarray(lb)], jnp.asarray(lv), [jnp.asarray(ra), jnp.asarray(rb)],
        jnp.asarray(rv), capacity=P * (1 << 19), how=how)
    c = int(wc)
    want = sorted(zip(*(np.asarray(a)[:c].tolist() for a in (wa, wb, wlv, wrv))))
    assert rows(ka, kb, olv, orv, cnts) == want


@pytest.mark.parametrize("case", ["all_equal", "one_hot", "full_outer"])
def test_join_skew_fallback_is_exact(rng, mesh, case):
    """A hot key overflows one slot's exchange buffer: the exact
    single-device join runs and is laid out per slot; ``overflow`` stays
    False."""
    n = P * 32
    how = "full" if case == "full_outer" else "inner"
    if case == "one_hot":
        lk = rng.integers(100, 2**30, n).astype(np.uint32)
        rk = lk[rng.permutation(n)].copy()
        lk[:n // 2] = 5
        rk[:n // 2] = 5
    else:
        lk = np.full(n, 9, np.uint32)
        rk = np.full(n, 9, np.uint32)
        if case == "full_outer":
            lk[:8] = np.arange(8)
            rk[:8] = np.arange(50, 58)
    lv = np.arange(1, n + 1, dtype=np.uint32)
    rv = np.arange(1, n + 1, dtype=np.uint32) + 1_000_000
    jk, jlv, jrv, cnts, ovf = tdq.distributed_hash_join(
        t(lk), t(lv), t(rk), t(rv), mesh, capacity_per_shard=n * n // P, how=how)
    assert not bool(ovf)
    ref = [(k, a, b) for k, a in zip(lk.tolist(), lv.tolist())
           for k2, b in zip(rk.tolist(), rv.tolist()) if k == k2]
    if how == "full":
        ref += [(k, a, 0) for k, a in zip(lk.tolist(), lv.tolist()) if (rk != k).all()]
        ref += [(k, 0, b) for k, b in zip(rk.tolist(), rv.tolist()) if (lk != k).all()]
    assert rows(jk, jlv, jrv, cnts) == sorted(ref)


def test_join_truncation_still_flags(mesh):
    n = P * 16
    k = t(np.full(n, 3, np.uint32))
    v = t(np.ones(n, np.uint32))
    assert bool(tdq.distributed_hash_join(k, v, k, v, mesh, capacity_per_shard=128)[4])
    with pytest.raises(ValueError, match="how must be"):
        tdq.distributed_hash_join(k, v, k, v, mesh, capacity_per_shard=128, how="outer")


# ---------------------------------------------------------------- repeat, quantiles, set ops


def test_repeat_matches_jax_single_device_per_slot(rng, mesh):
    n = P * 256
    vals = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    f = rng.standard_normal(n)
    counts = rng.integers(0, 9, n).astype(np.int32)
    cap = 1024  # some slots overflow: their first cap rows stay exact
    ov, of, oc, ovf = tdq.distributed_repeat([t(vals), t(f)], t(counts), mesh,
                                             total_size_per_shard=cap)
    per = n // P
    trunc = False
    for s in range(P):
        sl = slice(s * per, (s + 1) * per)
        jv, jc, jo = jq.repeat(jnp.asarray(vals[sl]), jnp.asarray(counts[sl]), total_size=cap)
        assert int(oc[s]) == int(jc)
        trunc |= bool(jo)
        for got, src in ((ov, vals), (of, f)):
            want = np.repeat(src[sl], counts[sl])[:cap]
            np.testing.assert_array_equal(got.blocks[s].numpy()[:int(jc)], want)
        np.testing.assert_array_equal(ov.blocks[s].numpy(), np.asarray(jv))
    assert bool(ovf) == trunc


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_quantiles(rng, mesh, dtype):
    n = P * 512
    x = ((rng.random(n) * 100 - 50).astype(dtype) if dtype == np.float32
         else rng.integers(0, 1 << 30, size=n).astype(dtype))
    qs = [0.0, 0.1, 0.5, 0.99, 1.0]
    got = tdq.distributed_quantiles(t(x), qs, mesh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrst.quantiles(jnp.asarray(x), qs)))
    same = tdq.distributed_quantiles(t(np.full(n, 0xABCD1234, np.uint32)), [0, 0.5, 1], mesh)
    np.testing.assert_array_equal(same.numpy(), [0xABCD1234] * 3)


@pytest.mark.parametrize("dtype", [np.uint32, np.int16])
def test_set_ops_match_numpy(rng, mesh, dtype):
    n = P * 512
    a = rng.integers(0, 60, size=n).astype(dtype)
    b = rng.integers(30, 90, size=n).astype(dtype)
    for fn, oracle in ((tdq.distributed_set_union, np.union1d(a, b)),
                       (tdq.distributed_set_intersect, np.intersect1d(a, b)),
                       (tdq.distributed_set_difference, np.setdiff1d(a, b))):
        keys, cnt, ovf = fn(t(a), t(b), mesh, max_unique=128)
        assert not bool(ovf)
        np.testing.assert_array_equal(keys.numpy()[:int(cnt)], oracle)


def test_set_ops_composite_overflow_and_fallback(rng, mesh):
    n = P * 128
    a = [rng.integers(0, 5, n).astype(np.uint32), rng.integers(0, 5, n).astype(np.int32)]
    b = [rng.integers(2, 7, n).astype(np.uint32), rng.integers(2, 7, n).astype(np.int32)]
    keys, cnt, ovf = tdq.distributed_set_intersect([t(x) for x in a], [t(x) for x in b], mesh,
                                                   max_unique=64)
    assert not bool(ovf)
    got = list(zip(*(k.numpy()[:int(cnt)].tolist() for k in keys)))
    assert got == sorted(set(zip(*(x.tolist() for x in a))) & set(zip(*(x.tolist() for x in b))))
    u = np.arange(P * 64, dtype=np.uint32)
    assert bool(tdq.distributed_set_union(t(u), t(u), mesh, max_unique=8)[2])
    a = rng.integers(0, 48, P * 32).astype(np.uint32)
    b = rng.integers(24, 72, P * 32).astype(np.uint32)
    # about 24 distinct keys a slot overflow max_unique; the 72 of the union
    # fit the gathered 2 x 4 x 12 rows, so the fallback is exact
    keys, cnt, ovf = tdq.distributed_set_union(t(a), t(b), mesh, max_unique=12)
    assert not bool(ovf)
    np.testing.assert_array_equal(keys.numpy()[:int(cnt)], np.union1d(a, b))


# ---------------------------------------------------------------- against the JAX mesh


def _sharded_same(j, x):
    np.testing.assert_array_equal(bits(runtime.gather_rows(x).numpy()), bits(j))


@pytest.mark.parametrize("how", ["inner", "full"])
def test_join_matches_jax_mesh(rng, mesh, how):
    n = P * 128
    lk, lv, rk, rv = _join_inputs(rng, n, 200, 150)
    jm = jmesh()
    jout = jax.jit(lambda *a: jdq.distributed_hash_join(
        *a, jm, capacity_per_shard=BIG, how=how, exchange_capacity_factor=6.0))(
        *map(jnp.asarray, (lk, lv, rk, rv)))
    tout = tdq.distributed_hash_join(t(lk), t(lv), t(rk), t(rv), mesh, capacity_per_shard=BIG,
                                     how=how, exchange_capacity_factor=6.0)
    for j, x in zip(jout[:3], tout[:3]):
        _sharded_same(j, x)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert bool(tout[4]) == bool(jout[4])


@pytest.mark.parametrize("agg", [["sum", "count", "max"], "median"])
def test_aggregate_matches_jax_mesh(rng, mesh, agg):
    n = P * 256
    k = rng.integers(0, 40, n).astype(np.uint32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    jm = jmesh()
    vs = [v] * 3 if isinstance(agg, list) else v

    def jf(kk, vv):
        vals = [vv] * 3 if isinstance(agg, list) else vv
        return jdq.distributed_hash_aggregate(kk, vals, jm, agg, max_groups=64)

    juk, jav, jc, jo = jax.jit(jf)(jnp.asarray(k), jnp.asarray(v))
    tuk, tav, tc, to = tdq.distributed_hash_aggregate(
        t(k), [t(x) for x in vs] if isinstance(agg, list) else t(v), mesh, agg, max_groups=64)
    assert int(tc) == int(jc) and bool(to) == bool(jo)
    np.testing.assert_array_equal(tuk.numpy(), np.asarray(juk))
    for g, w in zip(tav if isinstance(agg, list) else [tav],
                    jav if isinstance(agg, list) else [jav]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unique_and_set_op_match_jax_mesh(rng, mesh):
    n = P * 256
    a = rng.integers(0, 30, n).astype(np.int32)
    b = rng.integers(10, 50, n).astype(np.int32)
    jm = jmesh()
    ju = jax.jit(lambda x: jdq.distributed_unique(x, jm, max_unique=64))(jnp.asarray(a))
    tu = tdq.distributed_unique(t(a), mesh, max_unique=64)
    for j, x in zip(ju, tu):
        np.testing.assert_array_equal(x.numpy(), np.asarray(j))
    js = jax.jit(lambda x, y: jdq.distributed_set_difference(x, y, jm, max_unique=64))(
        jnp.asarray(a), jnp.asarray(b))
    ts = tdq.distributed_set_difference(t(a), t(b), mesh, max_unique=64)
    c = int(js[1])
    assert int(ts[1]) == c and bool(ts[2]) == bool(js[2])
    np.testing.assert_array_equal(ts[0].numpy()[:c], np.asarray(js[0])[:c])


# ---------------------------------------------------------------- padding masks


MSB = np.uint32(1 << 31)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "full"])
def test_join_expand_padding_masks_match_reference(rng, how):
    """``join_expand(valid_left=)`` and ``append_unmatched_right(valid_left=,
    valid_right=)`` against the reference on the same limbs: padding rows
    emit nothing and never count as matched."""
    n_l, n_r, cap = 96, 80, 512
    rk = np.sort(rng.integers(0, 40, n_r).astype(np.uint32))
    rv = rng.integers(0, 2**31, n_r).astype(np.int32)
    lk = rng.integers(0, 50, n_l).astype(np.uint32)
    lv = rng.integers(0, 2**31, n_l).astype(np.int32)
    lo = np.searchsorted(rk, lk, "left").astype(np.int32)
    hi = np.searchsorted(rk, lk, "right").astype(np.int32)
    vl = rng.random(n_l) < 0.7
    vr = np.arange(n_r) < 64
    hi = np.minimum(hi, 64)
    lo = np.minimum(lo, hi)
    jl = jq.join_expand(jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rv), jnp.asarray(lo),
                        jnp.asarray(hi), capacity=cap, how=how, valid_left=jnp.asarray(vl))
    tlk = t((lk ^ MSB).view(np.int32))
    tl = tq.join_expand(tlk, t(lv), t(rv), t(lo), t(hi), capacity=cap, how=how,
                        valid_left=t(vl))
    if how == "full":
        jl = jq.append_unmatched_right([jl[0]], jl[1], jl[2], jl[3], jl[4], [jnp.asarray(rk)],
                                       jnp.asarray(rv), jnp.asarray(lo), jnp.asarray(hi),
                                       capacity=cap, valid_left=jnp.asarray(vl),
                                       valid_right=jnp.asarray(vr))
        tl = tq.append_unmatched_right([tl[0]], tl[1], tl[2], tl[3], tl[4],
                                       [t((rk ^ MSB).view(np.int32))], t(rv), t(lo), t(hi),
                                       capacity=cap, valid_left=t(vl), valid_right=t(vr))
        jl, tl = (jl[0][0], *jl[1:]), (tl[0][0], *tl[1:])
    c = int(jl[3])
    assert int(tl[3]) == c and bool(tl[4]) == bool(jl[4])
    assert c == int(tl[3]) and c > 0
    np.testing.assert_array_equal(tl[0].numpy()[:c].view(np.uint32) ^ MSB, np.asarray(jl[0])[:c])
    for g, w in zip(tl[1:3], jl[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # no padding row contributes: the masked result is the unpadded one
    keep = tq.join_expand(tlk[t(vl)], t(lv[vl]), t(rv[:64]), t(lo[vl]), t(hi[vl]),
                          capacity=cap, how="left" if how == "full" else how)
    assert int(keep[3]) <= c
