"""Port parity: the distributed sort (parallel/dist_sort.py).

The port's mesh here is 4 CPU slots in one process (2 and 8 once each).
Most cases hold the concatenated valid prefixes against the JAX package's
single-device ``sort_pairs`` (or a stable numpy sort) on the same seeded
inputs; the ``*_matches_jax_mesh`` cases hold the whole padded per-slot
layout, the per-slot counts and the overflow flag bit for bit against the
JAX distributed function on a virtual mesh of as many CPU devices (one
shape per dtype, under ``jax.jit``, so each compiles once). The reference
exchanges with its all-gather emulation there; the port has one exchange,
the exact-count one, and lands the same layout.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import radix_sort_tpu as jrst  # noqa: E402
from radix_sort_tpu import keys as jkeys  # noqa: E402
from radix_sort_tpu.parallel import dist_sort as jds  # noqa: E402
from radix_sort_tpu_torch import keys as tkeys  # noqa: E402
from radix_sort_tpu_torch.parallel import dist_sort as tds  # noqa: E402
from radix_sort_tpu_torch.parallel import runtime  # noqa: E402

P = 4


def tmesh(p=P):
    return runtime.data_mesh(p, device="cpu")


def jmesh(p=P):
    return JMesh(np.array(jax.devices()[:p]), ("x",))


def bits(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"u{a.dtype.itemsize}")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def collect(x, counts):
    """The concatenated valid prefixes, as numpy."""
    return runtime.valid_rows(x, counts).numpy()


def stable(keys):
    return np.argsort(keys, kind="stable")


def column(rng, dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        x[:6] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0]
        return rng.permutation(x)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, endpoint=True, dtype=dtype)


_JAX_SORT = jax.jit(lambda k, v: jrst.sort_pairs(k, v))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64, np.int8,
                                   np.int32, np.int64, np.float32, np.float64])
def test_sort_pairs_matches_jax_single_device(rng, dtype):
    n = P * 1024
    x = column(rng, dtype, n)
    v = np.arange(n, dtype=np.uint32)
    k, vals, counts, overflow = tds.distributed_sort_pairs(t(x), t(v), tmesh())
    assert not bool(overflow) and counts.dtype == torch.int32
    assert int(counts.sum()) == n
    assert int(counts.max()) <= tds.exchange_capacity(n // P, P)
    jk, jv = _JAX_SORT(jnp.asarray(x), jnp.asarray(v))
    np.testing.assert_array_equal(bits(collect(k, counts)), bits(jk))
    np.testing.assert_array_equal(collect(vals, counts), np.asarray(jv))


def _skew_cases(rng, n):
    yield "all_equal", np.full(n, 123456789, np.uint32)
    yield "two_values", np.where(rng.random(n) < 0.95, 7, 9).astype(np.uint32)
    step = (np.uint64(1) << np.uint64(32)) // np.uint64(5)
    yield "step_uniform", (rng.integers(0, 5, n).astype(np.uint64) * step).astype(np.uint32)
    yield "zipf", np.minimum(rng.zipf(1.3, size=n), 1 << 31).astype(np.uint32)
    yield "sorted_ascending", np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))
    yield "sorted_descending", np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))[::-1].copy()
    yield "all_sentinel", np.full(n, 0xFFFFFFFF, np.uint32)  # every key equals the padding


@pytest.mark.parametrize("case", range(7))
def test_skewed_distributions_sort_stably(rng, case):
    """Duplicate-heavy keys sort (keys alone and with a payload) without
    overflowing the provisioned capacity; equal keys keep input order
    across slot boundaries."""
    n = P * 2048
    name, keys = list(_skew_cases(rng, n))[case]
    mesh = tmesh()
    out, counts, overflow = tds.distributed_sort(t(keys), mesh)
    assert not bool(overflow), name
    np.testing.assert_array_equal(collect(out, counts), np.sort(keys, kind="stable"))
    vals = np.arange(n, dtype=np.uint32)
    k, v, counts, overflow = tds.distributed_sort_pairs(t(keys), t(vals), mesh)
    assert not bool(overflow), name
    assert int(counts.max()) <= tds.exchange_capacity(n // P, P)
    order = stable(keys)
    np.testing.assert_array_equal(collect(k, counts), keys[order], err_msg=name)
    np.testing.assert_array_equal(collect(v, counts), vals[order], err_msg=name)


@pytest.mark.parametrize("n_local", [1, 63, 64, 4096, 100_000, 62_500_000])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_exchange_capacity_is_the_reference_bound(n_local, p):
    cap = tds.exchange_capacity(n_local, p)
    assert cap == jds.exchange_capacity(n_local, p)
    assert cap >= n_local


def test_sample_positions_do_not_wrap():
    """The regular sample positions at 62.5M rows a slot and 128 samples
    (250M rows on 4 slots): int64 midpoints of the strides. The reference
    computes them in int32 and wraps there (ROADMAP.md Queue 3)."""
    n_local, m = 62_500_000, tds._num_samples(62_500_000, 4)
    got = tds._sample_positions(n_local, m, "cpu").numpy()
    want = np.arange(m, dtype=np.int64) * n_local // m + n_local // (2 * m)
    np.testing.assert_array_equal(got, want)
    assert 0 <= got.min() and got.max() < n_local


def test_forced_overflow_falls_back_exactly():
    """A capacity too small for the exchange still gives the exact stable
    sort (the replicated fallback), with ``overflow`` set."""
    n = P * 1024
    x = np.full(n, 42, np.uint32)
    mesh = tmesh()
    out, counts, overflow = tds.distributed_sort(t(x), mesh, capacity=n // P)
    assert bool(overflow)
    np.testing.assert_array_equal(collect(out, counts), x)
    k, v, counts, overflow = tds.distributed_sort_pairs(
        t(x), t(np.arange(n, dtype=np.uint32)), mesh, capacity=n // P)
    assert bool(overflow)
    np.testing.assert_array_equal(collect(v, counts), np.arange(n, dtype=np.uint32))


def test_bad_arguments_raise(rng):
    mesh = tmesh()
    x = t(rng.integers(0, 100, P * 128, dtype=np.uint32))
    with pytest.raises(ValueError, match="share a length"):
        tds.distributed_sort_pairs(x, t(np.zeros(P * 64, np.uint32)), mesh)
    with pytest.raises(ValueError, match="capacity"):
        tds.distributed_sort(x, mesh, capacity=64)
    with pytest.raises(ValueError, match="equal blocks"):
        tds.distributed_sort(t(np.zeros(P * 128 + 1, np.uint32)), mesh)
    # 2**31 rows (stride-0 views, nothing allocated): int32 position tiebreaks
    huge = torch.zeros(1, dtype=torch.int32).expand(1 << 31)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tds.distributed_sort(huge, mesh)


class TestMultiLimb:
    def test_multi_column_lexsort(self, rng):
        n = P * 2048
        a = rng.integers(0, 4, n).astype(np.int32)
        b = rng.standard_normal(n).astype(np.float32)
        cols, counts, overflow = tds.distributed_sort([t(a), t(b)], tmesh())
        assert not bool(overflow)
        order = np.lexsort((b, a))
        np.testing.assert_array_equal(collect(cols[0], counts), a[order])
        np.testing.assert_array_equal(collect(cols[1], counts), b[order])

    def test_all_equal_composite_balances(self):
        n = P * 1024
        a = np.full(n, 7, np.uint32)
        b = np.full(n, 9, np.uint64)
        cols, counts, overflow = tds.distributed_sort([t(a), t(b)], tmesh())
        assert not bool(overflow)
        assert int(counts.sum()) == n and int(counts.min()) > 0
        assert int(counts.max()) <= tds.exchange_capacity(n // P, P)
        np.testing.assert_array_equal(collect(cols[0], counts), a)
        np.testing.assert_array_equal(collect(cols[1], counts), b)

    def test_sort_pairs_composite_multi_value(self, rng):
        n = P * 1024
        a = rng.integers(0, 100, n, dtype=np.uint64)
        b = rng.integers(0, 3, n).astype(np.uint8)
        v1 = np.arange(n, dtype=np.uint32)
        v2 = rng.standard_normal(n).astype(np.float32)
        cols, vals, counts, overflow = tds.distributed_sort_pairs([t(a), t(b)], [t(v1), t(v2)],
                                                                  tmesh())
        assert not bool(overflow)
        order = np.lexsort((np.arange(n), b, a))
        for got, want in zip([*cols, *vals], [a, b, v1, v2]):
            np.testing.assert_array_equal(collect(got, counts), want[order])

    def test_sort_limbs_128bit(self, rng):
        n = P * 1024
        hi = rng.integers(0, 3, n, dtype=np.uint64)
        lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        limbs = tkeys.encode128(t(hi), t(lo), signed=False)
        out, _, counts, overflow = tds.distributed_sort_limbs(limbs, mesh=tmesh())
        assert not bool(overflow)
        ghi, glo = tkeys.decode128([runtime.valid_rows(w, counts) for w in out])
        order = np.lexsort((lo, hi))
        np.testing.assert_array_equal(ghi.numpy(), hi[order])
        np.testing.assert_array_equal(glo.numpy(), lo[order])

    def test_limbs_reject_unsigned(self):
        with pytest.raises(ValueError, match="signed rank-space"):
            tds.distributed_sort_limbs([torch.zeros(8, dtype=torch.uint32)], mesh=tmesh())
        with pytest.raises(ValueError, match="non-empty"):
            tds.distributed_sort_limbs([], mesh=tmesh())


@pytest.mark.parametrize("nk", [1, 2])
def test_below_starts_lexicographic_oracle(rng, nk):
    """Run starts: the count of rows below each (limbs..., position)
    splitter equals the numpy lexicographic rank (one word takes the
    searchsorted route, two the compare-sum), and the compare-sum gives
    the same counts for every width."""
    n, p, base = 512, 8, 3 * 512
    cols = [rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 6, n).astype(np.int32)][:nk]
    order = np.lexsort(tuple(reversed(cols)))
    s = [c[order] for c in cols]
    sw = [rng.integers(0, 6, p - 1).astype(np.int32) for _ in range(nk)]
    sp = rng.integers(base, base + n, p - 1).astype(np.int32)
    starts = tds._below_starts([t(c) for c in s], base, [t(w) for w in sw], t(sp)).numpy()
    gpos = base + np.arange(n)
    for j in range(p - 1):
        below = gpos < sp[j]
        for c, w in zip(reversed(s), reversed(sw)):
            below = (c < w[j]) | ((c == w[j]) & below)
        assert starts[j + 1] == below.sum()
    assert starts[0] == 0
    counts = tds._below_counts([t(c) for c in s], base, [t(w) for w in sw], t(sp).long())
    np.testing.assert_array_equal(counts.numpy(), starts[1:])


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
def test_descending(rng, dtype):
    n = P * 1024
    x = (rng.standard_normal(n).astype(dtype) if np.dtype(dtype).kind == "f"
         else rng.integers(0, 100, n, dtype=dtype))
    v = np.arange(n, dtype=np.uint32)
    out, vals, counts, overflow = tds.distributed_sort_pairs(t(x), t(v), tmesh(),
                                                             descending=True)
    assert not bool(overflow)
    order = np.argsort(-x.astype(np.float64) if np.dtype(dtype).kind == "f" else x.max() - x,
                       kind="stable")
    np.testing.assert_array_equal(collect(out, counts), x[order])
    np.testing.assert_array_equal(collect(vals, counts), v[order])


def test_descending_composite(rng):
    n = P * 512
    a = rng.integers(0, 5, n).astype(np.int32)
    b = rng.integers(0, 7, n).astype(np.uint32)
    cols, counts, overflow = tds.distributed_sort([t(a), t(b)], tmesh(), descending=True)
    assert not bool(overflow)
    order = np.lexsort((-b.astype(np.int64), -a.astype(np.int64)))
    np.testing.assert_array_equal(collect(cols[0], counts), a[order])
    np.testing.assert_array_equal(collect(cols[1], counts), b[order])


# ---------------------------------------------------------------- against the JAX mesh


def _same_layout(jout, tout):
    """(keys, values, counts, overflow) of both packages, bit for bit: the
    whole padded per-slot layout, the counts and the flag."""
    jk, jv, jc, jo = jout
    tk, tv, tc, to = tout
    for j, x in zip(jk if isinstance(jk, list) else [jk], tk if isinstance(tk, list) else [tk]):
        np.testing.assert_array_equal(bits(runtime.gather_rows(x).numpy()), bits(j))
    if jv is not None:
        for j, x in zip(jv if isinstance(jv, list) else [jv],
                        tv if isinstance(tv, list) else [tv]):
            np.testing.assert_array_equal(bits(runtime.gather_rows(x).numpy()), bits(j))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert bool(to) == bool(jo)


def _jax_pairs(p, **kw):
    mesh = jmesh(p)
    return jax.jit(lambda k, v: jds.distributed_sort_pairs(k, v, mesh, **kw))


@pytest.mark.parametrize("dtype,kw", [
    (np.uint32, {}),
    (np.uint64, {"descending": True}),
    (np.float32, {}),
    (np.uint32, {"capacity": 1024}),
])
def test_sort_pairs_matches_jax_mesh(rng, dtype, kw):
    n = P * 1024
    x = column(rng, dtype, n) if dtype != np.uint32 else rng.integers(0, 50, n).astype(dtype)
    v = np.arange(n, dtype=np.uint32)
    jout = _jax_pairs(P, **kw)(jnp.asarray(x), jnp.asarray(v))
    tout = tds.distributed_sort_pairs(t(x), t(v), tmesh(), **kw)
    _same_layout(jout, tout)
    if "capacity" in kw:
        assert bool(tout[3])  # the fallback ran


@pytest.mark.parametrize("p", [2, 8])
def test_sort_pairs_matches_jax_mesh_sizes(rng, p):
    n = p * 1024
    x = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    v = rng.standard_normal(n).astype(np.float32)
    _same_layout(_jax_pairs(p)(jnp.asarray(x), jnp.asarray(v)),
                 tds.distributed_sort_pairs(t(x), t(v), tmesh(p)))


def test_composite_sort_matches_jax_mesh(rng):
    n = P * 512
    a = rng.integers(0, 3, n).astype(np.int32)
    b = rng.integers(0, 1 << 40, n, dtype=np.uint64)
    mesh = jmesh()
    jc, jcnt, jo = jax.jit(lambda x, y: jds.distributed_sort([x, y], mesh))(
        jnp.asarray(a), jnp.asarray(b))
    tc, tcnt, to = tds.distributed_sort([t(a), t(b)], tmesh())
    _same_layout((jc, None, jcnt, jo), (tc, None, tcnt, to))


def test_sort_limbs_matches_jax_mesh(rng):
    n = P * 512
    hi = rng.integers(0, 2, n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    mesh = jmesh()
    jl = jkeys.encode128(jnp.asarray(hi), jnp.asarray(lo), signed=False)
    jout, _, jc, jo = jax.jit(lambda *ls: jds.distributed_sort_limbs(list(ls), mesh=mesh))(*jl)
    tl = tkeys.encode128(t(hi), t(lo), signed=False)
    tout, _, tc, to = tds.distributed_sort_limbs(tl, mesh=tmesh())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert bool(to) == bool(jo)
    jhi, jlo = jkeys.decode128(list(jout), signed=False)
    thi, tlo = tkeys.decode128([runtime.gather_rows(w) for w in tout], signed=False)
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
