"""Port parity: kernel K2's contract (ops/expand.py, expand_join_runs).

On the CPU the port's ``expand_join_runs`` runs its plain PyTorch version;
the JAX package's Pallas kernel runs in interpret mode, jitted once at one
fixed shape (descriptors padded with zero-emit runs, which emit nothing) so
that every spec after the first reuses its compilation. Whole output
arrays, tail included, and the count must agree bit for bit. The CUDA
kernel itself is held against the plain version on a GPU by
tests/test_torch_gpu.py and by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from radix_sort_tpu.ops import expand as jx  # noqa: E402
from radix_sort_tpu.ops import query as jq  # noqa: E402
from radix_sort_tpu_torch.ops import expand as tx  # noqa: E402

N_R = 8192
DESC_ROWS = 3 * jx.RUNS_PER_BLOCK
CAPACITY = 1 << 16


@functools.lru_cache(maxsize=None)
def _jax_kernel():
    return jax.jit(functools.partial(jx.expand_join_runs, capacity=CAPACITY))


def _spec(name, rng):
    """(lo, m_copy, m_emit) runs of the cases of tests/test_expand.py."""
    bounds = [1, 2, 127, 128, 129, 383, 384, 385, 895, 896, 1919, 1920]
    if name == "tier_boundaries":
        return [(int(rng.integers(0, 4000)), n, n) for n in bounds]
    if name == "long_runs":
        return [(0, 1921, 1921), (100, 4000, 4000), (7, 5000, 5000)]
    if name == "fill_and_zero_runs":
        return [(0, 5, 5), (0, 0, 1), (50, 0, 0), (9, 130, 130), (0, 0, 1)]
    if name == "random_mix":
        spec = []
        for _ in range(300):
            lo, n = int(rng.integers(0, 4096)), int(rng.integers(0, 300))
            spec.append((lo, 0, 1) if rng.random() < 0.1 else (lo, n, n))
        return spec
    if name == "unaligned_sources":
        return [(127, 3, 3), (128, 130, 130), (255, 300, 300), (1023, 1000, 1000),
                (129, 1, 1)]
    if name == "many_blocks":  # more runs than one reference descriptor block
        spec = []
        for _ in range(2 * jx.RUNS_PER_BLOCK + 5):
            lo, n = int(rng.integers(0, 1024)), int(rng.integers(1, 9))
            spec.append((lo, n, n))
        return spec
    if name == "exact_capacity":  # copy runs top the total up to capacity
        spec = [(0, 100, 100), (10, 28, 28)] + [(i, 8000, 8000) for i in range(8)]
        return spec + [(5, 1408, 1408)]
    if name == "preclamped_at_capacity":  # the last copy run cut at capacity
        spec = [(int(rng.integers(0, 3000)), 5000, 5000) for _ in range(13)]
        spec[-1] = (spec[-1][0], 5000 - (13 * 5000 - CAPACITY), 5000 - (13 * 5000 - CAPACITY))
        return spec + [(3, 7, 0), (0, 0, 0)]
    if name == "no_runs":
        return []
    raise KeyError(name)


SPECS = ["tier_boundaries", "long_runs", "fill_and_zero_runs", "random_mix",
         "unaligned_sources", "many_blocks", "exact_capacity",
         "preclamped_at_capacity", "no_runs"]


@pytest.mark.parametrize("name", SPECS)
def test_expand_join_runs_matches_reference(rng, name):
    spec = _spec(name, rng)
    n = len(spec)
    rvs = rng.integers(0, 2**32, N_R, dtype=np.uint32)
    rvs[::61] = 0xFFFFFFFF  # real all-ones words beside the tail
    desc = np.zeros((DESC_ROWS, jx.DESC_COLS), np.int32)
    desc[:n, :2] = rng.integers(-(2**31), 2**31, (n, 2))
    desc[:n, 2:5] = np.asarray(spec, np.int32).reshape(n, 3)
    assert desc[:, 4].sum() <= CAPACITY

    jk, jl, jr, jc = _jax_kernel()(jnp.asarray(rvs), jnp.asarray(desc))
    tk, tl, tr, tc = tx.expand_join_runs(torch.from_numpy(rvs.view(np.int32)),
                                         torch.from_numpy(desc[:n]), capacity=CAPACITY)
    assert tc.dtype == torch.int32 and int(tc) == int(jc) == desc[:, 4].sum()
    for t, j in ((tk, jk), (tl, jl), (tr, jr)):
        assert t.dtype == torch.int32 and tuple(t.shape) == (CAPACITY,)
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))


@pytest.mark.parametrize("starts,capacity", [
    ([0, 0, 3, 3, 9], 6),        # duplicate and out-of-range offsets
    ([3, -5], 6),                # a negative offset wraps once, as jnp .at[] does
    ([2, 4, 4, 7], 12),          # slots before the first start get -1
    ([0, 1, 2], 0),
])
def test_expand_offsets_matches_reference(starts, capacity):
    s = np.asarray(starts, np.int32)
    want = np.asarray(jq.expand_offsets(jnp.asarray(s), capacity))
    got = tx.expand_offsets(torch.from_numpy(s), capacity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_long_fill_runs_match_numpy():
    """Fill runs (m_copy 0) longer than 2048 rows, against a numpy oracle:
    the reference kernel writes only the first 2048 rows of such a run and
    leaves the rest at the tail word (a fault of the reference, which its
    own tests do not reach: their fill runs emit one row), so the JAX
    package is no oracle here."""
    spec = [(0, 0, 3000), (4, 9, 9), (0, 0, 100_000), (0, 0, 0), (1, 0, 2049)]
    rvs = np.arange(16, dtype=np.int32)
    desc = np.zeros((len(spec), tx.DESC_COLS), np.int32)
    desc[:, 0] = np.arange(len(spec)) + 100
    desc[:, 1] = np.arange(len(spec)) - 100
    desc[:, 2:5] = spec
    capacity = sum(m for _, _, m in spec) + 3
    k, lv, rv, c = tx.expand_join_runs(torch.from_numpy(rvs), torch.from_numpy(desc),
                                       capacity=capacity)
    emits = desc[:, 4]
    want_rv = np.concatenate([np.r_[rvs[lo:lo + mc], np.zeros(me - mc, np.int32)]
                              for lo, mc, me in spec] + [np.full(3, -1, np.int32)])
    np.testing.assert_array_equal(k.numpy(), np.r_[np.repeat(desc[:, 0], emits), [-1] * 3])
    np.testing.assert_array_equal(lv.numpy(), np.r_[np.repeat(desc[:, 1], emits), [-1] * 3])
    np.testing.assert_array_equal(rv.numpy(), want_rv)
    assert int(c) == capacity - 3


# ---------------------------------------------------------------- whole rows

# (dtype, copied, tail): every width, bool, floats and unsigned dtypes
ROW_COLUMNS = [
    (np.bool_, False, 1), (np.int8, True, -1), (np.uint8, False, 0xAB),
    (np.int16, False, 0), (np.uint16, True, 0xFFFF), (np.float32, False, 0),
    (np.uint32, True, 0x80000000), (np.int32, False, -(1 << 31)),
    (np.float64, True, 0x7FF8000000000001), (np.int64, False, -1), (np.uint64, True, 5),
]


def _row_runs(case, rng):
    """(emits, m_copy, capacity) of one case; m_copy <= emits."""
    if case == "mixed":
        emits = rng.integers(0, 7, 400)
    elif case == "zero_emit_clusters":  # at the start, inside and at the end
        emits = np.concatenate([np.zeros(3000, np.int64), rng.integers(1, 5, 50),
                                np.zeros(20_000, np.int64), rng.integers(1, 5, 50),
                                np.zeros(5000, np.int64)])
    elif case == "clamped_at_capacity":  # the total overflows; ends clamp at it
        emits = rng.integers(0, 40, 300)
    elif case == "no_runs":
        emits = np.zeros(0, np.int64)
    else:
        raise KeyError(case)
    m_copy = np.minimum(emits, rng.integers(0, 8, emits.shape[0]))
    m_copy[::5] = 0  # fill runs
    capacity = 2000 if case == "clamped_at_capacity" else int(emits.sum()) + 37
    return emits, m_copy, capacity


def _numpy_rows(emits, lo, m_copy, cols, capacity):
    """np.repeat plus gathers: each column's expected output, and the count."""
    ends = np.minimum(np.cumsum(emits), capacity)
    em = np.diff(ends, prepend=0)  # the clamped emits
    total = int(ends[-1]) if ends.size else 0
    run = np.repeat(np.arange(em.shape[0]), em)
    j = np.arange(total) - np.repeat(ends - em, em)
    outs = []
    for values, copied, tail in cols:
        w = values.dtype.itemsize
        out = np.full(capacity, tail & ((1 << 8 * w) - 1), np.dtype(f"u{w}")).view(values.dtype)
        if copied:
            src = np.clip(lo[run] + j, 0, values.shape[0] - 1)
            x = np.where(j < m_copy[run], values[src], np.zeros((), values.dtype))
        else:
            x = values[run]
        out[:total] = x
        outs.append(out)
    return outs, total


@pytest.mark.parametrize("case", ["mixed", "zero_emit_clusters", "clamped_at_capacity",
                                  "no_runs"])
def test_expand_rows_plain_matches_numpy(rng, case):
    emits, m_copy, capacity = _row_runs(case, rng)
    n, n_src = emits.shape[0], 500
    lo = rng.integers(-3, n_src, n)  # the copy index clamps into [0, n_src)

    def values(dt, size):  # every bit pattern (NaNs included); bools 0 or 1
        if dt == np.bool_:
            return rng.random(size) < 0.5
        return rng.integers(0, 256, size * np.dtype(dt).itemsize, dtype=np.uint8).view(dt)

    cols = [(values(dt, n_src if cp else n), cp, tail) for dt, cp, tail in ROW_COLUMNS]
    want, total = _numpy_rows(emits, lo, m_copy, cols, capacity)
    ends = torch.from_numpy(np.minimum(np.cumsum(emits), capacity).astype(np.int32))
    before = tx.LAUNCHES
    outs, count = tx.expand_rows(
        ends, torch.from_numpy(lo.astype(np.int32)), torch.from_numpy(m_copy.astype(np.int32)),
        [tx.Column(torch.from_numpy(v.copy()), cp, tail) for v, cp, tail in cols],
        capacity=capacity)
    assert tx.LAUNCHES == before  # CPU tensors never reach the CUDA kernel
    assert count.dtype == torch.int32 and count.shape == () and int(count) == total
    for o, w, (v, _, _) in zip(outs, want, cols):
        assert o.dtype == torch.from_numpy(v).dtype and tuple(o.shape) == (capacity,)
        np.testing.assert_array_equal(o.numpy().view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("bad,match", [
    ("ends_int64", "ends"), ("broadcast_length", "one value per run"),
    ("copied_lengths", "one length"), ("no_lo", "lo must be"), ("complex", "bytes"),
])
def test_expand_rows_rejects_malformed_arguments(bad, match):
    ends = torch.tensor([2, 2, 5], dtype=torch.int32)
    lo = m_copy = torch.zeros(3, dtype=torch.int32)
    cols = [tx.Column(torch.arange(3)), tx.Column(torch.arange(4), copied=True)]
    if bad == "ends_int64":
        ends = ends.to(torch.int64)
    elif bad == "broadcast_length":
        cols[0] = tx.Column(torch.arange(4))
    elif bad == "copied_lengths":
        cols.append(tx.Column(torch.arange(5), copied=True))
    elif bad == "no_lo":
        lo = None
    else:
        cols.append(tx.Column(torch.zeros(3, dtype=torch.complex64)))
    with pytest.raises(ValueError, match=match):
        tx.expand_rows(ends, lo, m_copy, cols, capacity=8)


def test_expand_join_runs_rejects_other_devices():
    rvs = torch.zeros((1,), dtype=torch.int32, device="meta")
    desc = torch.zeros((1, tx.DESC_COLS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tx.expand_join_runs(rvs, desc, capacity=4)
