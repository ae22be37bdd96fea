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


def test_expand_join_runs_rejects_other_devices():
    rvs = torch.zeros((1,), dtype=torch.int32, device="meta")
    desc = torch.zeros((1, tx.DESC_COLS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tx.expand_join_runs(rvs, desc, capacity=4)
