"""The segmented sum over key-sorted rows (``ops/segment_sum.py``): its plain
PyTorch version against a float64 numpy oracle in every float dtype, the
float semantics (+0.0 starts, specials, one rounding), and the aggregates
that reach it through ``query._segsum``. The CUDA kernel SS is held against
the plain version on the card in ``tests/test_torch_gpu.py``."""

import zlib

import numpy as np
import pytest
import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch.ops import query as rq
from radix_sort_tpu_torch.ops import segment_sum as ss

DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64]
_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}
# values on a grid of each dtype (round(normal * 2**q) / 2**q, clipped to
# 2**p grid steps), so every float64 sum of a test is exact in any order
_GRID = {torch.float16: (8, 11), torch.bfloat16: (4, 8), torch.float32: (16, 24),
         torch.float64: (16, 40)}


def _gids(layout, n, rng):
    if layout == "one_group":
        return np.zeros(n, np.int64)
    if layout == "few_groups":
        return np.sort(rng.integers(0, 4, n)).astype(np.int64)
    if layout == "own_groups":
        return np.arange(n, dtype=np.int64)
    if layout == "runs":
        starts = rng.random(n) < 0.05
        starts[0] = True
        return np.cumsum(starts) - 1
    if layout == "ends_alone":  # one long group, a row of its own at each end
        return np.concatenate([[0], np.ones(n - 2, np.int64), [2]])
    assert layout == "pairs"  # every group two rows
    return np.arange(n, dtype=np.int64) // 2


def _values(dtype, n, rng):
    q, p = _GRID[dtype]
    steps = np.clip(np.round(rng.standard_normal(n) * 2.0**q), -(2**p - 1), 2**p - 1)
    return torch.from_numpy(steps / 2.0**q).to(dtype)


def _bits(t):
    return t.view(_INT[t.element_size()]).numpy()


def _rounded_bits(s64, dtype):
    """The bits of float64 sums rounded as ``Tensor.to`` rounds them:
    through float32 for the 16-bit types (numpy; bfloat16 by round to
    nearest even on the float32 bits)."""
    if dtype == torch.float64:
        return s64.view(np.int64)
    f32 = s64.astype(np.float32)
    if dtype == torch.float32:
        return f32.view(np.int32)
    if dtype == torch.float16:
        return f32.astype(np.float16).view(np.int16)
    u = f32.view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF).astype(np.uint16).view(np.int16)


def _oracle(x, gid):
    s = np.zeros(x.shape[0], np.float64)
    np.add.at(s, gid.numpy(), x.double().numpy())
    return s


def _check_against_oracle(x, gid):
    got = ss.segment_sum_sorted(x, gid)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _rounded_bits(_oracle(x, gid), x.dtype))
    return got


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout", ["one_group", "few_groups", "own_groups", "runs",
                                    "ends_alone", "pairs"])
def test_plain_matches_float64_oracle(dtype, layout):
    rng = np.random.default_rng(zlib.crc32(f"{dtype}{layout}".encode()))
    n = 3000
    gid = torch.from_numpy(_gids(layout, n, rng))
    x = _values(dtype, n, rng)
    got = _check_against_oracle(x, gid)
    # rows past the last group are +0.0, bit for bit
    assert not _bits(got[int(gid[-1]) + 1:]).any()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single_row(dtype, n):
    x = torch.full((n,), -2.5, dtype=dtype)
    got = _check_against_oracle(x, torch.zeros((n,), dtype=torch.int64))
    assert got.tolist() == [-2.5] * n


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_nan_inf_and_signed_zeros(dtype):
    inf, nan = float("inf"), float("nan")
    groups = [[1.0, nan, 2.0], [inf, 1.0], [-inf, -inf], [inf, -inf], [-0.0, -0.0], [-0.0],
              [0.0, -0.0], [3.0, -3.0]]
    x = torch.tensor([v for g in groups for v in g], dtype=torch.float64).to(dtype)
    gid = torch.tensor([i for i, g in enumerate(groups) for _ in g], dtype=torch.int64)
    got = ss.segment_sum_sorted(x, gid)
    k = len(groups)
    assert torch.isnan(got[0]) and torch.isnan(got[3])
    assert got[1].item() == inf and got[2].item() == -inf
    # every sum starts from +0.0: groups of -0.0 rows, and those that cancel,
    # read +0.0, as index_add_ into zeros gives; so do the rows past them
    assert not _bits(got[4:k]).any() and not _bits(got[k:]).any()


def test_sums_round_once():
    # a float16 group whose running sum leaves the type's range on the way
    # reads its float64 sum rounded once; one that ends out of range is inf
    x = torch.tensor([60000.0, 60000.0, -60000.0, 60000.0, 60000.0], dtype=torch.float16)
    gid = torch.tensor([0, 0, 0, 1, 1])
    got = ss.segment_sum_sorted(x, gid)
    assert got[0].item() == 60000.0 and got[1].item() == float("inf")
    # a float32 group of 2**20 rows of 0.1 reads the float64 sum rounded
    # once; a float32 accumulator drifts far from it
    n = 1 << 20
    x = torch.full((n,), 0.1, dtype=torch.float32)
    gid = torch.zeros((n,), dtype=torch.int64)
    exact = np.float32(np.float64(np.float32(0.1)) * n)
    assert ss.segment_sum_sorted(x, gid)[0].item() == exact
    assert torch.zeros_like(x).index_add_(0, gid, x)[0].item() != exact


def test_full_mantissa_sums_within_the_summation_bound():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(50_000))
    gid = torch.from_numpy(np.sort(rng.integers(0, 40, 50_000)))
    gid -= gid[0].clone()
    a = ss.segment_sum_sorted(x, gid)
    s = _oracle(x, gid)
    absum = np.zeros(x.shape[0])
    np.add.at(absum, gid.numpy(), np.abs(x.numpy()))
    rows = np.bincount(gid.numpy(), minlength=x.shape[0])
    assert (np.abs(a.numpy() - s) <= rows * 2.0**-53 * absum).all()


@pytest.mark.parametrize("x,gid", [
    (torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int64)),
    (torch.zeros((2, 2)), torch.zeros(4, dtype=torch.int64)),
    (torch.zeros(4), torch.zeros(4, dtype=torch.int32)),
    (torch.zeros(4), torch.zeros(3, dtype=torch.int64)),
], ids=["int_values", "2d_values", "int32_ids", "short_ids"])
def test_refuses_what_it_cannot_take(x, gid):
    with pytest.raises(ValueError):
        ss.segment_sum_sorted(x, gid)


def test_launch_refuses_a_cpu_tensor():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        ss.launch(x, torch.zeros(4, dtype=torch.int64), torch.empty_like(x))


def test_aggregates_reach_it_with_group_ids(monkeypatch):
    """Every float sum of the aggregates goes through segment_sum_sorted,
    with non-decreasing group ids from 0, and a float32 sum of many rows
    reads its float64 sum rounded once."""
    seen = []
    real = ss.segment_sum_sorted

    def spy(x, gid):
        seen.append(x.dtype)
        assert int(gid[0]) == 0 and bool((torch.diff(gid) >= 0).all())
        assert bool((torch.diff(gid) <= 1).all())
        return real(x, gid)

    monkeypatch.setattr(rq, "segment_sum_sorted", spy)
    n = 200_000
    keys = torch.from_numpy(np.arange(n, dtype=np.int32) % 3)
    vals = torch.full((n,), 0.1, dtype=torch.float32)
    uk, (s, m, v), cnt = rst.hash_aggregate(keys, [vals, vals, vals.double()],
                                            ["sum", "mean", "var"])
    rows = np.bincount(keys.numpy())
    exact = rows * np.float64(np.float32(0.1))
    np.testing.assert_array_equal(s[:3].numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(m[:3].numpy(), (s[:3] / torch.from_numpy(rows)).numpy())
    assert seen == [torch.float32, torch.float32, torch.float64, torch.float64]
    seen.clear()
    rq.hash_aggregate(keys, (vals.double(), vals.double()), "corr")
    assert seen and set(seen) == {torch.float64}
