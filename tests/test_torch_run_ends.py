"""Port tests of ``ops/run_ends.py``: each equal-key run's value at its last
row, the right rank of ``merge_rank_pair``.

On the CPU ``run_end_values`` runs its plain PyTorch version. It is held
against the atomic max it replaced (``scatter_reduce_`` amax over the same
run ids) on the exact arguments ``merge_rank_pair`` gives it, and
``merge_rank_pair`` against the JAX package's, bit for bit, on unions with
one run of 86% of the rows (a join's output padded to its capacity), all
distinct keys, a single run, one row, composite limb keys and a query side
padded with one repeated key. The kernel itself is held against the plain
version on a GPU by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from radix_sort_tpu.ops import query as jq  # noqa: E402
from radix_sort_tpu_torch.ops import query as tq  # noqa: E402
from radix_sort_tpu_torch.ops import run_ends  # noqa: E402
from test_torch_query import _limbs, assert_same, col  # noqa: E402

PAD = np.uint32(0xFFFFFFFF)  # the padding key above every data key


def _union(rng, case):
    """(sorted data columns, query columns) of one case: lists of numpy
    columns, one column unless composite."""
    u32 = np.uint32
    if case == "padded_86":
        # a join's output padded to its capacity: 1,376 of 1,600 union rows
        # carry one key, which the data holds too
        data = np.sort(rng.integers(0, 50, 100).astype(u32))
        data[-10:] = 50
        q = np.concatenate([rng.integers(0, 50, 114).astype(u32), np.full(1376, 50, u32)])
        return [data], [rng.permutation(q)]
    if case == "query_padding":
        # real queries, then the padding's one key, which no data row holds
        data = np.sort(rng.integers(0, 1000, 300).astype(u32))
        q = np.concatenate([rng.integers(0, 1000, 200).astype(u32), np.full(500, PAD)])
        return [data], [q]
    if case == "all_distinct":
        keys = rng.permutation(np.arange(600, dtype=u32) * 7 + 3)
        return [np.sort(keys[:300])], [keys[300:]]
    if case == "single_run":
        return [np.full(50, 9, u32)], [np.full(80, 9, u32)]
    if case == "one_query":
        return [np.zeros(0, u32)], [np.array([5], u32)]
    if case == "one_data_row":
        return [np.array([5], u32)], [np.zeros(0, u32)]
    assert case == "composite"
    pool = [col(rng, np.uint64, 12), rng.integers(-2, 2, 12).astype(np.int32)]
    d_idx = rng.integers(0, 12, 200)
    q_idx = np.concatenate([rng.integers(0, 12, 150), np.full(600, 3)])  # one long run
    data = [c[d_idx] for c in pool]
    order = np.lexsort([np.asarray(w) for w in reversed(_limbs(data)[0])])
    return [c[order] for c in data], [c[rng.permutation(q_idx)] for c in pool]


def _recorded(monkeypatch):
    """Calls of run_end_values, recorded with their arguments."""
    calls = []
    real = run_ends.run_end_values

    def recorder(run_start, run_id, values):
        calls.append((run_start, run_id, values))
        return real(run_start, run_id, values)

    monkeypatch.setattr(run_ends, "run_end_values", recorder)
    return calls


def _atomic_max(run_id, values):
    """The formula the store per run end replaced: a max per run by
    ``scatter_reduce_``."""
    run_max = torch.zeros(values.shape, dtype=torch.int32)
    return run_max.scatter_reduce_(0, run_id, values, "amax", include_self=False)


@pytest.mark.parametrize("case", ["padded_86", "query_padding", "all_distinct", "single_run",
                                  "one_query", "one_data_row", "composite"])
def test_merge_rank_pair_run_ends(rng, monkeypatch, case):
    data, queries = _union(rng, case)
    jd, td = _limbs(data)
    jqy, tqy = _limbs(queries)
    if len(jd) == 1:
        jd, td, jqy, tqy = jd[0], td[0], jqy[0], tqy[0]
    calls = _recorded(monkeypatch)
    got = tq.merge_rank_pair(td, tqy)
    assert_same(jq.merge_rank_pair(jd, jqy), got, "merge_rank_pair")
    assert len(calls) == 1, "the union path takes one run_end_values call"
    run_start, run_id, values = calls[0]
    n = run_start.shape[0]
    assert n == data[0].shape[0] + queries[0].shape[0]
    runs = int(run_id[-1]) + 1
    plain = run_ends.run_end_values_plain(run_start, run_id, values)
    assert torch.equal(plain[:runs], _atomic_max(run_id, values)[:runs])
    longest = int(torch.bincount(run_id).max())
    if case == "padded_86":
        assert longest >= 0.86 * n
    elif case == "all_distinct":
        assert runs == n
    elif case == "single_run":
        assert runs == 1


@pytest.mark.parametrize("n", [1, 2, 17, 1000])
def test_plain_takes_each_runs_last_row(rng, n):
    """The plain version against numpy on runs of every length and values
    in any order: the value at each run's last row, whatever the run's max."""
    run_start = rng.random(n) < 0.3
    run_start[n // 3: n // 3 + n // 2] = False  # one long run
    run_start[0] = True
    values = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    run_id = np.cumsum(run_start) - 1
    last = np.append(np.flatnonzero(run_start[1:]), n - 1)
    got = run_ends.run_end_values_plain(torch.from_numpy(run_start),
                                        torch.from_numpy(run_id.astype(np.int64)),
                                        torch.from_numpy(values))
    np.testing.assert_array_equal(got[:run_id[-1] + 1].numpy(), values[last])


def test_few_queries_skip_run_ends(monkeypatch):
    """The binary-search branch (queries 20x fewer than data) is untouched."""

    def never(*args):
        raise AssertionError("the few-queries branch reached run_end_values")

    monkeypatch.setattr(run_ends, "run_end_values", never)
    data = torch.arange(400, dtype=torch.int32)
    lo, hi = tq.merge_rank_pair(data, torch.tensor([5, 5, 399, -1], dtype=torch.int32))
    assert lo.tolist() == [5, 5, 399, 0] and hi.tolist() == [6, 6, 400, 0]


def test_cuda_path_never_takes_plain(monkeypatch):
    """Only a CPU tensor takes the plain version: another device raises, the
    kernel's launch refuses CPU tensors, and a CPU call launches nothing."""

    def never(*args):
        raise AssertionError("the plain version was reached off the CPU")

    n = 64
    args = (torch.ones(n, dtype=torch.bool), torch.arange(n), torch.arange(n, dtype=torch.int32))
    before = run_ends.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_ends.launch(*args, torch.empty(n, dtype=torch.int32))
    assert run_ends.run_end_values(*args).tolist() == list(range(n))
    tq.merge_rank_pair(torch.arange(100, dtype=torch.int32),
                       torch.arange(50, 150, dtype=torch.int32))
    assert run_ends.LAUNCHES == before
    monkeypatch.setattr(run_ends, "run_end_values_plain", never)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        run_ends.run_end_values(*(a.to("meta") for a in args))


@pytest.mark.parametrize("bad", ["start_dtype", "start_2d", "id_dtype", "id_length",
                                 "values_dtype", "values_length"])
def test_inputs_checked(bad):
    n = 8
    rs, rid, v = (torch.ones(n, dtype=torch.bool), torch.arange(n),
                  torch.arange(n, dtype=torch.int32))
    if bad == "start_dtype":
        rs = rs.to(torch.uint8)
    elif bad == "start_2d":
        rs = rs.reshape(2, 4)
    elif bad == "id_dtype":
        rid = rid.to(torch.int32)
    elif bad == "id_length":
        rid = rid[:-1]
    elif bad == "values_dtype":
        v = v.to(torch.int64)
    else:
        v = v[1:]
    for fn in (run_ends.run_end_values, run_ends.run_end_values_plain):
        with pytest.raises(ValueError):
            fn(rs, rid, v)
