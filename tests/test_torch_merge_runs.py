"""The distributed sort's final step as a merge (``ops/merge_runs.py``).

The plain merge, which runs on CPU tensors and which the kernel is held
to on the card (``tests/test_torch_gpu.py``), against a stable sort of
the runs' concatenation (``_cosort.cosort``), bit for bit with the padding
tail; the final step through the exchange on CPU meshes, under both
splitter kinds, against the sort it replaced; keys over 64 bits still
sorted; one host read a call.
"""

import numpy as np
import pytest
import torch

from radix_sort_tpu_torch.ops import _cosort
from radix_sort_tpu_torch.ops import merge_runs as MR
from radix_sort_tpu_torch.ops import query as Q
from radix_sort_tpu_torch.parallel import dist_sort, runtime

CASES = ["random", "empty_runs", "single_run", "all_equal", "zipf", "clamped"]


def _lengths(rng, case, p, n):
    """Run sizes summing to n; ``empty_runs``: every even run empty (all of
    them at p = 1); ``single_run``: one run holds every row."""
    if case == "single_run":
        return [n if r == p // 2 else 0 for r in range(p)]
    cuts = np.sort(rng.integers(0, n + 1, p - 1))
    lengths = [int(x) for x in np.diff(np.concatenate([[0], cuts, [n]]))]
    if case == "empty_runs":
        lengths = [0 if r % 2 == 0 else x for r, x in enumerate(lengths)]
    return lengths


def _keys(rng, case, n, dtype):
    info = np.iinfo(dtype)
    if case == "all_equal":
        return np.full(n, 7, dtype)
    if case == "zipf":
        return np.minimum(rng.zipf(1.1, n), info.max).astype(dtype)
    # random keys over a small range (ties across runs) and the extremes
    k = rng.integers(-50, 50, n).astype(dtype)
    k[rng.random(n) < 0.05] = info.max
    k[rng.random(n) < 0.05] = info.min
    return k


def make_runs(rng, case, p, n, dtype):
    """(word, lengths): p runs back to back, each sorted. ``clamped``: each
    run cut to a prefix of itself, as an overflowing exchange lands it."""
    lengths = _lengths(rng, case, p, n)
    keys = _keys(rng, case, n, dtype)
    runs, at = [], 0
    for ln in lengths:
        run = np.sort(keys[at:at + ln], kind="stable")
        at += ln
        if case == "clamped":
            run = run[:int(rng.integers(0, ln + 1))]
        runs.append(run)
    return torch.from_numpy(np.concatenate(runs).astype(dtype)), [len(r) for r in runs]


def _values(rng, n):
    """Value columns of 1, 4 and 8 bytes a row (bool, int8, int32, float32,
    int64, float64)."""
    return [torch.from_numpy(rng.random(n) < 0.5),
            torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)),
            torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
            torch.arange(n, dtype=torch.float64)]


def sorted_with_tail(cols, num_keys, n, fills, capacity):
    """The stable sort of the first n rows by the first num_keys columns
    (``_cosort.cosort``), each column followed by its fill up to capacity."""
    srt = _cosort.cosort([c[:n] for c in cols], num_keys)
    return [torch.cat([s, torch.full((capacity - n,), f, dtype=c.dtype)])
            for s, c, f in zip(srt, cols, fills)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_merge_matches_a_stable_sort(p, case, dtype):
    rng = np.random.default_rng(p * 1000 + CASES.index(case) * 10 + (dtype == np.int64))
    n = 3000
    word, lengths = make_runs(rng, case, p, n, dtype)
    m = word.shape[0]
    capacity = m + 37
    cols = [word] + _values(rng, m)
    fills = [torch.iinfo(word.dtype).max] + [0] * (len(cols) - 1)
    got = MR.merge_runs(word, lengths, cols, fills, capacity)
    _same(got, sorted_with_tail(cols, 1, m, fills, capacity))


@pytest.mark.parametrize("case", CASES[:-1])
@pytest.mark.parametrize("limbs", [(np.int32, np.int32), (np.int16, np.int32),
                                   (np.int8, np.int8), (np.int16,), (np.int8,)])
def test_packed_limbs_merge_like_their_sort(case, limbs):
    """Key limbs of at most 64 bits merge on their packed word
    (``_cosort.pack_keys``; a lone 8- or 16-bit word widened to int32) and
    move as columns, like the sort by the limbs themselves."""
    rng = np.random.default_rng(len(case) * 7 + len(limbs) * 3 + limbs[0](0).itemsize)
    p, n = 4, 2500
    lengths = _lengths(rng, case, p, n)
    raw = [_keys(rng, case if i == 0 else "random", n, dt) for i, dt in enumerate(limbs)]
    cols_np, at = [[] for _ in limbs], 0
    for ln in lengths:
        order = np.lexsort([k[at:at + ln] for k in reversed(raw)])
        for c, k in zip(cols_np, raw):
            c.append(k[at:at + ln][order])
        at += ln
    key_cols = [torch.from_numpy(np.concatenate(c)) for c in cols_np]
    word = dist_sort._merge_word(key_cols)
    assert word.dtype == (torch.int32 if len(limbs) == 1 else torch.int64)
    m = sum(lengths)
    cols = key_cols + _values(rng, m)[2:4]
    fills = [torch.iinfo(c.dtype).max for c in key_cols] + [0, 0]
    got = MR.merge_runs(word, lengths, cols, fills, m + 5)
    _same(got, sorted_with_tail(cols, len(limbs), m, fills, m + 5))


def test_wide_keys_have_no_merge_word():
    words = [torch.zeros(4, dtype=torch.int32) for _ in range(3)]
    assert dist_sort._merge_word(words) is None
    assert dist_sort._merge_word([torch.zeros(4, dtype=torch.int64)] * 2) is None
    assert dist_sort._merge_word(words[:2]).dtype == torch.int64


def test_plain_merge_rejects_bad_arguments():
    word = torch.arange(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32 or int64"):
        MR.merge_runs(word.double(), [8], [word], [0], 8)
    with pytest.raises(ValueError, match="capacity"):
        MR.merge_runs(word, [4, 4], [word], [0], 7)
    with pytest.raises(ValueError, match="rows"):
        MR.merge_runs(word, [4, 5], [word], [0], 9)
    with pytest.raises(ValueError, match="fills"):
        MR.merge_runs(word, [4, 4], [word], [0, 0], 8)
    with pytest.raises(ValueError, match="CUDA"):
        MR.launch(word, [4, 4], [word], [torch.empty_like(word)])


def _exchange_inputs(rng, p, n_local):
    """Per-slot (key limb lists, value lists) for ``_local_exchange`` on p
    CPU slots: Zipf keys and two payloads."""
    keys = [torch.from_numpy(np.minimum(rng.zipf(1.1, n_local), 2**62)
                             .astype(np.int64)) for _ in range(p)]
    vals = [[torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n_local, dtype=np.int64)),
             torch.from_numpy(rng.integers(-2**31, 2**31, n_local).astype(np.int32))]
            for _ in range(p)]
    return [[k] for k in keys], vals


@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["composite", "key_only"])
def test_final_step_merges_as_the_sort_did(p, kind, monkeypatch):
    """Through the exchange on p CPU slots, under composite (key, position)
    splitters and key-only ones (equal keys co-locate): every slot's final
    step merges, and gives what the stable sort of its received rows gave
    (the padding tail included)."""
    rng = np.random.default_rng(p * 31 + len(kind))
    mesh = runtime.data_mesh(p, device="cpu")
    n_local = 2048
    limbs, vals = _exchange_inputs(rng, p, n_local)
    sentinel = torch.iinfo(torch.int64).max
    splitters = None
    if kind == "key_only":
        splitters = dist_sort._key_splitters(mesh, [torch.sort(k[0]).values for k in limbs])
    capacity = p * n_local  # key-only splitters under Zipf keys are not balanced
    seen = []
    real = dist_sort._final_sort

    def spy(ops, nk, runs, fills):
        want = Q._stable_sort([x[:sum(runs)] for x in ops], nk)
        want = [torch.cat([s, x[sum(runs):]]) for s, x in zip(want, ops)]
        got = real(ops, nk, runs, fills)
        seen.append(len(runs))
        _same(got, want)
        return got

    monkeypatch.setattr(dist_sort, "_final_sort", spy)
    merges, sorts = dist_sort.FINAL_MERGES, dist_sort.FINAL_SORTS
    ws, vs, counts, overflow = dist_sort._local_exchange(mesh, limbs, vals, capacity, sentinel,
                                                         splitters=splitters)
    assert not overflow and seen == [p] * p
    assert (dist_sort.FINAL_MERGES - merges, dist_sort.FINAL_SORTS - sorts) == (p, 0)
    whole = Q._stable_sort([torch.cat([k[0] for k in limbs])]
                           + [torch.cat([v[i] for v in vals]) for i in range(2)], 1)
    got = [torch.cat([w[0][:c] for w, c in zip(ws, counts)])] + [
        torch.cat([v[i][:c] for v, c in zip(vs, counts)]) for i in range(2)]
    _same(got, whole)


@pytest.mark.parametrize("limbs,merged", [(1, True), (2, True), (3, False), (4, False)])
def test_keys_over_64_bits_take_the_sort(limbs, merged):
    """int32 limbs: up to two pack into one word and merge; three or four
    (``keys.encode128``'s) are sorted again, counted in FINAL_SORTS."""
    rng = np.random.default_rng(limbs)
    p, n = 4, 4 * 1024
    mesh = runtime.data_mesh(p, device="cpu")
    cols = [torch.from_numpy(rng.integers(-3, 3, n).astype(np.int32)) for _ in range(limbs)]
    vals = torch.arange(n, dtype=torch.int64)
    merges, sorts = dist_sort.FINAL_MERGES, dist_sort.FINAL_SORTS
    out, ov, counts, overflow = dist_sort.distributed_sort_limbs(cols, vals, mesh=mesh)
    moved = (dist_sort.FINAL_MERGES - merges, dist_sort.FINAL_SORTS - sorts)
    assert moved == ((p, 0) if merged else (0, p))
    want = Q._stable_sort(cols + [vals], limbs)
    got = [runtime.valid_rows(x, counts) for x in out] + [runtime.valid_rows(ov, counts)]
    assert not bool(overflow)
    _same(got, want)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_one_host_read_a_call(p):
    rng = np.random.default_rng(p)
    mesh = runtime.data_mesh(p, device="cpu")
    n = p * 1000
    k = torch.from_numpy(rng.integers(0, 1 << 64, n, dtype=np.uint64))
    v = torch.from_numpy(rng.integers(0, 1 << 64, n, dtype=np.uint64))
    reads, merges = dist_sort.HOST_READS, dist_sort.FINAL_MERGES
    for calls in range(1, 4):
        dist_sort.distributed_sort_pairs(k, v, mesh)
        assert dist_sort.HOST_READS - reads == calls
    assert dist_sort.FINAL_MERGES - merges == 3 * p
