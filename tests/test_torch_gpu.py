"""Port tests that need an NVIDIA GPU: the CUDA kernels against their plain
PyTorch versions, the join and the GROUP BY / ORDER BY functions on the
card against the same calls on the CPU, and CUDA-event timing. They skip
without a GPU.

This file imports neither JAX nor the test harness's fixtures, so it also
runs where only PyTorch with CUDA is installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch.ops import expand, extract, merge_runs, run_ends, segment_sum
from radix_sort_tpu_torch.ops import query as rq
from radix_sort_tpu_torch.utils import timing


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")


def _bounds(rng, nchunks, K, m):
    b = np.zeros((nchunks, K + 1), np.int32)
    for c in range(nchunks):
        valid = rng.integers(0, m + 1)
        b[c, 1:K] = np.sort(rng.integers(0, valid + 1, K - 1))
        b[c, K] = valid
    b[0, 1:] = m  # one full-chunk run
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("K,nbuckets,cpb,n_ops,cap_rows",
                         [(1, 1, 16, 1, 512), (8, 1, 32, 4, 1024), (63, 4, 8, 4, 256),
                          (8, 2, 16, 3, 8)])  # the last one overflows
def test_kernel_matches_plain(cuda, K, nbuckets, cpb, n_ops, cap_rows):
    rng = np.random.default_rng(K * 1000 + n_ops)
    m = 4096
    nchunks = nbuckets * cpb
    ops = [torch.from_numpy(rng.integers(-(2**31), 2**31, nchunks * m).astype(np.int32))
           .reshape(-1, 128).cuda() for _ in range(n_ops)]
    bounds = torch.from_numpy(_bounds(rng, nchunks, K, m)).cuda()
    kw = dict(K=K, cap_rows=cap_rows, chunks_per_bucket=cpb, nbuckets=nbuckets)
    before = extract.LAUNCHES
    got, gc = extract.bucket_extract(ops, bounds, **kw)
    assert extract.LAUNCHES == before + 1
    ref, rc = extract.bucket_extract_plain(ops, bounds, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gc, rc)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


POISON = 0x5A5A5A5A


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["regions", "compactor_tail"])
def test_kernel_writes_every_word(cuda, case):
    """Outputs poisoned with 0x5A5A5A5A before the launch come back equal to
    the plain version: the kernel writes every slot, sentinel tails
    included (the compactor's tail is most of its one region)."""
    rng = np.random.default_rng(11)
    m = 4096
    if case == "regions":
        K, nbuckets, cpb, cap_rows = 8, 3, 70, 2304  # several scan tiles per region
        bounds = torch.from_numpy(_bounds(rng, nbuckets * cpb, K, m))
    else:
        K, nbuckets, cpb, cap_rows = 1, 1, 300, 32 * 300 + 40
        counts = torch.from_numpy(rng.integers(0, m + 1, cpb).astype(np.int32))
        bounds = torch.stack([torch.zeros_like(counts), counts], 1)
    ops = [torch.from_numpy(rng.integers(-(2**31), 2**31, nbuckets * cpb * m)
                            .astype(np.int32)).reshape(-1, 128).cuda() for _ in range(3)]
    bounds = bounds.cuda()
    kw = dict(K=K, cap_rows=cap_rows, chunks_per_bucket=cpb, nbuckets=nbuckets)
    outs = [torch.full((nbuckets * K * cap_rows * 128,), POISON, dtype=torch.int32,
                       device="cuda") for _ in ops]
    counts = torch.full((nbuckets * K,), POISON, dtype=torch.int32, device="cuda")
    extract.launch(ops, bounds, outs, counts, **kw)
    ref, rc = extract.bucket_extract_plain(ops, bounds, **kw)
    torch.cuda.synchronize()
    assert torch.equal(counts, rc)
    for o, r in zip(outs, ref):
        assert torch.equal(o, r.reshape(-1))


def _runs(rng, case):
    """(emits, m_copy, capacity) of a whole-row case."""
    if case == "mixed":
        emits = rng.integers(0, 9, 60_000)
    elif case == "long_runs":
        emits = np.array([5000, 0, 1, 100_000, 3, 0, 0, 4097, 2], np.int64)
    elif case == "zero_emit_cluster":  # longer than a tile walks
        emits = np.concatenate([rng.integers(1, 6, 3000), np.zeros(1_000_000, np.int64),
                                rng.integers(1, 6, 3000), np.zeros(50_000, np.int64)])
    elif case == "clamped":
        emits = rng.integers(0, 50, 20_000)
    else:
        emits = np.zeros(0, np.int64)
    m_copy = np.minimum(emits, rng.integers(0, 200_000, emits.shape[0]))
    m_copy[::7] = 0
    capacity = 300_001 if case == "clamped" else int(emits.sum()) + 4099
    return emits, m_copy, capacity


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "long_runs", "zero_emit_cluster", "clamped",
                                  "no_runs"])
def test_expand_rows_kernel_matches_plain(cuda, case):
    """The whole-row kernel against its plain version, into outputs poisoned
    with 0x5A bytes: every width, per-column tails, one launch."""
    rng = np.random.default_rng(len(case))
    emits, m_copy, capacity = _runs(rng, case)
    n, n_src = emits.shape[0], 250_000
    ends = torch.from_numpy(np.minimum(np.cumsum(emits), capacity).astype(np.int32)).cuda()
    lo = torch.from_numpy(rng.integers(-5, n_src, n).astype(np.int32)).cuda()
    mc = torch.from_numpy(m_copy.astype(np.int32)).cuda()
    cols = []
    for dt, copied, tail in [(torch.bool, False, 1), (torch.int8, True, -1),
                             (torch.int16, False, 0x1234), (torch.uint16, True, 0),
                             (torch.float32, False, 0), (torch.int32, True, -(1 << 31)),
                             (torch.float64, True, 0), (torch.int64, False, -1)]:
        size = n_src if copied else n
        raw = torch.tensor(rng.integers(0, 256, size * dt.itemsize), dtype=torch.uint8)
        if size == 0:
            v = torch.empty((0,), dtype=dt)
        else:
            v = (raw[:size] & 1).bool() if dt == torch.bool else raw.view(dt)
        cols.append(expand.Column(v.cuda(), copied, tail))
    outs = [torch.full((capacity * c.values.element_size(),), 0x5A, dtype=torch.uint8,
                       device="cuda").view(c.values.dtype) for c in cols]
    count = torch.full((1,), POISON, dtype=torch.int32, device="cuda")
    before = expand.LAUNCHES
    expand.launch(ends, lo, mc, cols, outs, count, capacity=capacity)
    assert expand.LAUNCHES == before + 1
    ref, rc = expand.expand_rows_plain(ends, lo, mc, cols, capacity=capacity)
    torch.cuda.synchronize()
    assert int(count[0]) == int(rc)
    for o, r in zip(outs, ref):
        assert o.dtype == r.dtype and torch.equal(o.view(torch.uint8), r.view(torch.uint8))


def _desc(rng, spec, n_r):
    """Descriptors of (lo, m_copy, m_emit) runs with random key/lv words."""
    desc = np.zeros((len(spec), expand.DESC_COLS), np.int32)
    desc[:, :2] = rng.integers(-(2**31), 2**31, (len(spec), 2))
    if spec:
        desc[:, 2:5] = spec
    assert (desc[:, 2] + desc[:, 3] <= n_r).all()
    return torch.from_numpy(desc)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tiers", "long_and_fill", "many_runs", "preclamped",
                                  "no_runs"])
def test_expand_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(len(case))
    n_r = 200_000
    if case == "tiers":
        spec = [(int(rng.integers(0, 4000)), n, n)
                for n in (1, 2, 127, 128, 129, 383, 384, 385, 895, 896, 1919, 1920, 1921)]
    elif case == "long_and_fill":
        spec = [(0, 5000, 5000), (3, 0, 1), (9, 0, 0), (7, 100_000, 100_000),
                (0, 0, 3000), (11, 0, 1)]
    elif case == "many_runs":  # zero-emit runs among short ones, many tiles
        lens = rng.integers(0, 9, 50_000)
        spec = [(int(rng.integers(0, 1000)), int(n), int(n)) for n in lens]
    elif case == "preclamped":  # emits clamped so the total is exactly the capacity
        spec = [(int(rng.integers(0, 1000)), 3000, 3000) for _ in range(40)]
    else:
        spec = []
    capacity = sum(m for _, _, m in spec) + 1000
    if case == "preclamped":
        capacity = 100_000
        emits = np.minimum(np.maximum(capacity - np.cumsum([0] + [m for *_, m in spec])[:-1],
                                      0), 3000)
        spec = [(lo, int(e), int(e)) for (lo, _, _), e in zip(spec, emits)]
    rvs = torch.from_numpy(rng.integers(-(2**31), 2**31, n_r).astype(np.int32)).cuda()
    desc = _desc(rng, spec, n_r).cuda()
    before = expand.LAUNCHES
    got = expand.expand_join_runs(rvs, desc, capacity=capacity)
    assert expand.LAUNCHES == before + 1
    ref = expand.expand_join_runs_plain(rvs, desc, capacity=capacity)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["inner", "left", "full", "lookup"])
def test_hash_join_on_card_matches_cpu(cuda, how):
    rng = np.random.default_rng(7)
    n_l, n_r = 5000, 20_000
    lk = torch.from_numpy(rng.integers(0, 6000, n_l).astype(np.int64))
    rk = torch.from_numpy(rng.integers(0, 6000, n_r).astype(np.int64))
    lv = torch.from_numpy(rng.random(n_l))
    rv = torch.from_numpy(rng.integers(0, 1 << 31, n_r).astype(np.int32)).view(torch.uint32)
    cpu = rst.hash_join(lk, lv, rk, rv, capacity=40_000, how=how)
    before = expand.LAUNCHES
    gpu = rst.hash_join(lk.cuda(), lv.cuda(), rk.cuda(), rv.cuda(), capacity=40_000, how=how)
    assert expand.LAUNCHES > before  # duplicate right keys: lookup expands too
    for g, c in zip(gpu, cpu):
        assert g.is_cuda and g.dtype == c.dtype and torch.equal(g.cpu(), c)


def _runs_on_card(n, long_run, at_end, seed):
    """(run_start, run_id, values) of n rows on the card: runs of a few rows,
    one run of ``long_run`` rows (in the middle, or ending at the last row),
    and values a non-decreasing count, as merge_rank_pair's data count."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    run_start = torch.rand(n, device="cuda", generator=g) < 0.3
    a = n - long_run if at_end else (n - long_run) // 2
    run_start[a + 1:a + long_run] = False
    run_start[0] = True
    run_id = torch.cumsum(run_start, 0, dtype=torch.int64) - 1
    values = torch.cumsum(torch.rand(n, device="cuda", generator=g) < 0.5, 0, dtype=torch.int32)
    return run_start, run_id, values


@pytest.mark.cuda
@pytest.mark.parametrize("n,long_run,at_end", [
    (1 << 20, 300_000, False),
    ((1 << 20) + 13, 70_001, True),  # a ragged last warp; the long run is the last
    (127_086_451, 52_000_000, False),  # the joins cell's union: Q3's second join at SF10
])
def test_run_ends_kernel_matches_plain(cuda, n, long_run, at_end):
    """The run-ends kernel writes each run's entry bit for bit as the plain
    version does, into an output poisoned with 0x5A5A5A5A, and no other
    entry; each call is one launch."""
    run_start, run_id, values = _runs_on_card(n, long_run, at_end, seed=n)
    runs = int(run_id[-1]) + 1
    ref = run_ends.run_end_values_plain(run_start, run_id, values)
    out = torch.full((n,), POISON, dtype=torch.int32, device="cuda")
    before = run_ends.LAUNCHES
    run_ends.launch(run_start, run_id, values, out)
    got = run_ends.run_end_values(run_start, run_id, values)
    assert run_ends.LAUNCHES == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out[:runs], ref[:runs]) and torch.equal(got[:runs], ref[:runs])
    assert bool((out[runs:] == POISON).all())
    with pytest.raises(ValueError, match="aligned"):
        run_ends.launch(run_start[1:], run_id[1:], values[1:], out[1:])


@pytest.mark.cuda
def test_merge_rank_pair_on_card_launches_run_ends(cuda, monkeypatch):
    """On the card merge_rank_pair takes the kernel, never the plain version,
    and matches the CPU bit for bit on a union with one padded run."""

    def never(*args):
        raise AssertionError("the CUDA path reached the plain version")

    rng = np.random.default_rng(3)
    data = torch.from_numpy(np.sort(rng.integers(0, 5000, 40_000)).astype(np.int32))
    q = np.concatenate([rng.integers(0, 5000, 20_000), np.full(200_000, 4999)])
    queries = torch.from_numpy(rng.permutation(q).astype(np.int32))
    cpu = rq.merge_rank_pair(data, queries)
    monkeypatch.setattr(run_ends, "run_end_values_plain", never)
    before = run_ends.LAUNCHES
    gpu = rq.merge_rank_pair(data.cuda(), queries.cuda())
    assert run_ends.LAUNCHES == before + 1
    for g, c in zip(gpu, cpu):
        assert g.is_cuda and torch.equal(g.cpu(), c)


def _sorted_runs_on_card(lengths, dtype, seed):
    """P runs back to back on the card, each sorted: Zipf-like keys (a
    heavy tail over 1, 2, 3, ...: long runs of equal keys in every run)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = sum(lengths)
    u = torch.rand(n, device="cuda", generator=g, dtype=torch.float64).clamp_(min=1e-300)
    keys = u.pow(-10.0).clamp_(max=2.0**30).to(dtype)  # P(k >= x) = x**-0.1
    for r, (a, b) in enumerate(zip([0] + list(np.cumsum(lengths)), np.cumsum(lengths))):
        keys[a:b] = torch.sort(keys[a:b]).values
    return keys


def _merge_on_card(word, lengths, cols):
    """The kernel into outputs poisoned with 0x5A bytes (two rows past n
    must stay poisoned) against the plain version, bit for bit."""
    n = sum(lengths)
    outs = [torch.full((n + 2,), 0x5A, dtype=torch.uint8, device="cuda")
            .repeat_interleave(c.element_size()).view(c.dtype) for c in cols]
    before = merge_runs.LAUNCHES
    merge_runs.launch(word, lengths, cols, outs)
    assert merge_runs.LAUNCHES == before + 1
    torch.cuda.synchronize()
    ref = merge_runs.merge_runs_plain(word, lengths, cols, [0] * len(cols), n + 2)
    for o, r in zip(outs, ref):
        ob = o.view(torch.uint8).view(-1, o.element_size())
        assert torch.equal(ob[:n], r.view(torch.uint8).view(-1, o.element_size())[:n])
        assert bool((ob[n:] == 0x5A).all())


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8, 64])
@pytest.mark.parametrize("key", [torch.int64, torch.int32])
def test_merge_kernel_matches_plain(cuda, p, key):
    """2**20 + 13 rows in p runs (one empty, one long), every column width
    (the key itself among them, bool, int8, int16, int32, float32, int64,
    float64): each column bit for bit as the plain merge, nothing written
    past the rows; one launch a call."""
    rng = np.random.default_rng(p)
    n = (1 << 20) + 13
    w = rng.random(p) + 0.1
    if p > 1:
        w[0], w[-1] = 0.0, 3.0
    lengths = [int(x) for x in n * w / w.sum()]
    lengths[-1] += n - sum(lengths)
    word = _sorted_runs_on_card(lengths, key, seed=p)
    g = torch.Generator(device="cuda").manual_seed(p + 1)
    cols = [word, torch.rand(n, device="cuda", generator=g) < 0.5,
            torch.randint(-128, 128, (n,), dtype=torch.int8, device="cuda", generator=g),
            torch.randint(-2**15, 2**15, (n,), dtype=torch.int16, device="cuda", generator=g),
            torch.arange(n, dtype=torch.int32, device="cuda"),
            torch.rand(n, device="cuda", generator=g),
            torch.randint(-2**62, 2**62, (n,), device="cuda", generator=g),
            torch.rand(n, device="cuda", generator=g, dtype=torch.float64)]
    _merge_on_card(word, lengths, cols)


@pytest.mark.cuda
def test_merge_kernel_at_the_cell_size(cuda):
    """250M (int64 key, int64 payload) rows in 4 Zipf-like runs of unequal
    size, a card's final step in the 4-card sort cell."""
    n = 250_000_000
    lengths = [61_000_000, 64_500_000, 62_000_000, n - 187_500_000]
    word = _sorted_runs_on_card(lengths, torch.int64, seed=250)
    vals = torch.randint(-2**62, 2**62, (n,), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(7))
    _merge_on_card(word, lengths, [word, vals])


@pytest.mark.cuda
def test_merge_kernel_refuses_what_it_cannot_take(cuda):
    word = torch.arange(1024, dtype=torch.int64, device="cuda")
    out = torch.empty_like(word)
    for bad, what in (((word.double(), [1024], [word], [out]), "int32 or int64"),
                      ((word, [512, 512], [word.to(torch.complex64)],
                        [out.to(torch.complex64)]), "real"),
                      ((word, [256, 256], [word[::2]], [out[:512]]), "contiguous"),
                      ((word, [512, 512], [word], [out.int()]), "bytes a row"),
                      ((word, [15] * 65, [word], [out]), "at most 64 runs")):
        with pytest.raises(ValueError, match=what):
            merge_runs.launch(*bad)
    # the C entry refuses a key word off its alignment
    lens = (merge_runs.ctypes.c_longlong * 2)(512, 511)
    src = (merge_runs.ctypes.c_void_p * 1)(word.data_ptr())
    dst = (merge_runs.ctypes.c_void_p * 1)(out.data_ptr())
    width = (merge_runs.ctypes.c_int * 1)(8)
    bounds = torch.empty(64, dtype=torch.int64, device="cuda")
    err = merge_runs._kernel()(word.data_ptr() + 4, 8, lens, 2, src, dst, width, 1, -1, 256,
                               merge_runs.GROUP, bounds.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    assert err != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_distributed_sort_merges_once_a_slot(cuda, monkeypatch):
    """On a 4-slot card mesh every final step merges in one kernel launch,
    never in the plain version, and the sort matches the CPU mesh's."""
    from radix_sort_tpu_torch.parallel import dist_sort, runtime

    def never(*args):
        raise AssertionError("the CUDA path reached the plain merge")

    rng = np.random.default_rng(21)
    n = 4 * 50_000
    k = torch.from_numpy(np.minimum(rng.zipf(1.1, n), 2**40).astype(np.uint64))
    v = torch.from_numpy(rng.integers(0, 1 << 64, n, dtype=np.uint64))
    want = dist_sort.distributed_sort_pairs(k, v, runtime.data_mesh(4, device="cpu"))
    monkeypatch.setattr(merge_runs, "merge_runs_plain", never)
    launches, merges = merge_runs.LAUNCHES, dist_sort.FINAL_MERGES
    got = dist_sort.distributed_sort_pairs(k.cuda(), v.cuda(), runtime.data_mesh(4, device="cuda"))
    assert merge_runs.LAUNCHES - launches == 4 and dist_sort.FINAL_MERGES - merges == 4
    for g, w in zip(got[:2], want[:2]):
        for gb, wb in zip(g.blocks, w.blocks):
            assert torch.equal(gb.cpu().view(torch.int64), wb.view(torch.int64))
    assert torch.equal(got[2].cpu(), want[2])


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}
SS_DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64]


def _ss_on_card(x, gid):
    """SS and the plain version on the same card inputs; one launch."""
    before = segment_sum.LAUNCHES
    got = segment_sum.segment_sum_sorted(x, gid)
    assert segment_sum.LAUNCHES == before + 1
    ref = segment_sum.segment_sum_sorted_plain(x, gid)
    torch.cuda.synchronize()
    return got, ref


def _ss_grid(n, dtype, seed):
    """n values on a grid of the dtype whose float64 sums are exact in any
    order at up to 2**27 rows: k * 2**-8, |k| < 2**p, p the dtype's
    significand bits (at most 24)."""
    p = {torch.float16: 11, torch.bfloat16: 8}.get(dtype, 24)
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randint(-(2**p) + 1, 2**p, (n,), generator=g, device="cuda")
    return (k.double() * 2.0**-8).to(dtype)


def _ss_gid(n, starts):
    """Group ids of n rows with groups starting at the given rows (0 first)."""
    first = torch.zeros(n, dtype=torch.bool, device="cuda")
    first[torch.tensor(sorted({0, *starts}), device="cuda")] = True
    return torch.cumsum(first, 0) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", SS_DTYPES, ids=str)
@pytest.mark.parametrize("shape", ["q1", "q4"])
def test_segment_sum_kernel_at_the_cells_shapes(cuda, dtype, shape):
    """TPC-H Q1's shape (59,986,052 rows into 4 groups) and h2o q4's (1e8
    rows into 100): on grid values every float64 sum is exact, so SS equals
    the plain version bit for bit, rows past the groups +0.0; a second call
    gives the same bits."""
    n, groups = {"q1": (59_986_052, 4), "q4": (100_000_000, 100)}[shape]
    x = _ss_grid(n, dtype, seed=groups)
    g = torch.Generator(device="cuda").manual_seed(groups + 1)
    gid = torch.sort(torch.randint(0, groups, (n,), generator=g, device="cuda")).values
    got, ref = _ss_on_card(x, gid)
    assert torch.equal(got.view(_BITS[x.element_size()]), ref.view(_BITS[x.element_size()]))
    assert not bool(got[groups:].view(_BITS[x.element_size()]).any())
    again = segment_sum.segment_sum_sorted(x, gid)
    assert torch.equal(again.view(_BITS[x.element_size()]), got.view(_BITS[x.element_size()]))


T = segment_sum.TILE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", SS_DTYPES, ids=str)
@pytest.mark.parametrize("layout", ["tile_edges", "one_group", "ends_alone", "own_groups",
                                    "runs", "unaligned"])
def test_segment_sum_kernel_layouts(cuda, dtype, layout):
    """Groups that begin or end on a tile's edge or one row off it, one group
    over every tile (alone, or with a row of its own at each end), every row
    its own group, runs of a few rows, and inputs off their 16-byte
    alignment (the kernel's scalar loads): bit for bit on grid values."""
    n = 9 * T + 77
    if layout == "tile_edges":
        gid = _ss_gid(n, [T - 1, T, 2 * T, 2 * T + 1, 3 * T - 1, 5 * T, 5 * T + 3, 8 * T + 76])
    elif layout == "one_group":
        gid = torch.zeros(n, dtype=torch.int64, device="cuda")
    elif layout == "ends_alone":
        gid = _ss_gid(n, [1, n - 1])
    elif layout == "own_groups":
        gid = torch.arange(n, device="cuda")
    elif layout == "runs":
        g = torch.Generator(device="cuda").manual_seed(5)
        first = torch.rand(n, generator=g, device="cuda") < 0.2
        first[0] = True
        gid = torch.cumsum(first, 0) - 1
    else:
        gid = _ss_gid(n + 1, [3, 2 * T + 5])[1:]
    x = _ss_grid(n + 1, dtype, seed=n)
    x = x[1:] if layout == "unaligned" else x[:n]
    assert layout != "unaligned" or x.data_ptr() % 16
    got, ref = _ss_on_card(x, gid)
    assert torch.equal(got.view(_BITS[x.element_size()]), ref.view(_BITS[x.element_size()]))
    again = segment_sum.segment_sum_sorted(x, gid)
    assert torch.equal(again.view(_BITS[x.element_size()]), got.view(_BITS[x.element_size()]))


@pytest.mark.cuda
def test_segment_sum_kernel_rounding(cuda):
    """Values with every bit of their significand: float64 sums within 2 ULP
    of their group's sum of |x| of the exact sum (``math.fsum``; the plain
    version's atomics carry their own error, up to (n_g - 1) u sum|x|); the
    narrower types equal the plain version but at a rounding tie: the two
    one ULP apart, their midpoint within the two float64 sums' error (and
    float32's half ULP, through which the 16-bit types round) of the
    plain version's float64 sum."""
    import math

    n = 2_000_003
    g = torch.Generator(device="cuda").manual_seed(9)
    first = torch.rand(n, generator=g, device="cuda") < 1 / 300
    first[0] = True
    gid = torch.cumsum(first, 0) - 1
    x64 = torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    got, _ = _ss_on_card(x64, gid)
    groups = int(gid[-1]) + 1
    xs, gs = x64.cpu().numpy(), gid.cpu().numpy()
    cuts = np.searchsorted(gs, np.arange(groups + 1))
    exact = np.array([math.fsum(xs[a:b]) for a, b in zip(cuts[:-1], cuts[1:])])
    absum = np.add.reduceat(np.abs(xs), cuts[:-1])
    ulp = np.spacing(absum)
    assert (np.abs(got[:groups].cpu().numpy() - exact) <= 2 * ulp).all()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = x64.to(dtype)
        got, ref = _ss_on_card(x, gid)
        zeros = torch.zeros(n, dtype=torch.float64, device="cuda")
        s64 = zeros.index_add_(0, gid, x.double())
        absum = torch.zeros_like(zeros).index_add_(0, gid, x.double().abs())
        rows = torch.bincount(gid, minlength=n).double()
        off = got.view(_BITS[x.element_size()]) != ref.view(_BITS[x.element_size()])
        if bool(off.any()):
            bits = (got[off].view(_BITS[x.element_size()]).long()
                    - ref[off].view(_BITS[x.element_size()]).long())
            assert bool((bits.abs() == 1).all()), dtype
            mid = (got[off].double() + ref[off].double()) / 2
            tol = 2 * rows[off] * 2.0**-53 * absum[off] + 2.0**-24 * s64[off].abs()
            assert bool(((mid - s64[off]).abs() <= tol).all()), dtype


@pytest.mark.cuda
def test_aggregates_on_card_take_the_kernel(cuda, monkeypatch):
    """hash_aggregate's float sums, means and variances on the card launch
    SS and never reach index_add_; each reads the CPU's value (float32 sums
    rounded once from float64 on both)."""
    def never(*args, **kw):
        raise AssertionError("the CUDA path reached index_add_")

    rng = np.random.default_rng(22)
    n = 300_000
    keys = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
    x = torch.from_numpy(np.round(rng.random(n) * 1000, 2).astype(np.float32))
    aggs = ["sum", "mean", "var", "std"]
    cpu = rst.hash_aggregate(keys, [x] * 4, aggs)
    monkeypatch.setattr(torch.Tensor, "index_add_", never)
    before = segment_sum.LAUNCHES
    gpu = rst.hash_aggregate(keys.cuda(), [x.cuda()] * 4, aggs)
    assert segment_sum.LAUNCHES - before == 6  # sum, mean, and two each for var and std
    _same((gpu[0], gpu[2]), (cpu[0], cpu[2]), "keys")
    _same(gpu[1][0], cpu[1][0], "sum")
    for agg, g, c in zip(aggs[1:], gpu[1][1:], cpu[1][1:]):
        _close(g, c, 1e-6 * float(c.abs().max()), agg)


@pytest.mark.cuda
def test_segment_sum_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(8, device="cuda")
    gid = torch.zeros(8, dtype=torch.int64, device="cuda")
    for bad, what in (((x.int(), gid, x.int()), "float16"),
                      ((x, gid.int(), x), "int64"),
                      ((x, gid, x.double()), "out must be"),
                      ((x[::2], gid[::2], x[:4]), "contiguous")):
        with pytest.raises(ValueError, match=what):
            segment_sum.launch(*bad)
    err = segment_sum._kernel()(x.data_ptr() + 2, 2, gid.data_ptr(), 7, x.data_ptr(),
                                gid.data_ptr(), gid.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    assert err != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_time_ms(cuda):
    x = torch.randn(1 << 20, device="cuda")
    times = timing.cuda_time_ms(lambda: torch.sort(x), runs=3)
    assert len(times) == 3 and all(t > 0 for t in times)


# ------------------------------------------------- GROUP BY / ORDER BY slice


def _same(g, c, what=""):
    """A card result against the CPU one, recursively; bit for bit."""
    if isinstance(c, (list, tuple)):
        assert isinstance(g, (list, tuple)) and len(g) == len(c), what
        for i, (a, b) in enumerate(zip(g, c)):
            _same(a, b, f"{what}[{i}]")
        return
    assert g.is_cuda and g.dtype == c.dtype and g.shape == c.shape, what
    gc = g.cpu()
    if c.is_floating_point():
        gc, c = gc.view({4: torch.int32, 8: torch.int64}[c.element_size()]), \
            c.view({4: torch.int32, 8: torch.int64}[c.element_size()])
    assert torch.equal(gc, c), what


def _close(g, c, tol, what=""):
    """Float aggregates: equal NaN positions, |card - cpu| <= tol elsewhere
    (the card's scatter-add sums in another order)."""
    assert g.is_cuda and g.dtype == c.dtype and g.shape == c.shape, what
    g = g.cpu()
    nan = torch.isnan(c)
    assert torch.equal(torch.isnan(g), nan), what
    d = (g[~nan] - c[~nan]).abs()
    assert d.numel() == 0 or float(d.max()) <= tol, what


def _cuda(x):
    return [t.cuda() for t in x] if isinstance(x, (list, tuple)) else x.cuda()


AGGS = list(rst.AGGREGATIONS) + ["quantile:0.9", "quantile_cont:0.9"]
FLOAT_OUT = ("mean", "var", "std", "quantile_cont:0.9")


@pytest.mark.cuda
@pytest.mark.parametrize("keys_kind", ["u32", "composite"])
def test_hash_aggregate_on_card_matches_cpu(cuda, keys_kind):
    """Every aggregation alone and all of them in one multi-aggregate, on
    the card against the CPU. Integer values throughout, so every output
    but the float divisions (mean, var, std, quantile_cont) is exact."""
    rng = np.random.default_rng(3)
    n = 50_000
    if keys_kind == "u32":
        keys = torch.from_numpy(rng.integers(0, 3000, n).astype(np.uint32))
    else:
        keys = [torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)),
                torch.from_numpy(rng.integers(-3, 3, n).astype(np.int64))]
    vals = [torch.from_numpy(rng.integers(-50, 50, n).astype(dt))
            for dt in (np.int8, np.int32, np.int64)]
    vals.append(torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)))
    for v in vals:
        for agg in AGGS:
            cpu = rst.hash_aggregate(keys, v, agg)
            gpu = rst.hash_aggregate(_cuda(keys), v.cuda(), agg)
            _same((gpu[0], gpu[2]), (cpu[0], cpu[2]), agg)
            if agg in FLOAT_OUT:
                _close(gpu[1], cpu[1], 1e-3 * (1 + float(cpu[1].abs().nan_to_num().max())), agg)
            else:
                _same(gpu[1], cpu[1], agg)
    cpu = rst.hash_aggregate(keys, [vals[1]] * len(AGGS), AGGS)
    gpu = rst.hash_aggregate(_cuda(keys), [vals[1].cuda()] * len(AGGS), AGGS)
    for agg, g, c in zip(AGGS, gpu[1], cpu[1]):
        if agg in FLOAT_OUT:
            _close(g, c, 1e-3 * (1 + float(c.abs().nan_to_num().max())), agg)
        else:
            _same(g, c, f"multi {agg}")


@pytest.mark.cuda
def test_float_sums_and_levels_on_card(cuda):
    """Float sums (SS on the card, the plain version's float64 scatter-add
    on the CPU: another order) within (n_g - 1) * u * sum|x| of the CPU's;
    ROLLUP levels (2, 1, 0)."""
    rng = np.random.default_rng(4)
    n = 40_000
    keys = [torch.from_numpy(rng.integers(0, 3, n).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 2, n).astype(np.uint8))]
    x = torch.from_numpy(rng.random(n).astype(np.float32) * 100)
    q = torch.from_numpy(rng.integers(1, 51, n).astype(np.int32))
    aggs = ["sum", "count", "min", "max", "var", "mean", "any", "all"]
    cpu = rst.hash_aggregate_levels(keys, [x, q, x, q, x, x, q, q], aggs, [2, 1, 0])
    gpu = rst.hash_aggregate_levels(_cuda(keys), [x.cuda(), q.cuda(), x.cuda(), q.cuda(),
                                                  x.cuda(), x.cuda(), q.cuda(), q.cuda()],
                                    aggs, [2, 1, 0])
    bound = (n - 1) * 2.0**-24 * float(x.abs().sum())
    for (gk, ga, gc), (ck, ca, cc) in zip(gpu, cpu):
        _same((gk, gc), (ck, cc), "level keys")
        for agg, g, c in zip(aggs, ga, ca):
            if agg in ("sum", "var", "mean"):
                _close(g, c, bound, agg)
            else:
                _same(g, c, agg)


@pytest.mark.cuda
def test_sample_aggregates_on_card_match_cpu(cuda):
    """var_samp / std_samp / corr, with a keep column and with one-row and
    constant groups among 3000, and SQL aggregates inside expressions with
    NULLs skipped, on the card against the CPU: NaN and NULL where the CPU
    has them, values within 1e-9 of the CPU's relative to their size (the
    card's scatter-adds sum in another order)."""
    rng = np.random.default_rng(11)
    n = 200_000
    k = rng.integers(0, 3000, n).astype(np.int32)
    k[:3] = [5000, 5001, 5001]
    x = np.round(rng.random(n) * 100, 6)
    x[k == 7] = 0.1
    a = rng.integers(1, 6, n).astype(np.int32)
    keep = rng.random(n) < 0.9
    cols = [torch.from_numpy(c) for c in (k, x, a, keep)]
    vals = [cols[1], (cols[1], cols[3]), (cols[2], cols[1]), (cols[2], cols[1], cols[3])]
    aggs = ["var_samp", "std_samp", "corr", "corr"]
    cpu = rst.hash_aggregate(cols[0], vals, aggs)
    gpu = rst.hash_aggregate(cols[0].cuda(), [_cuda(v) for v in vals], aggs)
    _same((gpu[0], gpu[2]), (cpu[0], cpu[2]), "keys")
    m = int(cpu[2])
    for agg, g, c in zip(aggs, gpu[1], cpu[1]):
        _close(g[:m], c[:m], 1e-9 * (1 + float(c[:m].abs().nan_to_num().max())), agg)
    t = {"k": k, "a": a, "x": np.ma.MaskedArray(x, ~keep)}
    q = ("SELECT k, MAX(a) - MIN(x) AS r, POW(CORR(a, x), 2) AS r2, STDDEV_SAMP(x) AS sd "
         "FROM t GROUP BY k")
    c = rst.sql(q, {"t": rst.Table(t, device="cpu")}).collect().to_numpy()
    g = rst.sql(q, {"t": rst.Table(t)}).collect().to_numpy()
    assert list(g) == list(c)
    for name in c:
        assert np.array_equal(np.ma.getmaskarray(g[name]), np.ma.getmaskarray(c[name])), name
        np.testing.assert_allclose(np.ma.filled(g[name], 0), np.ma.filled(c[name], 0),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


@pytest.mark.cuda
def test_sort_api_on_card_matches_cpu(cuda):
    """lexsort, sort_segments, top_k and the 128-bit trio on the card; the
    pallas lexsort and sort_pairs128 at 2**19 rows go through K1."""
    rng = np.random.default_rng(5)
    n = 1 << 19
    cols = [torch.from_numpy(rng.integers(0, 2000, n).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)),
            torch.from_numpy(rng.integers(1, 8, n).astype(np.int32))]
    before = extract.LAUNCHES
    _same(rst.lexsort(_cuda(cols), implementation="pallas"), rst.lexsort(cols), "lexsort")
    hi = torch.from_numpy(rng.integers(0, 4, n, dtype=np.uint64))
    lo = torch.from_numpy(rng.integers(0, 2**64, n, dtype=np.uint64))
    v = torch.arange(n, dtype=torch.int32).view(torch.uint32)
    _same(rst.sort_pairs128(hi.cuda(), lo.cuda(), v.cuda(), implementation="pallas"),
          rst.sort_pairs128(hi, lo, v), "sort_pairs128")
    assert extract.LAUNCHES > before
    _same(rst.sort128(hi.cuda(), lo.cuda()), rst.sort128(hi, lo), "sort128")
    _same(rst.argsort128(hi.cuda(), lo.cuda()), rst.argsort128(hi, lo), "argsort128")
    offsets = torch.from_numpy(np.concatenate([[0], np.sort(rng.integers(0, n, 99)), [n]])
                               .astype(np.int32))
    _same(rst.sort_segments(cols[1].cuda(), offsets.cuda(), [cols[0].cuda()], descending=True),
          rst.sort_segments(cols[1], offsets, [cols[0]], descending=True), "sort_segments")
    for largest in (True, False):
        _same(rst.top_k(cols[2].cuda(), 1000, cols[0].cuda(), largest=largest),
              rst.top_k(cols[2], 1000, cols[0], largest=largest), "top_k")
        _same(rst.top_k(_cuda(cols[::2]), 77, cols[1].cuda(), largest=largest),
              rst.top_k(cols[::2], 77, cols[1], largest=largest), "top_k composite")


@pytest.mark.cuda
def test_relational_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    lk = torch.from_numpy(rng.integers(0, 2**32, 30_000, dtype=np.uint64).astype(np.uint32))
    rk = torch.from_numpy(rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32))
    rv = torch.from_numpy(rng.random(50_000))
    valid = torch.from_numpy(rng.random(50_000) < 0.8)
    for direction in rst.ASOF_DIRECTIONS:
        for kw in ({}, {"tolerance": 3_000_000_000}, {"right_valid": valid}):
            kw_g = {k: (x.cuda() if torch.is_tensor(x) else x) for k, x in kw.items()}
            _same(rst.join_asof(lk.cuda(), rk.cuda(), rv.cuda(), direction=direction, **kw_g),
                  rst.join_asof(lk, rk, rv, direction=direction, **kw), direction)
    a = torch.from_numpy(rng.integers(0, 5000, 20_000).astype(np.uint32))
    b = torch.from_numpy(rng.integers(0, 7000, 20_000).astype(np.uint32))
    for op in (rst.set_union, rst.set_intersect, rst.set_difference):
        _same(op(a.cuda(), b.cuda()), op(a, b), op.__name__)
        _same(op([a.cuda(), b.cuda()], [b.cuda(), a.cuda()]), op([a, b], [b, a]), op.__name__)
    for method in ("lower", "higher", "nearest"):
        _same(rst.quantiles(rv.cuda(), [0, 0.3, 0.5, 1], method=method),
              rst.quantiles(rv, [0, 0.3, 0.5, 1], method=method), method)


def _same_tables(g, c, what):
    """Two Tables' ``to_numpy()`` equal: names, dtypes, values, NULL masks."""
    a, b = g.to_numpy(), c.to_numpy()
    assert list(a) == list(b), what
    for name in a:
        x, y = a[name], b[name]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        if isinstance(x, np.ma.MaskedArray):
            assert np.array_equal(np.ma.getmaskarray(x), np.ma.getmaskarray(y)), (what, name)
            x, y = np.ma.getdata(x), np.ma.getdata(y)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), (what, name)


@pytest.mark.cuda
def test_table_join_and_band_join_on_card_match_cpu(cuda):
    """Table.join (inner, left, lookup) and Table.join_band in its
    several-candidate regime on the card against the same calls with
    device="cpu": the same rows, and one K2 launch for each expanding join."""
    rng = np.random.default_rng(7)
    n_l, n_r = 40_000, 30_000
    left = {"k": rng.integers(0, 20_000, n_l).astype(np.int64),
            "s": rng.choice(np.array(["ant", "bee", "cat", "dog"]), n_l),
            "d": rng.integers(0, 1000, n_l).astype(np.int32),
            "x": np.ma.MaskedArray(rng.random(n_l), rng.random(n_l) < 0.1)}
    right = {"k": rng.integers(0, 20_000, n_r).astype(np.int64),
             "s": rng.choice(np.array(["bee", "cat", "eel"]), n_r),
             "lo": rng.integers(0, 1000, n_r).astype(np.int32),
             "y": rng.integers(0, 2**32, n_r, dtype=np.uint64).astype(np.uint32)}
    right["hi"] = (right["lo"] + rng.integers(0, 200, n_r)).astype(np.int32)
    tl, tr = (rst.Table(c) for c in (left, right))
    assert tl.device.type == "cuda"
    cl, cr = (rst.Table(c, device="cpu") for c in (left, right))
    tr, cr = (t.filter(lambda q: q["lo"] % 7 != 0) for t in (tr, cr))
    for on, how in (("k", "inner"), (["s", "k"], "left"), ("k", "lookup")):
        before = expand.LAUNCHES
        g, g_ovf = tl.join(tr, on, capacity=1 << 17, how=how)
        c, c_ovf = cl.join(cr, on, capacity=1 << 17, how=how)
        if how != "lookup":
            assert expand.LAUNCHES == before + 1, how
        assert bool(g_ovf) == bool(c_ovf)
        _same_tables(g, c, f"join {how}")
    before = expand.LAUNCHES
    g, g_ovf = tl.join_band(tr, "d", "between", ("lo", "hi"), on="k", capacity=1 << 17)
    c, c_ovf = cl.join_band(cr, "d", "between", ("lo", "hi"), on="k", capacity=1 << 17)
    assert expand.LAUNCHES == before + 1  # several candidates a row: the expansion
    assert not bool(g_ovf) and not bool(c_ovf)
    _same_tables(g, c, "join_band between")


@pytest.mark.cuda
def test_sql_join_on_card_matches_cpu(cuda):
    """A SQL join with a computed column, a WHERE over both sides, GROUP BY
    and ORDER BY, on CUDA tables against the same query on CPU tables: the
    same rows, every expanding join launching K2, and the expression
    layer's uint32 arithmetic and comparisons running on the card."""
    rng = np.random.default_rng(11)
    n_o, n_c = 30_000, 4_000
    orders = {"o_key": np.arange(n_o, dtype=np.uint32) * 3,
              "o_cust": rng.integers(0, n_c, n_o).astype(np.int64),
              "o_price": np.round(rng.random(n_o) * 1000, 2),
              "o_flag": rng.choice(np.array(["A", "N", "R"]), n_o)}
    custs = {"c_cust": np.arange(n_c, dtype=np.int64),
             "c_seg": rng.choice(np.array(["BUILDING", "MACHINERY"]), n_c),
             "c_bal": np.ma.MaskedArray(rng.integers(-500, 500, n_c).astype(np.int32),
                                        rng.random(n_c) < 0.1)}
    q = ("SELECT c_seg, o_flag, COUNT(*) AS n, SUM(o_price * 2) AS p2, "
         "MAX(o_key % 7 + 1) AS mk FROM custs JOIN orders ON c_cust = o_cust "
         "WHERE c_bal > -100 AND o_key >= 300 GROUP BY c_seg, o_flag "
         "ORDER BY c_seg, o_flag")
    gpu = {"orders": rst.Table(orders), "custs": rst.Table(custs)}
    cpu = {"orders": rst.Table(orders, device="cpu"), "custs": rst.Table(custs, device="cpu")}
    before = expand.LAUNCHES
    g, g_ovf = rst.sql(q, gpu, capacity=1 << 16).collect(return_overflow=True)
    assert expand.LAUNCHES > before
    c, c_ovf = rst.sql(q, cpu, capacity=1 << 16).collect(return_overflow=True)
    assert not bool(g_ovf) and not bool(c_ovf) and g_ovf.device.type == "cuda"
    a, b = g.to_numpy(), c.to_numpy()
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        if name == "p2":  # a float sum: the order of additions may differ
            np.testing.assert_allclose(a[name], b[name], rtol=n_o * 2.0 ** -53)
        else:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.cuda
def test_expressions_on_card_match_cpu(cuda):
    """The expression layer on CUDA tables against the same expressions on
    CPU tables, bit for bit: unsigned arithmetic, comparisons and casts,
    true division by a scalar (correctly rounded, not a multiply by the
    reciprocal), float floor division, min/max and sign, NULL masks, CASE
    and string nodes."""
    from radix_sort_tpu_torch import expr as E

    rng = np.random.default_rng(5)
    n = 10_000
    cols = {"u32": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            "u64": rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
            "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
            "f64": rng.standard_normal(n) * 100,
            "f32": (rng.standard_normal(n) * 100).astype(np.float32),
            "b": rng.random(n) < 0.5,
            "m": np.ma.MaskedArray(rng.integers(-50, 50, n).astype(np.int32),
                                   rng.random(n) < 0.2),
            "s": rng.choice(np.array(["ant", "bee", "cat"]), n)}
    cols["f64"][:4] = [0.0, -0.0, np.inf, np.nan]
    gpu, cpu = rst.Table(cols), rst.Table(cols, device="cpu")
    exprs = [
        E.col("u32") + 1, E.col("u32") * E.col("u32"), -E.col("u32"), E.col("u32") // 7,
        E.col("u32") % 9, E.col("u32") >> 3, E.col("u32") < 2**31, E.col("u32").maximum(5),
        E.col("u64") + E.col("u64"), E.col("u64") // 1000, E.col("u64") % 1000,
        E.col("u64") >> 60, E.col("u64") > E.col("u64") // 2, E.col("u64").minimum(7),
        E.col("u32") - E.col("i32"), E.col("u64") + E.col("i32"), E.col("u32") / 3,
        E.col("i32") // 7, E.col("i32") % -5, E.col("f64") / E.col("f32"), 1.5 / E.col("f64"),
        E.col("f64") // 3.0, E.col("f64") % -2.5, E.col("f64").minimum(0.0),
        E.col("f64").sign(), E.col("f64").sqrt(), E.col("f32") * 2.5,
        E.col("i32").cast("uint32"), E.col("i32").cast("uint64"), E.col("u32").cast("int64"),
        E.col("u64").cast("float64"), E.col("u64").cast("float32"), E.col("u32").cast("float32"),
        E.col("f32").abs().cast("uint32"), E.col("f32").abs().cast("uint64"),
        E.col("b").cast("uint32"), E.col("u32").cast("bool"), E.col("u64").sign(),
        E.col("m") * 2 + 1, E.coalesce(E.col("m"), 0), E.nullif(E.col("m"), 3),
        E.where(E.col("b"), E.col("u32"), E.col("u64")), E.where(E.col("m") > 0, 1, 2.5),
        (E.col("m") > 0) | E.col("b"), E.col("s") < "bee", E.col("s").like("%a%"),
        E.col("s").upper().length(),
    ]
    for e in exprs:
        gv, gm = e.evaluate_masked(gpu)
        cv, cm = e.evaluate_masked(cpu)
        assert gv.dtype == cv.dtype and gv.device.type == "cuda", repr(e)
        assert (gm is None) == (cm is None), repr(e)
        keep = torch.ones(n, dtype=torch.bool) if cm is None else ~cm
        if gm is not None:
            assert torch.equal(gm.cpu(), cm), repr(e)
        g, c = gv.cpu()[keep], cv[keep]
        if c.dtype.is_floating_point:
            nan = torch.isnan(c)
            assert torch.equal(torch.isnan(g), nan), repr(e)
            g, c = g[~nan], c[~nan]
        size = torch.empty((), dtype=c.dtype).element_size()
        as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[size]
        assert torch.equal(g.view(as_int), c.view(as_int)), repr(e)


# ------------------------------------------------- the distributed layer


def _slot_rows(x, counts):
    from radix_sort_tpu_torch.parallel import runtime

    return runtime.valid_rows(x, counts)


@pytest.mark.cuda
def test_distributed_on_a_four_slot_card_mesh(cuda):
    """A small distributed sort, join and repeat on 4 slots of one card,
    against the same calls on 4 CPU slots (bit for bit, per-slot layout
    included); the join and the repeat launch K2 once per slot."""
    from radix_sort_tpu_torch.parallel import dist_query, dist_sort, runtime

    rng = np.random.default_rng(11)
    card = runtime.data_mesh(4, device="cuda")
    cpu = runtime.data_mesh(4, device="cpu")
    assert all(d.type == "cuda" for d in card.devices)
    n = 4 * 4096
    k = torch.from_numpy(rng.integers(0, 1 << 64, n, dtype=np.uint64))
    v = torch.from_numpy(rng.standard_normal(n))
    got = dist_sort.distributed_sort_pairs(k.cuda(), v.cuda(), card)
    want = dist_sort.distributed_sort_pairs(k, v, cpu)
    assert got[0].blocks[0].is_cuda and not bool(got[3])
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(runtime.gather_rows(g).cpu().view(torch.int64),
                           runtime.gather_rows(w).view(torch.int64))
    assert torch.equal(got[2].cpu(), want[2])

    lk = torch.from_numpy(rng.integers(0, 3000, n).astype(np.uint32))
    rk = torch.from_numpy(rng.integers(0, 2000, n).astype(np.uint32))
    lv = torch.from_numpy(rng.integers(-100, 100, n).astype(np.int32))
    rv = torch.from_numpy(rng.random(n).astype(np.float32))
    for how in ("inner", "left", "full"):
        before = expand.LAUNCHES
        got = dist_query.distributed_hash_join(lk.cuda(), lv.cuda(), rk.cuda(), rv.cuda(), card,
                                               capacity_per_shard=1 << 16, how=how)
        assert expand.LAUNCHES - before == 4  # one K2 launch per slot
        want = dist_query.distributed_hash_join(lk, lv, rk, rv, cpu, capacity_per_shard=1 << 16,
                                                how=how)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(runtime.gather_rows(g).cpu().view(torch.int32),
                               runtime.gather_rows(w).view(torch.int32))
        assert torch.equal(got[3].cpu(), want[3]) and not bool(got[4])

    counts = torch.from_numpy(rng.integers(0, 20, n).astype(np.int32))
    before = expand.LAUNCHES
    got = dist_query.distributed_repeat(lv.cuda(), counts.cuda(), card,
                                        total_size_per_shard=1 << 16)
    assert expand.LAUNCHES - before == 4
    assert torch.equal(_slot_rows(got[0], got[1]).cpu(), torch.repeat_interleave(lv, counts))


def _dist_pair(rng, n, frac):
    from radix_sort_tpu_torch.parallel import runtime
    from radix_sort_tpu_torch.parallel.dist_table import DistTable

    cols = {"k": rng.integers(0, 50, n).astype(np.uint32),
            "v": rng.integers(-500, 500, n).astype(np.int32),
            "w": rng.standard_normal(n).astype(np.float32)}
    out = []
    for dev in ("cuda", "cpu"):
        t = rst.Table(cols, int(n * frac), device=dev)
        out.append(DistTable.from_table(t, runtime.data_mesh(4, device=dev)))
    return out


def _same_np(a, b):
    a, b = a.to_numpy(), b.to_numpy()
    assert list(a) == list(b)
    for c in a:
        assert np.array_equal(np.ma.getdata(a[c]), np.ma.getdata(b[c])), c
        assert np.array_equal(np.ma.getmaskarray(a[c]), np.ma.getmaskarray(b[c])), c


@pytest.mark.cuda
def test_dist_table_pipeline_on_a_four_slot_card_mesh(cuda):
    """A small DistTable pipeline on 4 slots of the card against the same
    calls on 4 CPU slots: filter, sort_by, window (halo and carry paths,
    no fallback), aggregate and concat bit for bit; the join and the UNNEST
    launch K2 once per slot."""
    from radix_sort_tpu_torch.parallel import dist_window
    from radix_sort_tpu_torch.parallel.dist_table import DistTable

    rng = np.random.default_rng(12)
    n = 4 * 4096
    card, cpu = _dist_pair(rng, n, 0.8)
    assert card["k"].blocks[0].is_cuda and card.counts.is_cuda
    for f in (lambda d: d.filter(rst.col("v") > 0),
              lambda d: d.sort_by(["k", "w"], descending=[False, True]),
              lambda d: d.concat(d.filter(rst.col("k") < 5))):
        _same_np(f(card), f(cpu))
    ops = {"rn": "row_number", "rk": "rank", "cs": ("cumsum", "v"), "mx": ("max", "w"),
           "lg": ("lag", "v", 2), "ld": ("lead", "w", 1), "rs": ("rolling_sum", "v", 3, 1),
           "rr": ("range_count", 0.25, 0.25), "nv": ("nth_value", "v", 3)}
    got = card.window(ops, partition_by="k", order_by="w")
    assert dist_window._last_fallback is False
    _same_np(got, cpu.window(ops, partition_by="k", order_by="w"))
    aggs = {"s": ("sum", "v"), "n": "count", "m": ("median", "v")}
    _same_np(card.aggregate("k", aggs, max_groups=64), cpu.aggregate("k", aggs, max_groups=64))
    right = {"k": np.arange(50, dtype=np.uint32).repeat(4), "p": np.arange(200, dtype=np.int32)}
    before = expand.LAUNCHES
    dj, ovf = card.join(DistTable(right, card.mesh), "k", capacity_per_shard=1 << 16, how="left")
    assert expand.LAUNCHES - before == 4 and not bool(ovf)
    wj, _ = cpu.join(DistTable(right, cpu.mesh), "k", capacity_per_shard=1 << 16, how="left")
    a, b = dj.to_numpy(), wj.to_numpy()
    rows = [sorted(zip(*(np.ma.filled(x[c], 0).tolist() for c in sorted(x)))) for x in (a, b)]
    assert rows[0] == rows[1]
    c = np.tile([2, 0, 1, 3], n // 4).astype(np.int32)
    before = expand.LAUNCHES
    du, uovf = card.with_columns(c=c).unnest("c", total_size_per_shard=1 << 15)
    assert expand.LAUNCHES - before == 4 and not bool(uovf)
    _same_np(du, cpu.with_columns(c=c).unnest("c", total_size_per_shard=1 << 15)[0])


@pytest.mark.cuda
def test_dist_table_sql_and_asof_on_card(cuda):
    """SQL over DistTable sources on the card (the eager-aggregation lookup
    join) and a distributed ASOF join, against the same calls on CPU slots."""
    from radix_sort_tpu_torch.parallel import runtime
    from radix_sort_tpu_torch.parallel.dist_table import DistTable

    rng = np.random.default_rng(13)
    n = 4 * 2048
    card, cpu = _dist_pair(rng, n, 1.0)
    dim = {"k": np.arange(50, dtype=np.uint32).repeat(2), "seg": np.tile([0, 1], 50)}
    q = ("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM f JOIN d USING (k) WHERE seg = 1 "
         "GROUP BY k ORDER BY k")
    got = rst.sql(q, {"f": card, "d": rst.Table(dim)}, max_groups=64)
    assert "join[lookup on k]" in got.explain()
    _same_np(got.collect(), rst.sql(q, {"f": cpu, "d": rst.Table(dim, device="cpu")},
                                    max_groups=64).collect())
    rt = {"k": np.sort(rng.integers(0, 50, 4 * 64)).astype(np.uint32),
          "px": np.arange(4 * 64, dtype=np.int32)}
    for kw in ({"direction": "backward"}, {"direction": "nearest", "tolerance": 1}):
        a = card.join_asof(DistTable(rt, runtime.data_mesh(4, device="cuda")), "k",
                           matched_col="m", **kw)
        b = cpu.join_asof(DistTable(rt, cpu.mesh), "k", matched_col="m", **kw)
        _same_np(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["comparator", "pallas", "xla_argsort", "oracle"])
@pytest.mark.parametrize("n", [1000, 1 << 19])
def test_sort_pairs_unsigned_payload_on_the_card(cuda, impl, n):
    """(u32, u32) rows, as the demo sorts them: unsigned payloads gather
    through their signed view on the card, on every engine's path."""
    g = torch.Generator().manual_seed(n)
    k = torch.randint(0, 50, (n,), generator=g, dtype=torch.int32).view(torch.uint32)
    v = torch.arange(n, dtype=torch.int32).view(torch.uint32)
    ck, cv = rst.sort_pairs(k.cuda(), v.cuda(), implementation=impl)
    hk, hv = rst.sort_pairs(k, v, implementation=impl)
    assert ck.dtype == cv.dtype == torch.uint32
    assert torch.equal(ck.cpu().view(torch.int32), hk.view(torch.int32))
    assert torch.equal(cv.cpu().view(torch.int32), hv.view(torch.int32))


@pytest.mark.cuda
def test_demo_sweep_and_suites_on_the_card(cuda, capsys):
    from radix_sort_tpu_torch import demo

    demo.main(["--sizes", "0.01", "--dtypes", "u32", "u64", "--runs", "1",
               "--engines", "comparator", "pallas", "--dist", "zipf"])
    demo.main(["--suite", "queries", "--ops-n", "65536", "--runs", "1"])
    demo.main(["--suite", "ops", "--ops-n", "65536", "--groups", "1024", "--runs", "1"])
    out = capsys.readouterr().out
    assert out.count("Sorted 0.01GB") == 4 and "hash_join inner" in out and "Q3 revenue" in out
