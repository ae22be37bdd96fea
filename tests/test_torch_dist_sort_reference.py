"""The distributed sort against the benchmark's blocked plain reference
(``benchmark/reference/dist_sort_pairs.py``), and that reference against
the one-block ``sort_pairs.sort_rows``, on a mesh of 4 CPU slots; the
distributed sort's counters and profiler ranges.

No JAX here: the reference is plain torch, and it imports neither JAX nor
the program (checked in a fresh process).
"""

import subprocess
import sys

import pytest
import torch

from benchmark import distributions as D
from benchmark.reference import dist_sort_pairs as R
from benchmark.reference.sort_pairs import mismatched, sort_rows
from radix_sort_tpu_torch.parallel import collectives, dist_sort, runtime

P = 4
SEED = 2**31 + 17


def keys_of(kind, gen, n):
    if kind == "uniform":
        return D.uniform(gen, n, torch.uint64)
    if kind == "zipf":
        return D.zipf(gen, n, torch.uint64, s=1.1)
    if kind == "step":
        return D.step_uniform(gen, n, torch.uint64, steps=10)
    return torch.full((n,), 7, dtype=torch.int64).view(torch.uint64)  # all equal


def inputs(kind, per, seed=SEED):
    """One (keys, values) block a slot, each from its own stream of the seed."""
    gens = [torch.Generator().manual_seed(seed * P + s) for s in range(P)]
    return ([keys_of(kind, g, per) for g in gens],
            [D.uniform(g, per, torch.uint64) for g in gens])


def program(keys, values):
    mesh = runtime.data_mesh(P, device="cpu")
    k, v, counts, overflow = dist_sort.distributed_sort_pairs(
        runtime.Sharded(mesh, keys), runtime.Sharded(mesh, values), mesh)
    assert not bool(overflow)
    return k.blocks, v.blocks, [int(c) for c in counts.tolist()]


def one_block(keys, values):
    return sort_rows(torch.cat(keys), torch.cat(values))


def bounds(keys, block_rows):
    return R.block_bounds([R._order(k) for k in keys], block_rows, torch.device("cpu"))


@pytest.mark.parametrize("kind,per", [("uniform", 1 << 14), ("zipf", 1 << 16),
                                      ("equal", 1 << 14), ("step", 1 << 15)])
def test_program_matches_blocked_and_plain_reference(kind, per):
    keys, values = inputs(kind, per)
    out_k, out_v, counts = program(keys, values)
    assert sum(counts) == P * per
    assert R.mismatched_rows(keys, values, out_k, out_v, counts) == 0
    small = P * per // 8
    assert len(bounds(keys, small)) >= (1 if kind in ("equal", "step") else 7)
    assert R.mismatched_rows(keys, values, out_k, out_v, counts, block_rows=small) == 0
    got = [torch.cat([x.view(torch.int64)[:c] for x, c in zip(out, counts)]).view(torch.uint64)
           for out in (out_k, out_v)]
    assert mismatched(*got, *one_block(keys, values)) == 0


def test_hot_key_gets_a_block_of_its_own():
    keys, values = inputs("zipf", 1 << 14)
    order = torch.cat([R._order(k) for k in keys])
    vals, cnt = torch.unique(order, return_counts=True)
    hot = int(vals[cnt.argmax()])
    assert int(cnt.max()) > 2048  # the hot key fills more than a block of 2048 rows
    cuts = [None] + bounds(keys, 2048) + [None]
    assert len(cuts) > 10
    blocks = [(lo, hi) for lo, hi in zip(cuts[:-1], cuts[1:])
              if (lo is None or lo <= hot) and (hi is None or hot < hi)]
    assert blocks == [(hot, hot + 1)]


@pytest.mark.parametrize("kind", ["uniform", "zipf", "equal", "step"])
@pytest.mark.parametrize("block_rows", [1 << 28, 4096, 512])
def test_blocked_reference_equals_sort_rows(kind, block_rows):
    """The one-block sort, cut into 4 slots of ragged valid prefixes and
    padding, reads 0; a count one short reads above N, the control (upper
    32 bits) far above 0 on Zipf keys (most of which lie below 2**32)."""
    keys, values = inputs(kind, 1 << 12)
    k, v = one_block(keys, values)
    n = k.shape[0]
    cuts = [0, n // 3, n // 3 + 5, n - 100, n]
    counts = [b - a for a, b in zip(cuts[:-1], cuts[1:])]
    pad = torch.full((64,), -1, dtype=torch.int64)
    out_k = [torch.cat([k.view(torch.int64)[a:b], pad]).view(torch.uint64)
             for a, b in zip(cuts[:-1], cuts[1:])]
    out_v = [torch.cat([v.view(torch.int64)[a:b], pad]).view(torch.uint64)
             for a, b in zip(cuts[:-1], cuts[1:])]
    kw = {"block_rows": block_rows}
    assert R.mismatched_rows(keys, values, out_k, out_v, counts, **kw) == 0
    short = [counts[0] - 1] + counts[1:]
    assert R.mismatched_rows(keys, values, out_k, out_v, short, **kw) >= n
    control = R.mismatched_rows(keys, values, out_k, out_v, counts, key_bits=32, **kw)
    if kind == "zipf":
        assert control > n // 2


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys, benchmark.reference.dist_sort_pairs; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'radix_sort_tpu', "
            "'radix_sort_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_counters_and_ranges_of_a_call():
    keys, values = inputs("zipf", 1 << 12)
    calls, reads, overflows = dist_sort.CALLS, dist_sort.HOST_READS, dist_sort.OVERFLOWS
    peer = collectives.PEER_BYTES
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        program(keys, values)
    names = {e.name for e in prof.events()}
    assert {dist_sort.LOCAL_SORT_RANGE, dist_sort.SPLITTERS_RANGE, dist_sort.FINAL_SORT_RANGE,
            collectives.EXCHANGE_RANGE, collectives.GATHER_RANGE} <= names
    assert (dist_sort.CALLS - calls, dist_sort.HOST_READS - reads) == (1, 1)
    assert dist_sort.OVERFLOWS == overflows
    assert collectives.PEER_BYTES == peer  # four slots of one device move no byte between devices
    mesh = runtime.data_mesh(P, device="cpu")
    dist_sort.distributed_sort_pairs(runtime.Sharded(mesh, keys), runtime.Sharded(mesh, values),
                                     mesh, capacity=1 << 12)
    assert (dist_sort.CALLS - calls, dist_sort.OVERFLOWS - overflows) == (2, 1)


def test_peer_bytes_count_moves_between_devices():
    before = collectives.PEER_BYTES
    x = torch.arange(10, dtype=torch.int64)
    assert collectives._move(x, torch.device("cpu")) is x
    assert collectives.PEER_BYTES == before
    collectives._move(x, torch.device("meta"))
    assert collectives.PEER_BYTES - before == 80
