#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``radix_sort_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the three hand-written kernels from ``csrc/`` (one nvcc each,
started together) and drives the port's paths:

  * the sort: the bucket-extraction kernel (K1, ``csrc/extract.cu``) held
    bit-exact against its plain PyTorch version, also into outputs poisoned
    with 0x5A5A5A5A, so that every slot, sentinel tail included, is shown
    written by the kernel itself (phase 1); the main path --
    ``sort_pairs_limbs(..., engine="sample")`` on uniform (u64, u64) rows
    at 31.25M and 250M rows (0.5 and 4.0 GB, the first and last points of
    the reference's sweep) -- and the public sort API, bit-exact against a
    stable ``torch.sort`` oracle (phase 2); K1 timed at the shapes the main
    path gave it (phase 3);
  * the join: the whole-row run-expansion kernel (K2, ``csrc/expand.cu``)
    held bit-exact against its plain version on the reference's run-length
    specs and on whole rows of every column width into poisoned outputs,
    a cluster of 1M zero-emit runs included, and that cluster's cost timed
    (phase 4); ``rst.hash_join`` and ``rst.repeat`` at TPC-H scale factor
    10 (ORDERS x LINEITEM inner join, CUSTOMER left join ORDERS, a 64x
    UNNEST), each one K2 launch and bit-exact against an oracle built from
    stable ``torch.sort``, ``torch.searchsorted`` and
    ``torch.repeat_interleave`` (phase 5); K2 timed at the shapes the join
    path gave it, beside its bound and the old three-word schedule's
    (phase 6);
  * each kernel wrapper's pieces by device time (``torch.profiler``) at
    the main paths' shapes: every K1 call of one 31.25M-row sort, and the
    join's and UNNEST's expansion steps (phase 7);
  * GROUP BY and ORDER BY at TPC-H scale factor 10 (phase 8): A1 Q1 (a
    filter and one multi-aggregate), A2 Q18's HAVING subquery and its top
    100 orders, A3 Q16's count(distinct) with a median, A4 a ROLLUP over
    Q1's rows, A5 every other aggregation grouped by l_orderkey, each
    against an oracle of ``torch.unique``, stable ``torch.sort``,
    ``index_add_`` and ``scatter_reduce`` (integers, order statistics and
    permutations bit-exact; float sums, means, var and std within the
    worst case of recursive summation in any order); O1 a three-column
    ``lexsort`` of LINEITEM and O2 a 128-bit ``sort_pairs128``, both on the
    kernel engine, so K1 runs on the ORDER BY path; then K1 against its
    plain version at those shapes; the float sums of A1-A5 go through the
    segmented-sum kernel (SS, ``csrc/segment_sum.cu``; launches read as
    K2's here and on every later path that aggregates floats: phases 9-12,
    the demo's suites; the examples' are reported), which is then held
    against its plain version and timed beside
    its bound, the plain version and ``index_add_`` (what the port called
    before; it never does now) at Q1's five float columns, sorted by key,
    and at the db-benchmark groupby task's q4 (1e8 rows into 100 groups)
    and q10 (1e8 rows, nearly every row its own group) columns;
  * the relational facade, ``Table``, at TPC-H scale factor 10 (phase 9):
    T1 Q1, T2 Q3 (two joins), T3 Q13 (a left join), T4 seven window ops
    over ORDERS and a running sum in one partition, T5 band joins (1024
    price tiers, one candidate a row; two date windows per customer, more
    than one) and an UNNEST, each against an oracle of stable
    ``torch.sort``, ``torch.searchsorted``, ``torch.unique``,
    ``index_add_`` and ``torch.repeat_interleave`` (float sums within the
    recursive-summation bound), with wall time, device busy time, top
    device costs, peak memory and K2 launches; the joins, the band join
    with several candidates and the UNNEST go through K2, which is then
    held bit-exact against its plain version and timed beside it and its
    bound at each of those expansions' shapes;
  * the SQL layer at TPC-H scale factor 10 (phase 10): S1 Q1, S2 Q3, S3
    Q13 and S4 Q18 as SQL text through ``rst.sql(text, tables).collect()``
    over phase 9's tables, each with its optimized plan printed, checked
    against its torch oracle, its unoptimized plan checked against the
    optimized one, timed as phase 9 times its workloads, K2 held
    bit-exact against its plain version and timed at every expansion the
    SQL plans make, and the run-ends kernel (``csrc/run_ends.cu``, the
    right rank of every merge-rank union) held bit-exact against its plain
    version and timed beside it, its bound and the zero fill and atomic
    ``scatter_reduce_`` max it replaced, at every union of S2-S4. Every
    other path that joins (phases 5, 9, 11, 12 and 13) counts its run-ends
    launches as it counts K2's, holds the kernel bit-exact against its plain
    version at every union one run of each of its workloads makes, and
    times it at the path's largest union;
  * the distributed layer (phase 11) on a mesh of 4 slots on the card
    (``parallel/``: the slots share the process, the exchange is
    device-local copies): D1 ``distributed_sort_pairs`` of 250M uniform
    (u64, u64) rows, and 31.25M rows on an 8-slot mesh, each bit-exact
    slot by slot against a stable ``torch.sort`` with every count within
    ``exchange_capacity``;
    D2 step-uniform and all-equal keys, and a ``capacity=`` override whose
    fallback is exact; D3 J1 and J2 as ``distributed_hash_join`` (K2 once
    per slot) against the single-device ``rst.hash_join`` as multisets of
    rows, and a forced hot-key fallback; D4 Q1's multi-aggregate and Q18's
    sum by l_orderkey against phase 8's oracles; D5 top-k, DISTINCT,
    quantiles, a filter, an UNNEST (K2 once per slot) and the three set
    operators against torch oracles. Each is timed beside its
    single-device call, with device busy time and the exchange's and the
    all-gathers' shares of it (the ``torch.profiler`` ranges that
    ``parallel/collectives.py`` names; a plan that moves rows fails
    without its exchange range), peak memory and K2 launches; D1's
    one-word run starts are timed by searchsorted and by the compare-sum;
    then K2 is held bit-exact against its plain version
    at every slot's expansion; every final step of the path merges its
    received runs (``csrc/merge_runs.cu``, launches read as K2's; a path
    that merges and never launched fails), and the merge kernel is held
    bit-exact against its plain version at 250M (int64, int64) rows in 4
    Zipf-like runs and timed beside its bound, its plain version and a
    stable ``torch.sort`` of the runs' concatenation (the port never calls
    that);
  * ``DistTable`` on the same 4-slot mesh at TPC-H SF10 (phase 12), over
    phase 9's tables sharded by ``DistTable.from_table``: DT1 Q1 (a filter
    and the distributed aggregate), DT2 Q3 (three filters, two
    co-partitioned joins, K2 once per slot each), DT3 Q13 (a left join and
    two aggregates), DT4 T4's window ops plus lead and nth_value and a
    running sum over one 15M-row partition (the halo and carry paths),
    DT5 the band joins against replicated tiers and date windows, two ASOF
    joins against a sharded seeded right side and T5c's UNNEST, and
    DS1-DS4 phase 10's SQL text over DistTable sources, each checked
    against its torch oracle (where phases 9-10 have one) and against the
    single-device Table or SQL result, with its K2 launches and any
    replicated fallback (none may be taken) read around the call; one
    ``explain()`` shows the broadcast ``join[lookup on ...]``. Each is
    timed as phase 11 times its workloads, then K2 is held bit-exact
    against its plain version at every slot's expansion; its merge
    launches are read as phase 11's;
  * the demo CLI and the host modules (phase 13): (a) the reference's
    sweep through ``demo.main`` -- (u32,u32) and (u64,u64) rows at
    0.5-4.0 GB (500M u32 rows at the top) with the comparator and the
    kernel engine, then zipf, geometric and step-uniform keys at 0.5 and
    4.0 GB -- each batch first held bit-exact across both engines and a
    stable ``torch.sort``, with no comparator fallback, and K1 against its
    plain version at the u32 rows' shapes; (b) a 1 GB zipf dataset
    through ``--gen-data`` / ``--data``, read back bit for bit; (c) the
    ops and queries suites at the demo's defaults, every op and query
    again at 2**20 rows on the card and on the CPU from the same builder
    (integers bit for bit, floats within the summation bound of their own
    group's row count, the variance against the exact one), K2 held
    bit-exact at the suites' expansions; (d) TPC-H SF1 LINEITEM, ORDERS
    and CUSTOMER written as '|'-delimited text, loaded with
    ``Table.from_csv`` through the native loader (every column checked;
    its parse and upload timed again alone with
    ``utils/profiling.PhaseTimer``), Q1 and Q3 as SQL over them equal to
    the same SQL over Tables built from the numpy columns (floats within
    their groups' summation bound),
    ``strings.encode`` / ``unify`` and the native intern against numpy,
    and the native host sort against numpy beside the card's
    ``torch.sort``; (e) the three examples against their numpy oracles,
    with their K1 and K2 launches counted and each kernel held bit-exact
    against its plain version at the examples' shapes.
    Phase 2 also runs the LSD ladder's engines
    (``implementation="xla_argsort"`` / ``"xla_rank"``) on 2**20 uint32 and
    uint64 keys against a stable ``torch.sort``.

Each path runs with its kernels' launch counts set to 0 just before and
read just after (or read around each checked call), and the run fails
unless the path went through the kernel. Every check raises on failure (non-zero exit, no result line).
Without a CUDA device it exits non-zero at once. The last line of standard
output is one JSON object: ``{"ok": true, "device": {...}}``; the line
before it is the per-kernel JSON record.
"""

from __future__ import annotations

import datetime
import functools
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch import _build, demo, keys, native
from radix_sort_tpu_torch.examples import dist_table_demo as ex_dist
from radix_sort_tpu_torch.examples import query_demo as ex_query
from radix_sort_tpu_torch.examples import table_demo as ex_table
from radix_sort_tpu_torch.native import csvio
from radix_sort_tpu_torch.native import host as nhost
from radix_sort_tpu_torch.table import Table
from radix_sort_tpu_torch.ops import (expand, extract, merge_runs, pallas_sort, run_ends,
                                      sample_sort, segment_sum)
from radix_sort_tpu_torch.parallel import collectives as rcoll
from radix_sort_tpu_torch.parallel import dist_asof as rda
from radix_sort_tpu_torch.parallel import dist_query as rdq
from radix_sort_tpu_torch.parallel import dist_sort as rdsort
from radix_sort_tpu_torch.parallel import dist_window as rdw
from radix_sort_tpu_torch.parallel import runtime as rdist
from radix_sort_tpu_torch.utils import distributions as dist
from radix_sort_tpu_torch.utils import io as rio
from radix_sort_tpu_torch.utils import profiling
from radix_sort_tpu_torch.utils import timing

SEED = 0
MAIN_ROWS = (31_250_000, 250_000_000)  # 0.5 GB and 4.0 GB of (u64, u64) rows
KERNEL_CHUNK = 4096  # the main path's chunk length at 31.25M rows
DEV = "cuda"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM data sheet: 3.35 TB/s
POISON = 0x5A5A5A5A  # output buffers are pre-filled with it where a check
# must show that the kernel itself writes every slot

# TPC-H scale factor 10 (specification v3, 4.2.3 and 4.2.5): ORDERS has
# 1.5M x SF rows, CUSTOMER 150k x SF, LINEITEM 1-7 rows per order.
SF10_ORDERS = 15_000_000
SF10_CUSTOMERS = 1_500_000
J1_CAPACITY = 1 << 26  # ~60M LINEITEM rows
J2_CAPACITY = 1 << 24  # 15M orders + 0.5M customers without one
R_VALUES = 1_000_000
R_CAPACITY = 1 << 26  # counts uniform in [0, 128]: ~64M rows
SF10_PARTS = 2_000_000  # PART 200k x SF, PARTSUPP 4 rows per part
SF10_SUPPLIERS = 100_000  # S = 10k x SF in the PS_SUPPKEY formula
O2_ROWS = MAIN_ROWS[0]  # 31.25M uniform (u64 hi, u64 lo) keys
XLA_ROWS = 1 << 20  # the LSD ladder's engines (phase 2)


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


# TPC-H dates (4.2.3, 2.4.1): STARTDATE, ENDDATE, CURRENTDATE, and Q1's
# ship-date bound 1998-12-01 minus DELTA = 90 days
STARTDATE, ENDDATE, CURRENTDATE = _days(1992, 1, 1), _days(1998, 12, 31), _days(1995, 6, 17)
Q1_SHIPDATE = _days(1998, 12, 1) - 90


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check(ok, what="check failed"):
    """Raise (exit non-zero, no result line) when a check fails."""
    if not ok:
        raise SystemExit(f"chip_smoke.py: FAILED: {what}")


def median(xs):
    return statistics.median(xs)


def max_abs_err(pairs):
    err = 0
    for a, b in pairs:
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


# ---------------------------------------------------------------- phase 1


def _bounds(rng, nchunks, K, m):
    """Random run bounds: empty runs, long runs (> 1920) and full-chunk runs,
    partially valid chunks."""
    b = np.zeros((nchunks, K + 1), np.int64)
    for c in range(nchunks):
        kind = c % 4
        if kind == 0:  # the whole chunk is one run
            lens = np.zeros(K, np.int64)
            lens[rng.integers(0, K)] = m
        elif kind == 1:  # one long run among short ones
            valid = int(rng.integers(1921, m + 1))
            long_run = int(rng.integers(1921, valid + 1))
            lens = rng.multinomial(valid - long_run, np.full(K, 1.0 / K))
            lens[rng.integers(0, K)] += long_run
        elif kind == 2:  # random cuts over a random valid prefix
            valid = int(rng.integers(0, m + 1))
            lens = rng.multinomial(valid, np.full(K, 1.0 / K))
        else:  # at most three non-empty runs: mostly empty buckets
            valid = int(rng.integers(0, m + 1))
            lens = np.zeros(K, np.int64)
            for d, part in zip(rng.integers(0, K, 3),
                               rng.multinomial(valid, [1 / 3] * 3)):
                lens[d] += part
        b[c, 1:] = np.cumsum(lens)
    return b.astype(np.int32)


def _ops(gen, n_ops, rows):
    return [torch.randint(-(1 << 31), 1 << 31, (rows, 128), dtype=torch.int32,
                          generator=gen, device=DEV) for _ in range(n_ops)]


def check_kernel(rng, gen):
    """Kernel vs plain version, bit-exact, at the listed shapes; one
    overflowed case with a canary around every output."""
    m = KERNEL_CHUNK
    cases = []  # (label, K, nbuckets, cpb, n_ops, cap_rows)
    for n_ops in (1, 4):
        cases += [
            (f"K=8 nbuckets=1 ops={n_ops}", 8, 1, 64, n_ops, None),
            (f"K=63 nbuckets=4 ops={n_ops}", 63, 4, 48, n_ops, None),
        ]
    pairs = []
    for label, K, nb, cpb, n_ops, cap_rows in cases:
        nchunks = nb * cpb
        bounds = torch.from_numpy(_bounds(rng, nchunks, K, m)).to(DEV)
        ops = _ops(gen, n_ops, nchunks * m // 128)
        if cap_rows is None:
            cap_rows = -(-cpb * m // 128 // 8) * 8  # room for every chunk's word
        kw = dict(K=K, cap_rows=cap_rows, chunks_per_bucket=cpb, nbuckets=nb)
        got, gc = extract.bucket_extract(ops, bounds, **kw)
        ref, rc = extract.bucket_extract_plain(ops, bounds, **kw)
        torch.cuda.synchronize()
        check(torch.equal(gc, rc), label)
        for g, r in zip(got, ref):
            check(torch.equal(g, r), label)
        pairs += list(zip(got, ref)) + [(gc, rc)]
        log(f"kernel vs plain {label}: bit-exact ({int(rc.sum())} words moved)")

    # K=1, the compactor: regions with counts 0, full and over capacity
    for n_ops in (1, 4):
        nreg, cap_rows = 37, m // 128
        counts = torch.from_numpy(rng.integers(0, m + 1, nreg).astype(np.int32))
        counts[0], counts[1], counts[2] = 0, m, m + 777
        counts = counts.to(DEV)
        ops = _ops(gen, n_ops, nreg * cap_rows)
        got, gt = extract.compact_regions(ops, counts, cap_rows=cap_rows)
        nreg8 = -(-nreg // 8) * 8
        out_cap = -(-(nreg8 * cap_rows + 40) // 8) * 8
        clamped = torch.clamp(counts, max=m)
        bounds = torch.stack([torch.zeros_like(clamped), clamped], 1)
        ref, rt = extract.bucket_extract_plain(ops, bounds, K=1, cap_rows=out_cap,
                                               chunks_per_bucket=nreg, nbuckets=1)
        torch.cuda.synchronize()
        check(torch.equal(gt, rt) and int(gt[0]) == int(clamped.sum()), "compact")
        for g, r in zip(got, ref):
            check(torch.equal(g, r), "compact")
        pairs += list(zip(got, ref)) + [(gt, rt)]
        log(f"kernel vs plain K=1 compactor ops={n_ops}: bit-exact ({int(rt[0])} words)")

    # into outputs poisoned with 0x5A5A5A5A inside a guarded buffer: the
    # kernel writes every output word itself, sentinels included, and no
    # word around the outputs. First an overflowed case (capacity far below
    # the runs: counts stay uncapped, writes past capacity drop), then the
    # compactor, whose one region is mostly tail, at 1980 leaves
    for label, K, nb, cpb, cap_rows, counts_in in (
            ("overflow K=8", 8, 2, 32, 16, None),
            ("compactor K=1, 1980 regions", 1, 1, 1980, 1980 * 32 + 40,
             rng.integers(0, m + 1, 1980).astype(np.int32))):
        n_ops = 3
        nchunks = nb * cpb
        if counts_in is None:
            bounds = torch.from_numpy(_bounds(rng, nchunks, K, m)).to(DEV)
        else:
            c = torch.from_numpy(counts_in).to(DEV)
            bounds = torch.stack([torch.zeros_like(c), c], 1).contiguous()
        ops = _ops(gen, n_ops, nchunks * m // 128)
        words = nb * K * cap_rows * 128
        guard = 4096
        canary = torch.randint(-(1 << 31), 1 << 31, (n_ops, words + 2 * guard),
                               dtype=torch.int32, generator=gen, device=DEV)
        buf = canary.clone()
        outs = [buf[w, guard:guard + words] for w in range(n_ops)]
        for o in outs:
            o.fill_(POISON)
        counts = torch.full((nb * K,), POISON, dtype=torch.int32, device=DEV)
        kw = dict(K=K, cap_rows=cap_rows, chunks_per_bucket=cpb, nbuckets=nb)
        extract.launch(ops, bounds, outs, counts, **kw)
        ref, rc = extract.bucket_extract_plain(ops, bounds, **kw)
        torch.cuda.synchronize()
        check(counts_in is not None or int((rc > cap_rows * 128).sum()) > 0,
              "the case must overflow")
        check(torch.equal(counts, rc), f"{label}: counts")
        for o, r in zip(outs, ref):
            check(torch.equal(o, r.reshape(-1)), f"{label}: poisoned outputs")
        check(torch.equal(buf[:, :guard], canary[:, :guard]), f"{label}: canary before")
        check(torch.equal(buf[:, guard + words:], canary[:, guard + words:]),
              f"{label}: canary after")
        pairs += [(counts, rc)] + [(o, r.reshape(-1)) for o, r in zip(outs, ref)]
        tail = int((ref[0] == extract.MAX_WORD).sum())
        log(f"kernel vs plain {label}, outputs poisoned: counts and outputs bit-exact, "
            f"{int((rc > cap_rows * 128).sum())} regions over capacity, {tail:,} sentinel "
            f"words of {words:,}, canary intact")
    return max_abs_err(pairs)


# ---------------------------------------------------------------- phase 2


def main_path(gen):
    """The benchmark path at both sizes, then the public API."""
    for n in MAIN_ROWS:
        khi, klo = dist.key_uniform_limbs(gen, n)
        vhi = dist.key_uniform_limbs(gen, n)[0]
        vlo = torch.arange(n, dtype=torch.int32, device=DEV)  # row id
        rows = (khi, klo, vhi, vlo)
        m, Np, Ks = sample_sort.plan(n)
        log(f"n={n:,}: plan m={m} padded={Np:,} rounds={Ks}")

        ref = pallas_sort.sort_pairs_limbs(*rows, engine="comparator")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        f0, l0 = sample_sort.FALLBACKS, extract.LAUNCHES
        got = pallas_sort.sort_pairs_limbs(*rows, engine="sample")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check(sample_sort.FALLBACKS == f0, "the sample sort fell back")
        check(extract.LAUNCHES - l0 == len(Ks) + 1,
              f"kernel calls {extract.LAUNCHES - l0} != rounds {Ks} + 1")
        for g, r in zip(got, ref):
            check(torch.equal(g, r), f"sample sort differs from torch.sort at n={n}")
        del got, ref
        log(f"n={n:,}: sample engine bit-exact vs stable torch.sort; "
            f"kernel calls {len(Ks) + 1}; fallbacks 0; "
            f"peak allocated {peak / 2**30:.2f} GiB (inputs {16 * n / 2**30:.2f} GiB)")

        t_sample = timing.cuda_time_ms(
            lambda: pallas_sort.sort_pairs_limbs(*rows, engine="sample"), runs=3)
        t_torch = timing.cuda_time_ms(
            lambda: pallas_sort.sort_pairs_limbs(*rows, engine="comparator"), runs=3)
        t_sample += timing.cuda_time_ms(
            lambda: pallas_sort.sort_pairs_limbs(*rows, engine="sample"), runs=2, warmup=0)
        check(sample_sort.FALLBACKS == f0, "the sample sort fell back")
        ms, mt = median(t_sample), median(t_torch)
        log(f"n={n:,}: sample engine median {ms:.3f} ms ({n / ms / 1e3:.1f} M rows/s) "
            f"runs {[round(t, 3) for t in t_sample]}; torch.sort median {mt:.3f} ms "
            f"({n / mt / 1e3:.1f} M rows/s) runs {[round(t, 3) for t in t_torch]}")
        del rows, khi, klo, vhi, vlo
        torch.cuda.empty_cache()

    # public API: the entry workload, (u32, u32) rows at 2**20
    n = 1 << 20
    k = dist.key_uniform(gen, n, torch.uint32)
    v = torch.arange(n, dtype=torch.int32, device=DEV).view(torch.uint32)
    sk, sv = rst.sort_pairs(k, v, implementation="pallas")
    perm = torch.sort(k.view(torch.int32) ^ -(1 << 31), stable=True).indices
    check(torch.equal(sk.view(torch.int32), k.view(torch.int32)[perm]), "sort_pairs keys")
    check(torch.equal(sv.view(torch.int32), v.view(torch.int32)[perm]), "sort_pairs vals")
    log(f"sort_pairs(u32, u32) n={n:,}: bit-exact vs stable torch.sort")

    # f32 with NaNs of both signs, +-0.0 and +-inf, against a host total order
    n = 1 << 18
    bits = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         generator=gen, device=DEV)
    specials = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                         0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                        np.uint32).view(np.int32)
    bits[:: n // 64] = torch.from_numpy(np.resize(specials, 64)).to(DEV)
    x = bits.view(torch.float32)
    got = rst.sort(x, implementation="pallas").view(torch.int32).cpu().numpy()
    u = bits.cpu().numpy().view(np.uint32)
    order_key = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000))
    want = u[np.argsort(order_key, kind="stable")].view(np.int32)
    check(np.array_equal(got, want), "sort(f32) total order")
    log(f"sort(f32 with NaN/-NaN/+-0/+-inf) n={n:,}: bit-exact vs host total order")

    x = dist.key_uniform(gen, n + 12345, torch.int64)
    got = rst.sort(x, implementation="pallas")
    check(torch.equal(got, torch.sort(x, stable=True).values), "sort(i64)")
    log(f"sort(i64) n={n + 12345:,}: bit-exact vs torch.sort")

    # duplicate-heavy: 3 distinct u64 keys, payload order must be kept
    n = MAIN_ROWS[0]
    k = dist.step_uniform(gen, n, 3, torch.uint64)
    idx = torch.arange(n, dtype=torch.int64, device=DEV)
    f0 = sample_sort.FALLBACKS
    sk, sv = rst.sort_pairs(k, idx, implementation="pallas")
    check(sample_sort.FALLBACKS == f0, "the sample sort fell back")
    perm = torch.sort(keys.encode(k), stable=True).indices
    check(torch.equal(sv, perm), "step_uniform payload order (stability)")
    check(torch.equal(sk.view(torch.int64), k.view(torch.int64)[perm]), "step_uniform keys")
    log(f"sort_pairs(step_uniform 3 keys u64, idx) n={n:,}: stable, bit-exact")

    # the LSD ladder (ops/xla_radix.py, stock tensor ops): both engines on
    # 2**20 uniform keys; xla_rank holds a (n, 16) one-hot per pass
    n = XLA_ROWS
    idx = torch.arange(n, dtype=torch.int64, device=DEV)
    for dt in (torch.uint32, torch.uint64):
        k = dist.key_uniform(gen, n, dt)
        w = keys.encode(k)
        perm = torch.sort(w, stable=True).indices
        for impl in ("xla_argsort", "xla_rank"):
            check(torch.equal(keys.encode(rst.sort(k, implementation=impl)), w[perm]),
                  f"sort {impl} {dt}")
            check(torch.equal(rst.argsort(k, implementation=impl), perm), f"argsort {impl} {dt}")
            sk, sv = rst.sort_pairs(k, idx, implementation=impl)
            check(torch.equal(keys.encode(sk), w[perm]) and torch.equal(sv, perm),
                  f"sort_pairs {impl} {dt}")
            ms = median(timing.cuda_time_ms(lambda: rst.sort(k, implementation=impl), runs=3))
            log(f"{impl} {str(dt).replace('torch.', '')} n={n:,}: sort, argsort and sort_pairs "
                f"bit-exact vs stable torch.sort; sort {ms:.3f} ms")


# ---------------------------------------------------------------- phase 3


def kernel_at_main_shapes(gen):
    """Time the kernel against its plain version on the exact arguments one
    31.25M-row main-path sort gives it."""
    n = MAIN_ROWS[0]
    khi, klo = dist.key_uniform_limbs(gen, n)
    vhi, vlo = dist.key_uniform_limbs(gen, n)
    calls = record_k1(lambda: pallas_sort.sort_pairs_limbs(khi, klo, vhi, vlo, engine="sample"))
    del khi, klo, vhi, vlo
    r, err = k1_against_plain(calls, f"the main path's shapes, a {n:,}-row sort")
    log("no single PyTorch call computes a stable multi-region run scatter")
    return r["ms"], r["plain_ms"], r["bound_ms"], err


def record_k1(call):
    """The K1 wrapper calls one ``call()`` makes: [(ops, bounds, kw)]."""
    calls = []
    real = extract.bucket_extract

    def recorder(ops, bounds, **kw):
        calls.append((ops, bounds, kw))
        return real(ops, bounds, **kw)

    extract.bucket_extract = recorder
    try:
        call()
    finally:
        extract.bucket_extract = real
    return calls


def k1_against_plain(calls, what):
    """K1 against its plain version on recorded calls, bit-exact, and timed
    in turns beside its bound: ((kernel, plain, bound) ms summed over the
    calls, max abs err)."""
    total_k = total_p = total_b = 0.0
    err, n_calls = 0, len(calls)
    while calls:
        # each call's inputs are let go once it is checked: at 500M rows the
        # inputs of every call, one call's outputs and its plain version's
        # do not fit on the card together
        ops, bounds, kw = calls.pop(0)
        torch.cuda.empty_cache()
        got, gc = extract.bucket_extract(ops, bounds, **kw)
        ref, rc = extract.bucket_extract_plain(ops, bounds, **kw)
        check(torch.equal(gc, rc) and all(torch.equal(g, r) for g, r in zip(got, ref)),
              f"K1 differs from plain at the {what} shapes")
        # per call: the outputs of every call of a 500M-row sort do not fit together
        err = max(err, max_abs_err([(gc, rc)] + list(zip(got, ref))))
        del got, ref
        mk, mp, _ = interleaved_ms(lambda: extract.bucket_extract(ops, bounds, **kw),
                                   lambda: extract.bucket_extract_plain(ops, bounds, **kw))
        moved = int(torch.clamp(rc, max=kw["cap_rows"] * 128).sum())
        out_words = kw["nbuckets"] * kw["K"] * kw["cap_rows"] * 128
        # the least bytes: each moved word read once, each output word
        # written once, the bounds read and the counts written
        nbytes = len(ops) * 4 * (moved + out_words)
        bound = (nbytes + 4 * bounds.numel() + 4 * rc.numel()) / HBM_BYTES_PER_MS
        total_k, total_p, total_b = total_k + mk, total_p + mp, total_b + bound
        log(f"K1 at {what}: K={kw['K']} nbuckets={kw['nbuckets']} "
            f"cpb={kw['chunks_per_bucket']} ops={len(ops)} words/op={ops[0].numel():,}: "
            f"kernel {mk:.3f} ms ({nbytes / mk / 1e6:.0f} GB/s of read+write), "
            f"plain {mp:.3f} ms, bound {bound:.3f} ms")
    log(f"K1 per {what} call ({n_calls} calls): {total_k:.3f} ms, plain {total_p:.3f} ms, "
        f"bound {total_b:.3f} ms")
    return {"calls": n_calls, "ms": total_k, "plain_ms": total_p,
            "bound_ms": total_b}, err


def interleaved_ms(kernel, plain, library=None):
    """Median CUDA-event ms of ``kernel()``, ``plain()`` and ``library()``
    (None if not given), timed in turns: plain, kernel, kernel, plain."""
    tk, tp, tl = [], [], []
    for _ in range(2):
        tp += timing.cuda_time_ms(plain, runs=2)
        tk += timing.cuda_time_ms(kernel, runs=2)
        if library is not None:
            tl += timing.cuda_time_ms(library, runs=2)
        tk += timing.cuda_time_ms(kernel, runs=2, warmup=0)
        tp += timing.cuda_time_ms(plain, runs=2, warmup=0)
    return median(tk), median(tp), (median(tl) if tl else None)


# ---------------------------------------------------------------- phase 4


def _desc(gen, spec, n_r):
    """Descriptors of (lo, m_copy, m_emit) runs with random key and
    left-value words."""
    spec = torch.tensor(spec, dtype=torch.int32).reshape(-1, 3).to(DEV)
    words = torch.randint(-(1 << 31), 1 << 31, (spec.shape[0], 2), dtype=torch.int32,
                          generator=gen, device=DEV)
    pad = torch.zeros((spec.shape[0], 3), dtype=torch.int32, device=DEV)
    desc = torch.cat([words, spec, pad], 1).contiguous()
    check(bool(((desc[:, 2] + desc[:, 3]) <= n_r).all()), "spec reads past rvs")
    return desc


def _k2_specs(rng):
    """Run-length specs: (label, [(lo, m_copy, m_emit)], capacity or None)."""
    tiers = (1, 2, 127, 128, 129, 383, 384, 385, 895, 896, 1919, 1920)

    def lo():
        return int(rng.integers(0, 100_000))

    many = rng.integers(0, 9, 300_000)
    spec_many = [(lo(), int(m), int(m)) for m in many]
    pre = [(lo(), 7000, 7000) for _ in range(40)]
    cap_pre = 100_000
    start, clamped = 0, []
    for lo_, _, m in pre:  # the callers' clamp: cumulative output <= capacity
        e = max(min(cap_pre - start, m), 0)
        clamped.append((lo_, e, e))
        start += m
    return [
        ("tier boundaries 1..1920", [(lo(), m, m) for m in tiers], None),
        ("runs > 1920", [(0, 1921, 1921), (100, 4000, 4000), (7, 5000, 5000)], None),
        ("5,000- and 100,000-row runs, copy and fill",
         [(lo(), 5000, 5000), (lo(), 100_000, 100_000), (0, 0, 100_000), (3, 0, 5000)], None),
        ("fill (0, 1) and zero-emit runs",
         [(0, 5, 5), (0, 0, 1), (50, 0, 0), (9, 130, 130), (0, 0, 1)] * 2000, None),
        ("300,000 runs, many tiles", spec_many, None),
        ("exact capacity", [(lo(), 3000, 3000) for _ in range(33)], 99_000),
        ("pre-clamped at capacity", clamped, cap_pre),
    ]


def check_expand_kernel(rng, gen):
    """K2 vs its plain version, bit-exact, whole outputs with tail and
    count; then one launch into a guarded buffer (canary)."""
    n_r = 1 << 20
    rvs = torch.randint(-(1 << 31), 1 << 31, (n_r,), dtype=torch.int32, generator=gen,
                        device=DEV)
    pairs = []
    for label, spec, capacity in _k2_specs(rng):
        desc = _desc(gen, spec, n_r)
        total = sum(m for _, _, m in spec)
        if capacity is None:
            capacity = total + 1234
        check(total <= capacity, label)
        got = expand.expand_join_runs(rvs, desc, capacity=capacity)
        ref = expand.expand_join_runs_plain(rvs, desc, capacity=capacity)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            check(g.dtype == r.dtype and torch.equal(g, r), f"K2 vs plain: {label}")
        check(int(got[3]) == total, f"K2 count: {label}")
        pairs += list(zip(got, ref))
        log(f"K2 vs plain, {label}: bit-exact ({len(spec):,} runs, {total:,} rows, "
            f"capacity {capacity:,})")

    # canary: the launch writes its poisoned outputs and count, and nothing
    # around them
    spec = [(int(rng.integers(0, 1000)), int(m), int(m)) for m in rng.integers(0, 50, 5000)]
    desc = _desc(gen, spec, n_r)
    capacity, guard = sum(m for _, _, m in spec) + 77, 4096
    row = -(-(capacity + 2 * guard) // 4) * 4  # every output starts 16-byte aligned
    canary = torch.randint(-(1 << 31), 1 << 31, (4, row), dtype=torch.int32,
                           generator=gen, device=DEV)
    buf = canary.clone()
    outs = [buf[w, guard:guard + capacity] for w in range(3)]
    for o in outs:
        o.fill_(POISON)
    count = buf[3, guard:guard + 1]
    ends, lo, m_copy, cols = expand._join_runs(rvs, desc)
    expand.launch(ends, lo, m_copy, cols, outs, count, capacity=capacity)
    ref = expand.expand_join_runs_plain(rvs, desc, capacity=capacity)
    torch.cuda.synchronize()
    for o, r in zip(outs + [count[0]], ref):
        check(torch.equal(o, r), "K2 launch into a guarded buffer")
    check(torch.equal(buf[:, :guard], canary[:, :guard])
          and torch.equal(buf[:3, guard + capacity:], canary[:3, guard + capacity:])
          and torch.equal(buf[3, guard + 1:], canary[3, guard + 1:]), "K2 canary")
    log("K2 launch into a guarded, poisoned buffer: outputs bit-exact, canary intact")
    return max(max_abs_err(pairs), check_rows_kernel(gen))


# (dtype, copied, tail bits): every width, bool, floats and unsigned dtypes
ROW_COLUMNS = [
    (torch.bool, False, 1), (torch.int8, True, -1), (torch.uint8, False, 0xAB),
    (torch.int16, False, 0x1234), (torch.uint16, True, 0), (torch.float32, False, 0),
    (torch.int32, True, -(1 << 31)), (torch.uint32, True, 0x80000000),
    (torch.float64, True, 0x7FF8000000000001), (torch.int64, False, -1),
    (torch.uint64, True, 5),
]


def _row_args(gen, emits, capacity, columns, n_src=1 << 20):
    """(ends, lo, m_copy, Columns) on the card for int64 ``emits``: random
    copy windows (every 7th run a fill run) and random column bits."""
    n = emits.shape[0]
    ends = torch.cumsum(emits, 0).clamp(max=capacity).to(torch.int32)
    lo = torch.randint(-5, n_src, (n,), dtype=torch.int32, generator=gen, device=DEV)
    m_copy = torch.minimum(emits, torch.randint(0, 300, (n,), generator=gen, device=DEV))
    m_copy[::7] = 0
    cols = []
    for dt, copied, tail in columns:
        size = n_src if copied else n
        if size == 0:
            v = torch.empty((0,), dtype=dt, device=DEV)
        elif dt == torch.bool:
            v = torch.randint(0, 2, (size,), generator=gen, device=DEV).bool()
        else:
            v = torch.randint(0, 256, (size * dt.itemsize,), dtype=torch.uint8,
                              generator=gen, device=DEV).view(dt)
        cols.append(expand.Column(v, copied, tail))
    return ends, lo, m_copy.to(torch.int32), cols


def _rand_emits(gen, n, high):
    return torch.randint(0, high, (n,), generator=gen, device=DEV)


def check_rows_kernel(gen):
    """The whole-row kernel against its plain version, one launch per case,
    into outputs poisoned with 0x5A bytes: every column width, per-column
    tails, a cluster of 1M consecutive zero-emit runs, emits clamped at
    capacity, no runs. Then the cluster's cost at R's shape."""
    zeros = lambda k: torch.zeros((k,), dtype=torch.int64, device=DEV)  # noqa: E731
    cases = [
        ("every width, 500,000 runs of 0-8 rows", _rand_emits(gen, 500_000, 9), None),
        ("runs of 1 to 100,000 rows",
         torch.tensor([5000, 0, 1, 100_000, 3, 0, 0, 4097, 2], device=DEV), None),
        ("a cluster of 1,000,000 zero-emit runs",
         torch.cat([_rand_emits(gen, 3000, 6) + 1, zeros(1_000_000),
                    _rand_emits(gen, 3000, 6) + 1, zeros(50_000)]), None),
        ("emits clamped at capacity", _rand_emits(gen, 200_000, 50), 3_000_001),
        ("no runs", zeros(0), 5000),
    ]
    pairs = []
    for label, emits, capacity in cases:
        if capacity is None:
            capacity = int(emits.sum()) + 4099
        ends, lo, m_copy, cols = _row_args(gen, emits, capacity, ROW_COLUMNS)
        outs = [torch.full((capacity * c.values.element_size(),), 0x5A, dtype=torch.uint8,
                           device=DEV).view(c.values.dtype) for c in cols]
        count = torch.full((1,), POISON, dtype=torch.int32, device=DEV)
        before = expand.LAUNCHES
        expand.launch(ends, lo, m_copy, cols, outs, count, capacity=capacity)
        check(expand.LAUNCHES == before + 1, f"K2 rows {label}: one launch")
        ref, rc = expand.expand_rows_plain(ends, lo, m_copy, cols, capacity=capacity)
        torch.cuda.synchronize()
        check(torch.equal(count[0], rc), f"K2 rows {label}: count")
        for o, r in zip(outs, ref):
            check(o.dtype == r.dtype and torch.equal(o.view(torch.uint8), r.view(torch.uint8)),
                  f"K2 rows {label}: {o.dtype} column")
        pairs += [(o.view(torch.uint8), r.view(torch.uint8)) for o, r in zip(outs, ref)]
        pairs.append((count[0], rc))
        log(f"K2 whole rows vs plain, {label}: bit-exact into poisoned outputs "
            f"({emits.shape[0]:,} runs, {int(rc):,} rows, capacity {capacity:,}, "
            f"{len(cols)} columns of 1-8 bytes, one launch)")

    # the cost of a 1M-run zero-emit cluster at R's shape: one i32 column,
    # 1M runs of 0-128 rows, with and without the cluster in the middle
    emits = _rand_emits(gen, R_VALUES, 129)
    clustered = torch.cat([emits[:R_VALUES // 2], zeros(1_000_000), emits[R_VALUES // 2:]])
    times = {}
    for label, e in (("without", emits), ("with", clustered)):
        ends, _, _, cols = _row_args(gen, e, R_CAPACITY, [(torch.int32, False, 0)])
        times[label] = median(timing.cuda_time_ms(
            lambda: expand.expand_rows(ends, None, None, cols, capacity=R_CAPACITY), runs=5))
    log(f"K2 at R's shape ({R_VALUES:,} runs -> 2^26 slots, one i32 column): "
        f"{times['without']:.3f} ms; with a cluster of 1,000,000 zero-emit runs in the "
        f"middle {times['with']:.3f} ms")
    return max_abs_err(pairs)


# ---------------------------------------------------------------- phase 5


def _bits(t):
    """The same-width signed-integer view (floats compare by their bits)."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def tpch_sf10(gen):
    """ORDERS, LINEITEM, CUSTOMER, PART and PARTSUPP columns of TPC-H
    (specification v3, 4.2.3) at scale factor 10, made on the card from
    ``gen``; rows in random order, so neither join side arrives sorted.
    Dates are int32 days since 1970-01-01; flags are uint8 character codes;
    P_BRAND, P_TYPE and P_SIZE are int32 codes (Brand#MN -> 5(M-1) + N-1,
    a type's syllables (6, 5, 5) -> 25 s1 + 5 s2 + s3)."""
    n_orders, n_customers = SF10_ORDERS, SF10_CUSTOMERS
    i = torch.arange(n_orders, dtype=torch.int64, device=DEV)
    orderkey = (i // 8) * 32 + i % 8 + 1  # sparse keys: 8 of every 32 used
    # O_CUSTKEY: uniform over the customers whose key is not a multiple of 3
    u = torch.randint(0, n_customers * 2 // 3, (n_orders,), generator=gen, device=DEV)
    custkey = 3 * (u // 2) + 1 + u % 2
    totalprice = torch.randint(85_771, 55_528_517, (n_orders,), generator=gen,
                               device=DEV).to(torch.float64) / 100
    per_order = torch.randint(1, 8, (n_orders,), generator=gen, device=DEV)
    l_orderkey = torch.repeat_interleave(orderkey, per_order)
    n_li = l_orderkey.shape[0]
    quantity = torch.randint(1, 51, (n_li,), generator=gen, device=DEV)
    retail = (90_000 + torch.randint(0, 110_001, (n_li,), generator=gen, device=DEV)) / 100
    extendedprice = (quantity * retail).to(torch.float32)
    o_perm = torch.randperm(n_orders, generator=gen, device=DEV)
    l_perm = torch.randperm(n_li, generator=gen, device=DEV)
    c_perm = torch.randperm(n_customers, generator=gen, device=DEV)

    # the GROUP BY / ORDER BY columns, drawn after the join's so those stay
    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=DEV)

    orderdate = draw(STARTDATE, ENDDATE - 151 + 1, n_orders).to(torch.int32)
    order_of = torch.repeat_interleave(torch.arange(n_orders, device=DEV), per_order)
    first_li = torch.cumsum(per_order, 0) - per_order
    linenumber = (torch.arange(n_li, device=DEV) - first_li[order_of] + 1).to(torch.int32)
    shipdate = orderdate[order_of] + draw(1, 122, n_li).to(torch.int32)
    receiptdate = shipdate + draw(1, 31, n_li).to(torch.int32)
    del order_of, first_li
    returned = torch.where(draw(0, 2, n_li) == 0, ord("R"), ord("A"))
    returnflag = torch.where(receiptdate <= CURRENTDATE, returned, ord("N")).to(torch.uint8)
    linestatus = torch.where(shipdate > CURRENTDATE, ord("O"), ord("F")).to(torch.uint8)
    del returned
    discount = draw(0, 11, n_li).to(torch.float64) / 100
    tax = draw(0, 9, n_li).to(torch.float64) / 100
    n_parts, n_supp = SF10_PARTS, SF10_SUPPLIERS
    p_brand = (draw(0, 5, n_parts) * 5 + draw(0, 5, n_parts)).to(torch.int32)
    p_type = draw(0, 150, n_parts).to(torch.int32)
    p_size = draw(1, 51, n_parts).to(torch.int32)
    # PARTSUPP: 4 suppliers per part, PS_SUPPKEY by the 4.2.3 formula
    ps_partkey = torch.arange(1, n_parts + 1, device=DEV).repeat_interleave(4)
    j = torch.arange(4, device=DEV).repeat(n_parts)
    ps_suppkey = (ps_partkey + j * (n_supp // 4 + (ps_partkey - 1) // n_supp)) % n_supp + 1
    ps_cost = draw(100, 100_001, 4 * n_parts).to(torch.float64) / 100
    ps_perm = torch.randperm(4 * n_parts, generator=gen, device=DEV)
    # 5 x SF suppliers whose S_COMMENT holds "Customer ... Complaints" (Q16)
    complaints = draw(1, n_supp + 1, 5 * n_supp // 10_000).to(torch.int32)
    return {
        "o_orderdate": orderdate[o_perm],
        "l_quantity": quantity[l_perm].to(torch.int32),
        "l_discount": discount[l_perm],
        "l_tax": tax[l_perm],
        "l_shipdate": shipdate[l_perm],
        "l_receiptdate": receiptdate[l_perm],
        "l_returnflag": returnflag[l_perm],
        "l_linestatus": linestatus[l_perm],
        "l_linenumber": linenumber[l_perm],
        "p_brand": p_brand,
        "p_type": p_type,
        "p_size": p_size,
        "ps_partkey": ps_partkey[ps_perm].to(torch.int32),
        "ps_suppkey": ps_suppkey[ps_perm].to(torch.int32),
        "ps_supplycost": ps_cost[ps_perm],
        "s_complaints": complaints,
        "o_orderkey": orderkey[o_perm].to(torch.int32).view(torch.uint32),
        "o_custkey": custkey[o_perm],
        "o_custkey32": custkey[o_perm].to(torch.int32),
        "o_totalprice": totalprice[o_perm],
        "l_orderkey": l_orderkey[l_perm].to(torch.int32).view(torch.uint32),
        "l_extendedprice": extendedprice[l_perm],
        "c_custkey": c_perm + 1,
        "c_acctbal": torch.randint(-99_999, 1_000_000, (n_customers,), generator=gen,
                                   device=DEV),
    }


def _rank(keys):
    """int64 keys of the same order (uint32 zero-extended)."""
    if keys.dtype == torch.uint32:
        return keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return keys.to(torch.int64)


def oracle_join(lk, lv, rk, rv, capacity, left):
    """Inner or left join from stable torch.sort, torch.searchsorted and
    torch.repeat_interleave: rows by left row, then right sorted position;
    padded to ``capacity`` with zero values and, for the keys, the lowest
    key of the (integer) dtype, as the JAX package pads them. Returns
    (keys, lv, rv, count, overflow) as bit views."""
    lr, rr = _rank(lk), _rank(rk)
    order = torch.sort(rr, stable=True).indices
    rs, rv_s = rr[order], _bits(rv)[order]
    lo = torch.searchsorted(rs, lr, side="left")
    m = torch.searchsorted(rs, lr, side="right") - lo
    emit = m.clamp(min=1) if left else m
    total = int(emit.sum())
    n = min(total, capacity)
    li = torch.repeat_interleave(torch.arange(lk.shape[0], device=DEV), emit)[:n]
    j = torch.arange(n, device=DEV) - (torch.cumsum(emit, 0) - emit)[li]
    out_rv = rv_s[(lo[li] + j).clamp(max=rk.shape[0] - 1)]
    if left:
        out_rv = torch.where(m[li] > 0, out_rv, 0)

    def pad(x, fill=0):
        return torch.cat([x, torch.full((capacity - n,), fill, dtype=x.dtype, device=DEV)])

    key_fill = torch.iinfo(lk.dtype).min if lk.dtype.is_signed else 0
    return (pad(_bits(lk)[li], key_fill), pad(_bits(lv)[li]), pad(out_rv), n,
            total > capacity)


def oracle_repeat(values, counts, capacity):
    out = torch.repeat_interleave(_bits(values), counts.clamp(min=0))
    total = out.shape[0]
    out = out[:capacity]
    return torch.cat([out, out.new_zeros((capacity - out.shape[0],))]), min(total, capacity), \
        total > capacity


def _check_result(got, want, label):
    *g_cols, g_count, g_over = got
    *w_cols, w_count, w_over = want
    for g, w in zip(g_cols, w_cols):
        check(g.device == w.device and torch.equal(_bits(g), w), f"{label}: columns")
    check(g_count.dtype == torch.int32 and int(g_count) == w_count, f"{label}: count")
    check(bool(g_over) == w_over, f"{label}: overflow")


def join_path(gen):
    """The join path at TPC-H SF10 through the public API, bit-exact against
    the torch oracle, with K2's launches per call checked. Returns the
    workloads (label -> zero-argument call) for timing."""
    t = tpch_sf10(gen)
    log(f"TPC-H SF10 on the card: {t['o_orderkey'].shape[0]:,} orders, "
        f"{t['l_orderkey'].shape[0]:,} lineitems, {t['c_custkey'].shape[0]:,} customers")
    r_values = torch.randint(-(1 << 31), 1 << 31, (R_VALUES,), dtype=torch.int32,
                             generator=gen, device=DEV)
    r_counts = torch.randint(0, 129, (R_VALUES,), dtype=torch.int32, generator=gen, device=DEV)
    work = {
        # label: (call, oracle, K2 launches (one per expansion), rows in)
        "J1 ORDERS inner join LINEITEM on orderkey (u32 key, i32 o_custkey, "
        "f32 l_extendedprice)": (
            lambda: rst.hash_join(t["o_orderkey"], t["o_custkey32"], t["l_orderkey"],
                                  t["l_extendedprice"], capacity=J1_CAPACITY, how="inner"),
            lambda: oracle_join(t["o_orderkey"], t["o_custkey32"], t["l_orderkey"],
                                t["l_extendedprice"], J1_CAPACITY, left=False),
            1, t["o_orderkey"].shape[0] + t["l_orderkey"].shape[0]),
        "J2 CUSTOMER left join ORDERS on custkey (i64 key, i64 c_acctbal, "
        "f64 o_totalprice)": (
            lambda: rst.hash_join(t["c_custkey"], t["c_acctbal"], t["o_custkey"],
                                  t["o_totalprice"], capacity=J2_CAPACITY, how="left"),
            lambda: oracle_join(t["c_custkey"], t["c_acctbal"], t["o_custkey"],
                                t["o_totalprice"], J2_CAPACITY, left=True),
            1, t["c_custkey"].shape[0] + t["o_custkey"].shape[0]),
        "R repeat of 1M i32 values, counts uniform in [0, 128]": (
            lambda: rst.repeat(r_values, r_counts, total_size=R_CAPACITY),
            lambda: oracle_repeat(r_values, r_counts, R_CAPACITY),
            1, R_VALUES),
    }
    for label, (call, oracle, n_calls, _) in work.items():
        before = expand.LAUNCHES
        got = call()
        torch.cuda.synchronize()
        calls = expand.LAUNCHES - before
        check(calls == n_calls, f"{label}: {calls} K2 launches, expected {n_calls}")
        want = oracle()
        _check_result(got, want, label)
        log(f"{label}: bit-exact vs the torch oracle, {want[-2]:,} rows, overflow "
            f"{want[-1]}, K2 calls {calls}")
        del got, want
    return work


def device_kernels(call):
    """[(self device us, name)] of each device kernel of one warm ``call()``,
    from torch.profiler."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((us, e.key))
    return sorted(kernels, reverse=True)


def log_pieces(label, call):
    """Log the device time of every kernel of one warm ``call()``."""
    kernels = device_kernels(call)
    busy = sum(us for us, _ in kernels)
    ms = median(timing.cuda_time_ms(call, runs=3))
    log(f"{label}: {ms:.3f} ms (CUDA events); device busy {busy / 1e3:.3f} ms in "
        f"{len(kernels)} kernels"
        + ("" if busy else " (the profiler showed no device time: not measured)"))
    for us, key in kernels:
        log(f"  {us / 1e3:9.3f} ms  {key[:110]}")


def profile_wrappers(gen):
    """Each kernel wrapper's pieces by device time, at the main paths'
    shapes: every K1 call of one 31.25M-row sample sort, and the expansion
    step (``query._join_expand_kernel`` / ``query._expand_rows``, K2 with
    what surrounds it) of J1, J2 and R."""
    n = MAIN_ROWS[0]
    rows = (*dist.key_uniform_limbs(gen, n), *dist.key_uniform_limbs(gen, n))
    calls = record_k1(lambda: pallas_sort.sort_pairs_limbs(*rows, engine="sample"))
    del rows
    for ops, bounds, kw in calls:
        log_pieces(f"K1 wrapper K={kw['K']} nbuckets={kw['nbuckets']} ops={len(ops)}",
                   lambda: extract.bucket_extract(ops, bounds, **kw))
    del calls
    work = join_path(gen)
    from radix_sort_tpu_torch.ops import query
    for name, attr in (("J1", "_join_expand_kernel"), ("J2", "_join_expand_kernel"),
                       ("R", "_expand_rows")):
        call = next(c for label, (c, *_) in work.items() if label.split()[0] == name)
        fn = getattr(query, attr)
        rec = []
        setattr(query, attr, lambda *a, fn=fn, rec=rec: rec.append(a) or fn(*a))
        try:
            call()
        finally:
            setattr(query, attr, fn)
        log_pieces(f"K2 expansion step at {name} ({attr})", lambda: fn(*rec[0]))
        del rec


def time_join_path(work):
    """Warm wall time, rows/s and peak memory of each workload; its device
    time by kernel, and K2's share of it, from torch.profiler."""
    out = {}
    for label, (call, _, _, rows_in) in work.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        n_out = int(res[-2])
        del res
        ts = timing.cuda_time_ms(call, runs=5)
        ms = median(ts)
        out[label] = ms
        log(f"{label}: median {ms:.3f} ms of {[round(x, 3) for x in ts]}; "
            f"{rows_in / ms / 1e3:.1f} M input rows/s, {n_out / ms / 1e3:.1f} M output rows/s; "
            f"peak allocated {peak / 2**30:.2f} GiB above the inputs")
    for label, (call, _, _, _) in work.items():
        kernels = device_kernels(call)
        busy = sum(us for us, _ in kernels)
        k2 = sum(us for us, k in kernels if "expand_rows(" in k)
        name = label.split()[0]
        if busy > 0:
            log(f"{name} profile: device busy {busy / 1e3:.3f} ms (wall {out[label]:.3f} ms), "
                f"K2 {k2 / 1e3:.3f} ms = {100 * k2 / busy:.1f}% of device time")
            for us, key in kernels[:6]:
                log(f"  {us / 1e3:9.3f} ms  {key[:110]}")
        else:
            log(f"{name} profile: the profiler showed no device time; K2 share not measured")
    return out


# ---------------------------------------------------------------- phase 6


def _k2_bounds(ends, m_copy, columns, capacity):
    """(bytes of this contract, bytes of the old three-word schedule) that
    one expansion must move: each output slot written once at its column's
    width, each per-run value and each copied value read once. The old
    schedule moved 32-bit words, two broadcast and one copied per call,
    each call writing 12 bytes a slot and reading an 8-word descriptor a
    run."""
    n, emits = ends.shape[0], torch.diff(ends, prepend=ends.new_zeros((1,)))
    copied = [c for c in columns if c.copied]
    rows = int(torch.minimum(m_copy, emits).clamp(min=0).sum()) if copied else 0
    nbytes = (4 + 4 * n + (8 * n if copied else 0)
              + sum(c.values.element_size() * (capacity + (rows if c.copied else n))
                    for c in columns))
    words = [(c.values.element_size() + 3) // 4 for c in columns]
    b_words = sum(w for w, c in zip(words, columns) if not c.copied)
    c_words = sum(w for w, c in zip(words, columns) if c.copied)
    calls = max((b_words + 1) // 2, c_words)
    old = calls * (12 * capacity + 32 * n + 4) + 4 * rows * c_words
    return nbytes, old


def record_k2(call):
    """The arguments of every K2 expansion one run of ``call`` makes."""
    calls = []
    real = expand.expand_rows

    def recorder(ends, lo, m_copy, columns, *, capacity):
        calls.append((ends, lo, m_copy, columns, capacity))
        return real(ends, lo, m_copy, columns, capacity=capacity)

    expand.expand_rows = recorder
    try:
        call()
    finally:
        expand.expand_rows = real
    return calls


def k2_at_shapes(workloads):
    """Check K2 bit-exact against its plain version on the exact arguments
    each workload (name -> (call, expected expansions)) gave it, and time it
    beside its plain version, its bound and, where all columns are broadcast
    and of one dtype, one torch.repeat_interleave of the stacked columns.
    A workload with several expansions names them name.1, name.2, ..."""
    real = expand.expand_rows
    rows, err = [], 0
    for name, (call, n_exp) in workloads.items():
        calls = record_k2(call)
        check(len(calls) == n_exp, f"{name}: {len(calls)} expansions, expected {n_exp}")
        for j, (ends, lo, m_copy, columns, capacity) in enumerate(calls):
            shape = name if n_exp == 1 else f"{name}.{j + 1}"
            args = (ends, lo, m_copy, columns)
            got, gc = real(*args, capacity=capacity)
            ref, rc = expand.expand_rows_plain(*args, capacity=capacity)
            check(torch.equal(gc, rc) and all(torch.equal(g, r) for g, r in zip(got, ref)),
                  f"K2 differs from plain at the {shape} shapes")
            err = max(err, max_abs_err([(gc, rc)] + [(g.view(torch.uint8), r.view(torch.uint8))
                                                     for g, r in zip(got, ref)]))
            del got, ref
            total = int(rc)
            library = None
            if not any(c.copied for c in columns) and len({c.values.dtype
                                                             for c in columns}) == 1:
                # a repeat: one PyTorch call on the columns stacked beforehand
                emits = torch.diff(ends, prepend=ends.new_zeros((1,)))
                v = (columns[0].values if len(columns) == 1
                     else torch.stack([c.values for c in columns], 1))

                def library(v=v, emits=emits, total=total):
                    return torch.repeat_interleave(v, emits, dim=0, output_size=total)
            mk, mp, ml = interleaved_ms(lambda: real(*args, capacity=capacity),
                                        lambda: expand.expand_rows_plain(
                                            *args, capacity=capacity), library)
            nbytes, old_bytes = _k2_bounds(ends, m_copy, columns, capacity)
            bound, old_bound = nbytes / HBM_BYTES_PER_MS, old_bytes / HBM_BYTES_PER_MS
            widths = "+".join(f"{c.values.element_size()}{'c' if c.copied else 'b'}"
                              for c in columns)
            row = {"shape": shape, "runs": ends.shape[0], "rows": total,
                   "capacity": capacity, "columns": widths, "ms": mk, "plain_ms": mp,
                   "bound_ms": bound, "old_bound_ms": old_bound, "library_ms": ml}
            lib = f", torch.repeat_interleave {ml:.3f} ms" if ml is not None else ""
            if lo is not None:
                # the same launch with the copy windows laid out in run order:
                # what the copied column's scattered reads cost
                lo_seq = (torch.cumsum(m_copy, 0, dtype=torch.int64) - m_copy).to(torch.int32)
                row["run_order_copy_ms"] = median(timing.cuda_time_ms(
                    lambda: real(ends, lo_seq, m_copy, columns, capacity=capacity), runs=5))
                lib += (f"; with the copy windows in run order {row['run_order_copy_ms']:.3f} ms")
            rows.append(row)
            log(f"K2 at {shape}: {ends.shape[0]:,} runs -> {total:,} rows in {capacity:,} "
                f"slots, columns {widths} (bytes, b broadcast, c copied): kernel {mk:.3f} ms "
                f"({nbytes / mk / 1e6:.0f} GB/s), plain {mp:.3f} ms, bound {bound:.3f} ms "
                f"({100 * bound / mk:.0f}% of it; the old three-word schedule's bound "
                f"{old_bound:.3f} ms){lib}")
        del calls
    return rows, err


def record_run_ends(call):
    """The arguments of every run-ends call one run of ``call`` makes."""
    calls = []
    real = run_ends.run_end_values

    def recorder(run_start, run_id, values):
        calls.append((run_start, run_id, values))
        return real(run_start, run_id, values)

    run_ends.run_end_values = recorder
    try:
        call()
    finally:
        run_ends.run_end_values = real
    return calls


def _time_union(path, shape, run_start, run_id, values):
    """The run-ends kernel at one union, timed beside its plain version, its
    bound and the two PyTorch calls it replaced in merge_rank_pair (a zero
    fill and an atomic ``scatter_reduce_`` amax)."""
    n = run_start.shape[0]
    runs = int(run_id[-1]) + 1
    longest = int(torch.bincount(run_id).max())

    def library():
        run_max = torch.zeros((n,), dtype=torch.int32, device=values.device)
        return run_max.scatter_reduce_(0, run_id, values, "amax", include_self=False)

    mk, mp, ml = interleaved_ms(
        lambda: run_ends.run_end_values(run_start, run_id, values),
        lambda: run_ends.run_end_values_plain(run_start, run_id, values), library)
    # the least bytes: each flag read once, run_id and values read at each
    # run end, one int32 written a run
    nbytes = n + 16 * runs
    bound = nbytes / HBM_BYTES_PER_MS
    log(f"run-ends at {shape} ({path} path): {n:,} rows, {runs:,} runs, longest {longest:,} "
        f"({100 * longest / n:.1f}%): kernel {mk:.3f} ms ({nbytes / mk / 1e6:.0f} GB/s), "
        f"plain {mp:.3f} ms, bound {bound:.3f} ms ({100 * bound / mk:.0f}% of it), "
        f"zeros + scatter_reduce_ amax {ml:.3f} ms")
    return {"path": path, "shape": shape, "rows": n, "runs": runs, "longest_run": longest,
            "ms": mk, "plain_ms": mp, "bound_ms": bound, "library_ms": ml}


def run_ends_at_shapes(path, workloads, every=False):
    """Check the run-ends kernel bit-exact against its plain version, each
    run's entry, on the exact arguments of every union that one run of each
    of a path's workloads (name -> zero-argument call) makes, and time it
    (``_time_union``) at every union with ``every``, else at the path's
    largest. A workload with several unions names them name.1, name.2, ...
    Returns the timed rows."""
    rows, largest, checked = [], None, 0
    for name, call in workloads.items():
        calls = record_run_ends(call)
        n_calls = len(calls)
        for j in range(n_calls):
            # each union's arguments are let go once they are checked (and
            # timed), but for the path's largest
            args = calls.pop(0)
            shape = name if n_calls == 1 else f"{name}.{j + 1}"
            runs = int(args[1][-1]) + 1
            got = run_ends.run_end_values(*args)
            ref = run_ends.run_end_values_plain(*args)
            check(torch.equal(got[:runs], ref[:runs]),
                  f"the run-ends kernel differs from plain at the {shape} shapes")
            checked += 1
            del got, ref
            if every:
                rows.append(_time_union(path, shape, *args))
            elif largest is None or args[0].shape[0] > largest[1][0].shape[0]:
                largest = (shape, args)
            del args
    if largest is not None:
        shape, args = largest
        rows.append(_time_union(path, shape, *args))
    log(f"{path} path: the run-ends kernel bit-exact against plain at {checked} unions")
    return rows


# ---------------------------------------------------------------- phase 8


U32, U64 = 2.0**-24, 2.0**-53  # unit roundoff of float32 and float64


def exact_sums(x, inv, groups):
    """Per-group sums of ``x`` as near-exact float64 (torch calls only):
    each value splits into a multiple of 2**-20, summed exactly in int64,
    and a remainder below 2**-21, summed in float64. Exact to a few float64
    ULP of the sum while the sum of |x| stays below 2**43."""
    x = x.to(torch.float64)
    q = torch.round(x * 2.0**20)
    lo = x - q / 2.0**20
    s = torch.zeros(groups, dtype=torch.int64, device=DEV).index_add_(0, inv, q.to(torch.int64))
    return s.to(torch.float64) / 2.0**20 + torch.zeros(
        groups, dtype=torch.float64, device=DEV).index_add_(0, inv, lo)


def float_checks(kind, got, x, inv, cnt, u):
    """``got`` (sum, mean, var or std per group, rows [0, groups)) against
    the exact statistic of ``x``, within the worst case of recursive
    summation in any order: (n_g - 1) u sum|x| for a sum; that over n_g,
    plus the division's rounding, for a mean; for the two-pass var,
    (n_g + 3) u sum (x - m)^2 / n_g plus the mean's error squared; for std,
    var's bound over sqrt(var). A few float64 ULP of slack cover the
    oracle's own rounding. Returns the largest share of its bound any
    group used."""
    g = cnt.shape[0]
    n = cnt.to(torch.float64)
    s = exact_sums(x, inv, g)
    a = torch.zeros(g, dtype=torch.float64, device=DEV).index_add_(
        0, inv, x.to(torch.float64).abs())
    slack = 8 * U64 * a
    b_sum = (n - 1) * u * a + slack
    mean = s / n
    b_mean = b_sum / n + 2 * u * mean.abs() + slack / n
    if kind in ("sum", "mean"):
        want, bound = (s, b_sum) if kind == "sum" else (mean, b_mean)
    else:
        d = x.to(torch.float64) - mean[inv]
        s2 = exact_sums(d * d, inv, g)
        var = s2 / n
        b_var = (n + 3) * u * s2 / n + b_mean**2 + 2 * u * var + 8 * U64 * s2
        if kind == "var":
            want, bound = var, b_var
        else:
            want = var.sqrt()
            bound = b_var / torch.maximum(want, b_var.sqrt()) + 2 * u * want
    err = (got[:g].to(torch.float64) - want).abs()
    check(bool((err <= bound).all()), f"{kind}: |got - exact| above its bound")
    return float((err / bound).max())


def check_exact(got, want, label):
    """Rows [0, len(want)) of ``got`` bit for bit, dtype included."""
    check(got.dtype == want.dtype, f"{label}: dtype {got.dtype} != {want.dtype}")
    check(torch.equal(_bits(got[:want.shape[0]]), _bits(want)), f"{label}: values")


def groups_of(cols):
    """(unique int64 group keys ascending, inverse, counts) of key columns
    of at most 64 bits together, from torch.unique."""
    key = torch.zeros_like(cols[0][0], dtype=torch.int64)
    for c, bits in cols:
        key = (key << bits) | c.to(torch.int64)
    return torch.unique(key, return_inverse=True, return_counts=True)


def q1_inputs(t):
    """Q1's rows: the filter on the ship date, sliced to its count, and the
    derived price columns (TPC-H 2.4.1)."""
    *c, cnt = rst.filter(t["l_shipdate"] <= Q1_SHIPDATE, t["l_returnflag"], t["l_linestatus"],
                         t["l_quantity"], t["l_extendedprice"], t["l_discount"], t["l_tax"])
    k = int(cnt)
    rf, ls, qty, price, disc, tax = (x[:k] for x in c)
    disc_price = price * (1 - disc)
    return rf, ls, qty, price, disc, tax, disc_price, disc_price * (1 + tax)


Q1_AGGS = ["sum", "sum", "sum", "sum", "mean", "mean", "mean", "count"]


def q1(t):
    rf, ls, qty, price, disc, _, disc_price, charge = q1_inputs(t)
    return rst.hash_aggregate([rf, ls], [qty, price, disc_price, charge, qty, price, disc, qty],
                              Q1_AGGS)


def check_q1(t, got):
    m = t["l_shipdate"] <= Q1_SHIPDATE
    rf, ls, qty, price, disc, tax = (t[k][m] for k in (
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    uk, inv, cnt = groups_of([(rf, 8), (ls, 8)])
    (g_rf, g_ls), aggs, count = got
    check(int(count) == uk.shape[0], "Q1 group count")
    check_exact(g_rf, (uk >> 8).to(torch.uint8), "Q1 l_returnflag")
    check_exact(g_ls, (uk & 255).to(torch.uint8), "Q1 l_linestatus")
    sum_qty = torch.zeros_like(uk).index_add_(0, inv, qty.to(torch.int64)).to(torch.int32)
    check_exact(aggs[0], sum_qty, "Q1 sum_qty")
    check_exact(aggs[4], sum_qty.to(torch.float32) / cnt.to(torch.float32), "Q1 avg_qty")
    check_exact(aggs[7], cnt.to(torch.int32), "Q1 count_order")
    shares = [float_checks("sum", aggs[1], price, inv, cnt, U32),
              float_checks("sum", aggs[2], disc_price, inv, cnt, U64),
              float_checks("sum", aggs[3], charge, inv, cnt, U64),
              float_checks("mean", aggs[5], price, inv, cnt, U32),
              float_checks("mean", aggs[6], disc, inv, cnt, U64)]
    return f"{uk.shape[0]} groups; float aggregates use at most {max(shares):.2e} of their bound"


def q18(t):
    """Q18's subquery, SUM(l_quantity) GROUP BY l_orderkey HAVING > 300, and
    the ORDER BY o_totalprice DESC, o_orderdate LIMIT 100 over the orders
    it keeps (a lookup join on the unique o_orderkey)."""
    uk, sums, cnt = rst.hash_aggregate(t["l_orderkey"], t["l_quantity"], "sum")
    g = int(cnt)
    keys, big, nb = rst.filter(sums[:g] > 300, uk[:g], sums[:g])
    nb = int(nb)
    ok, s, (tp, od), c, _ = rst.hash_join(keys[:nb], big[:nb], t["o_orderkey"],
                                          [t["o_totalprice"], t["o_orderdate"]],
                                          capacity=nb, how="lookup")
    c = int(c)
    return rst.top_k([tp[:c], -od[:c]], min(100, c), ok[:c], s[:c])


def check_q18(t, got):
    lk = _rank(t["l_orderkey"])
    uk, inv = torch.unique(lk, return_inverse=True)
    sums = torch.zeros_like(uk).index_add_(0, inv, t["l_quantity"].to(torch.int64))
    keep = sums > 300
    kk, ks = uk[keep], sums[keep]
    o_sorted, o_idx = torch.sort(_rank(t["o_orderkey"]))
    pos = o_idx[torch.searchsorted(o_sorted, kk)]
    check(torch.equal(o_sorted[torch.searchsorted(o_sorted, kk)], kk), "Q18: every key an order")
    tp, od = t["o_totalprice"][pos], t["o_orderdate"][pos]
    perm = torch.sort(od, stable=True).indices  # rows are in key order already
    perm = perm[torch.sort(tp[perm], stable=True, descending=True).indices][:100]
    (g_tp, g_od), g_key, g_sum = got
    check_exact(g_tp, tp[perm], "Q18 o_totalprice")
    check_exact(g_od, -od[perm], "Q18 -o_orderdate")
    check_exact(g_key, kk[perm].to(torch.int32).view(torch.uint32), "Q18 o_orderkey")
    check_exact(g_sum, ks[perm].to(torch.int32), "Q18 sum(l_quantity)")
    check(g_tp.shape[0] == min(100, kk.shape[0]), "Q18 row count")
    return f"{kk.shape[0]:,} orders above 300 of {uk.shape[0]:,}; top {g_tp.shape[0]}"


Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)
BRAND_45 = 3 * 5 + 4  # Brand#45
MEDIUM_POLISHED = 2 * 5 + 3  # P_TYPE's first two syllables MEDIUM POLISHED


def q16_inputs(t):
    """PARTSUPP joined to PART on the dense part key (a gather), and Q16's
    predicate (2.4.16)."""
    p = t["ps_partkey"].to(torch.int64) - 1
    brand, ptype, size = t["p_brand"][p], t["p_type"][p], t["p_size"][p]
    sizes = torch.tensor(Q16_SIZES, dtype=torch.int32, device=DEV)
    mask = ((brand != BRAND_45) & (ptype // 5 != MEDIUM_POLISHED) & torch.isin(size, sizes)
            & ~torch.isin(t["ps_suppkey"], t["s_complaints"]))
    return mask, brand, ptype, size, t["ps_suppkey"], t["ps_supplycost"]


def q16(t, inputs):
    mask, *cols = inputs
    *c, cnt = rst.filter(mask, *cols)
    k = int(cnt)
    brand, ptype, size, supp, cost = (x[:k] for x in c)
    return rst.hash_aggregate([brand, ptype, size], [supp, cost], ["count_distinct", "median"])


def check_q16(inputs, got):
    mask, brand, ptype, size, supp, cost = inputs
    brand, ptype, size, supp, cost = (x[mask] for x in (brand, ptype, size, supp, cost))
    uk, inv, cnt = groups_of([(brand, 8), (ptype, 8), (size - 1, 8)])
    g = uk.shape[0]
    (g_b, g_t, g_s), (g_cd, g_med), count = got
    check(int(count) == g, "Q16 group count")
    check_exact(g_b, (uk >> 16).to(torch.int32), "Q16 p_brand")
    check_exact(g_t, ((uk >> 8) & 255).to(torch.int32), "Q16 p_type")
    check_exact(g_s, (uk & 255).to(torch.int32) + 1, "Q16 p_size")
    pairs = torch.unique(inv * (SF10_SUPPLIERS + 1) + supp.to(torch.int64))
    cd = torch.zeros(g, dtype=torch.int64, device=DEV).index_add_(
        0, pairs // (SF10_SUPPLIERS + 1), torch.ones_like(pairs))
    check_exact(g_cd, cd.to(torch.int32), "Q16 count(distinct ps_suppkey)")
    order = torch.sort(cost, stable=True).indices
    order = order[torch.sort(inv[order], stable=True).indices]
    starts = torch.cumsum(cnt, 0) - cnt
    check_exact(g_med, cost[order][starts + (cnt - 1) // 2], "Q16 median(ps_supplycost)")
    return f"{mask.sum().item():,} rows pass the predicate, {g:,} groups"


LEVEL_AGGS = ["sum", "count", "min", "max", "var"]


def q1_rollup(rows):
    rf, ls, qty, price, disc, tax = rows[:6]
    return rst.hash_aggregate_levels([rf, ls], [price, qty, disc, tax, qty], LEVEL_AGGS,
                                     [2, 1, 0])


def check_rollup(rows, got):
    rf, ls, qty, price, disc, tax = rows[:6]
    shares = []
    for c, (keys, aggs, count) in zip((2, 1, 0), got):
        cols = [(rf, 8), (ls, 8)][:c] or [(torch.zeros_like(rf), 8)]
        uk, inv, cnt = groups_of(cols)
        g = uk.shape[0]
        check(int(count) == g and len(keys) == c, f"ROLLUP level {c}: groups")
        if c >= 1:
            check_exact(keys[0], (uk >> (8 * (c - 1))).to(torch.uint8), f"level {c} flag")
        if c == 2:
            check_exact(keys[1], (uk & 255).to(torch.uint8), f"level {c} status")
        check_exact(aggs[1], cnt.to(torch.int32), f"level {c} count")
        for i, (x, op) in ((2, (disc, "amin")), (3, (tax, "amax"))):
            want = torch.zeros(g, dtype=x.dtype, device=DEV).scatter_reduce_(
                0, inv, x, op, include_self=False)
            check_exact(aggs[i], want, f"level {c} {op}")
        shares += [float_checks("sum", aggs[0], price, inv, cnt, U32),
                   float_checks("var", aggs[4], qty, inv, cnt, U32)]
    return f"levels (2, 1, 0); float aggregates use at most {max(shares):.2e} of their bound"


A5_AGGS = ["first", "last", "mode", "argmin", "argmax", "any", "all", "std", "quantile:0.9",
           "quantile_cont:0.9"]


def a5_values(t):
    return [t["l_extendedprice"], t["l_shipdate"], t["l_quantity"], t["l_discount"],
            t["l_tax"], t["l_discount"], t["l_tax"], t["l_extendedprice"], t["l_quantity"],
            t["l_extendedprice"]]


def a5(t):
    return rst.hash_aggregate(t["l_orderkey"], a5_values(t), A5_AGGS)


def _by_value(key, x):
    """Rows ordered by (key, x, position): stable sorts, least significant
    first (x numeric, without NaN)."""
    order = torch.sort(x, stable=True).indices
    return order[torch.sort(key[order], stable=True).indices]


def check_a5(t, got):
    key = _rank(t["l_orderkey"])
    n = key.shape[0]
    pos = torch.arange(n, device=DEV)
    uk, inv, cnt = torch.unique(key, return_inverse=True, return_counts=True)
    g = uk.shape[0]
    starts = torch.cumsum(cnt, 0) - cnt
    ends = starts + cnt - 1
    g_keys, aggs, count = got
    check(int(count) == g, "A5 group count")
    check_exact(g_keys, uk.to(torch.int32).view(torch.uint32), "A5 keys")
    by_key = torch.sort(key, stable=True).indices  # input order inside each group
    ep, ship, qty = t["l_extendedprice"], t["l_shipdate"], t["l_quantity"]
    disc, tax = t["l_discount"], t["l_tax"]
    check_exact(aggs[0], ep[by_key[starts]], "A5 first")
    check_exact(aggs[1], ship[by_key[ends]], "A5 last")
    # mode: the longest (key, qty) run, ties to the smallest qty
    o = _by_value(key, qty)
    kq = key[o] * 64 + qty[o]
    runs, rcnt = torch.unique_consecutive(kq, return_counts=True)
    r_key, r_qty = runs // 64, runs % 64
    r_gid = torch.searchsorted(uk, r_key)
    s = torch.sort(r_qty, stable=True).indices
    s = s[torch.sort(-rcnt[s], stable=True).indices]
    s = s[torch.sort(r_gid[s], stable=True).indices]
    first_run = torch.cat([torch.ones(1, dtype=torch.bool, device=DEV),
                           r_gid[s][1:] != r_gid[s][:-1]])
    check_exact(aggs[2], r_qty[s][first_run].to(torch.int32), "A5 mode")
    check_exact(aggs[3], pos[_by_value(key, disc)][starts].to(torch.int32), "A5 argmin")
    check_exact(aggs[4], pos[_by_value(key, -tax)][starts].to(torch.int32), "A5 argmax")
    nz = lambda x: torch.zeros_like(uk).index_add_(0, inv, (x != 0).to(torch.int64))  # noqa: E731
    check_exact(aggs[5], nz(disc) > 0, "A5 any")
    check_exact(aggs[6], nz(tax) == cnt, "A5 all")
    share = float_checks("std", aggs[7], ep, inv, cnt, U32)
    span = cnt - 1
    q_off = torch.floor(span.to(torch.float32) * 0.9 + 1e-6).to(torch.int64)
    check_exact(aggs[8], qty[o][starts + q_off], "A5 quantile:0.9")
    se = ep[_by_value(key, ep)].to(torch.float64)
    r = span.to(torch.float64) * 0.9
    lo = torch.floor(r + 1e-6).to(torch.int64).clamp(min=0)
    lo = torch.minimum(lo, span)
    hi = torch.minimum(lo + 1, span)
    frac = (r - lo.to(torch.float64)).clamp(0.0, 1.0)
    vlo, vhi = se[starts + lo], se[starts + hi]
    want = vlo + frac * (vhi - vlo)
    err = (aggs[9][:g] - want).abs()
    tol = 4 * U64 * torch.maximum(vlo.abs(), vhi.abs())  # 4 float64 ULP of the larger bracket
    check(aggs[9].dtype == torch.float64 and bool((err <= tol).all()), "A5 quantile_cont:0.9")
    return (f"{g:,} groups; std uses at most {share:.2e} of its bound; quantile_cont "
            f"max |err| {float(err.max()):.3g}")


def lexsort_o1(t):
    return rst.lexsort([t["l_shipdate"], t["l_orderkey"], t["l_linenumber"]],
                       implementation="pallas")


def check_o1(t, got):
    p = torch.sort(t["l_linenumber"], stable=True).indices
    p = p[torch.sort(_rank(t["l_orderkey"])[p], stable=True).indices]
    p = p[torch.sort(t["l_shipdate"][p], stable=True).indices]
    check_exact(got, p, "O1 permutation")
    return f"{got.shape[0]:,} rows, permutation bit-exact"


def _u64_rank(x):
    return x.view(torch.int64) ^ -(1 << 63)


def check_o2(hi, lo, v, got):
    (g_hi, g_lo), g_v = got
    p = torch.sort(_u64_rank(lo), stable=True).indices
    p = p[torch.sort(_u64_rank(hi)[p], stable=True).indices]
    # gathered as their signed views: CUDA indexing has no unsigned kernels
    check_exact(g_hi, _bits(hi)[p].view(hi.dtype), "O2 hi")
    check_exact(g_lo, _bits(lo)[p].view(lo.dtype), "O2 lo")
    check_exact(g_v, _bits(v)[p].view(v.dtype), "O2 payload")
    return f"{hi.shape[0]:,} rows, keys and payload bit-exact"


def groupby_path(t):
    """A1-A5 at TPC-H SF10 through the public API, each checked once against
    its torch oracle. Returns the workloads (label -> (call, rows in))."""
    rows = q1_inputs(t)
    q16_in = q16_inputs(t)
    n_li, n_o = t["l_orderkey"].shape[0], t["o_orderkey"].shape[0]
    work = {
        "A1 Q1: filter(l_shipdate), one multi-aggregate by (returnflag, linestatus)":
            (lambda: q1(t), lambda got: check_q1(t, got), n_li),
        "A2 Q18: sum(l_quantity) by l_orderkey, HAVING > 300, top_k 100 of its orders":
            (lambda: q18(t), lambda got: check_q18(t, got), n_li + n_o),
        "A3 Q16: count(distinct ps_suppkey), median(ps_supplycost) by brand, type, size":
            (lambda: q16(t, q16_in), lambda got: check_q16(q16_in, got),
             t["ps_partkey"].shape[0]),
        "A4 ROLLUP(returnflag, linestatus) over Q1's rows: sum, count, min, max, var":
            (lambda: q1_rollup(rows), lambda got: check_rollup(rows, got), rows[0].shape[0]),
        "A5 first, last, mode, argmin, argmax, any, all, std, quantile(_cont) by l_orderkey":
            (lambda: a5(t), lambda got: check_a5(t, got), n_li),
    }
    for label, (call, verify, _) in work.items():
        got = call()
        torch.cuda.synchronize()
        log(f"{label.split(':')[0]}: matches the torch oracle; {verify(got)}")
        del got
    return {label: (call, rows_in) for label, (call, _, rows_in) in work.items()}


def orderby_path(t, gen):
    """O1 and O2 on the kernel engine, each checked once against a stable
    torch.sort oracle. Returns the workloads."""
    hi = dist.key_uniform(gen, O2_ROWS, torch.uint64)
    lo = dist.key_uniform(gen, O2_ROWS, torch.uint64)
    v = torch.arange(O2_ROWS, dtype=torch.int32, device=DEV).view(torch.uint32)
    work = {
        "O1 lexsort([l_shipdate, l_orderkey, l_linenumber]), pallas":
            (lambda: lexsort_o1(t), lambda got: check_o1(t, got), t["l_orderkey"].shape[0]),
        "O2 sort_pairs128 of uniform (u64, u64) keys, u32 payload, pallas":
            (lambda: rst.sort_pairs128(hi, lo, v, implementation="pallas"),
             lambda got: check_o2(hi, lo, v, got), O2_ROWS),
    }
    for label, (call, verify, _) in work.items():
        f0 = sample_sort.FALLBACKS
        got = call()
        torch.cuda.synchronize()
        check(sample_sort.FALLBACKS == f0, f"{label}: the sample sort fell back")
        log(f"{label.split()[0]}: matches the torch oracle; {verify(got)}")
        del got
    return {label: (call, rows_in) for label, (call, _, rows_in) in work.items()}


def time_workloads(work):
    """Warm wall time (CUDA events, median of 5), peak memory above the
    inputs and the top device costs (torch.profiler) of each workload."""
    out = {}
    for label, (call, rows_in) in work.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del res
        ts = timing.cuda_time_ms(call, runs=5)
        ms = median(ts)
        kernels = device_kernels(call)
        busy = sum(us for us, _ in kernels)
        name = label.split()[0]
        out[name] = {"ms": ms, "busy_ms": busy / 1e3, "peak_gib": peak / 2**30}
        log(f"{name}: median {ms:.3f} ms of {[round(x, 3) for x in ts]}; "
            f"{rows_in / ms / 1e3:.1f} M input rows/s; peak allocated {peak / 2**30:.2f} GiB "
            f"above the inputs; device busy "
            + (f"{busy / 1e3:.3f} ms in {len(kernels)} kernels, idle "
               f"{100 * (1 - busy / 1e3 / ms):.1f}% of the wall time" if busy else
               "not measured (the profiler showed no device time)"))
        if busy / 1e3 > ms:
            log(f"{name} WARNING: device busy exceeds the wall time (kernels overlapped, or "
                f"the profiled call ran slower than the median timed one); the idle share "
                f"above is negative and not meaningful")
        if busy:
            log(f"{name} top device costs: " + "; ".join(
                f"{k[:60]} {us / 1e3:.3f} ms ({100 * us / busy:.1f}%)"
                for us, k in kernels[:5]))
    return out


SS_ROWS = 100_000_000  # the db-benchmark groupby task's G1_1e8 table


def ss_call(label, x, gid):
    """SS at one column: one launch, against its plain version (within
    both sides' float64 summation error, and one rounding of the narrower
    types), rows past the groups +0.0, then timed beside its bound (the
    column read and every output row written once), the plain version and
    ``index_add_`` in the column's type, what the port called before."""
    before = segment_sum.LAUNCHES
    got = segment_sum.segment_sum_sorted(x, gid)
    torch.cuda.synchronize()
    check(segment_sum.LAUNCHES == before + 1, f"SS {label}: not one launch")
    ref = segment_sum.segment_sum_sorted_plain(x, gid)
    n, groups = x.shape[0], int(gid[-1]) + 1
    rows = torch.bincount(gid, minlength=n).to(torch.float64)
    absum = torch.zeros(n, dtype=torch.float64, device=DEV).index_add_(0, gid, x.double().abs())
    tol = 2 * rows * U64 * absum
    if x.dtype != torch.float64:
        tol += torch.finfo(x.dtype).eps * ref.double().abs()
    err = (got.double() - ref.double()).abs()
    check(bool((err <= tol).all()), f"SS {label}: off its plain version")
    check(not bool(_bits(got[groups:]).any()), f"SS {label}: rows past the groups not +0.0")
    del got, ref, rows, absum, tol, err
    mk, mp, ml = interleaved_ms(lambda: segment_sum.segment_sum_sorted(x, gid),
                                lambda: segment_sum.segment_sum_sorted_plain(x, gid),
                                lambda: torch.zeros_like(x).index_add_(0, gid, x))
    nbytes = 2 * n * x.element_size()
    bound = nbytes / HBM_BYTES_PER_MS
    dt = str(x.dtype).replace("torch.", "")
    log(f"SS {label}: {n:,} {dt} rows into {groups:,} groups: kernel {mk:.3f} ms "
        f"({nbytes / mk / 1e6:.0f} GB/s), bound {bound:.3f} ms ({100 * bound / mk:.0f}% of it), "
        f"plain {mp:.3f} ms, index_add_ {ml:.3f} ms")
    return {"shape": f"{label}: {n:,} {dt} rows into {groups:,} groups", "rows": n,
            "ms": mk, "plain_ms": mp, "bound_ms": bound, "library_ms": ml}


def ss_at_shapes(t, gen):
    """SS at Q1's five float sums (SUM and AVG of l_extendedprice, the two
    derived revenue sums, AVG(l_discount)), each column sorted by
    (l_returnflag, l_linestatus) as hash_aggregate sorts it, and at the
    db-benchmark groupby task's q4 (v3 into 100 groups) and q10 (v3 by six
    keys: nearly every row its own group) at 1e8 rows."""
    rf, ls, _, price, disc, _, disc_price, charge = q1_inputs(t)
    key, perm = torch.sort((rf.to(torch.int32) << 8) | ls.to(torch.int32), stable=True)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    gid = torch.cumsum(first, 0) - 1
    calls = [ss_call(label, col[perm], gid) for label, col in (
        ("Q1 sum(l_extendedprice)", price), ("Q1 avg(l_extendedprice)", price),
        ("Q1 sum(disc_price)", disc_price), ("Q1 sum(charge)", charge),
        ("Q1 avg(l_discount)", disc))]
    del rf, ls, price, disc, disc_price, charge, key, perm, first, gid
    v3 = torch.round(torch.rand(SS_ROWS, generator=gen, device=DEV, dtype=torch.float64)
                     * 1e8) / 1e6
    gid = torch.sort(torch.randint(0, 100, (SS_ROWS,), generator=gen, device=DEV)).values
    calls.append(ss_call("h2o q4 avg(v3)", v3, gid))
    first = torch.rand(SS_ROWS, generator=gen, device=DEV) >= 1e-3
    first[0] = True
    gid = torch.cumsum(first, 0) - 1
    calls.append(ss_call("h2o q10 sum(v3)", v3, gid))
    del v3, gid, first
    torch.cuda.empty_cache()
    return calls


# ---------------------------------------------------------------- phase 9

Q3_DATE = _days(1995, 3, 15)  # TPC-H 2.4.3 substitution parameters
SEGMENTS = np.array(["", "AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"])
RETURNFLAGS, LINESTATUSES = np.array(["", "A", "N", "R"]), np.array(["", "F", "O"])
T2_CAPACITY = (1 << 21, 1 << 22)  # ~1.46M BUILDING orders, ~0.3M of their lineitems
T3_CAPACITY = 1 << 24  # 14.85M kept orders + ~0.5M customers without one
T5_TIERS = 1024
# disjoint tiers [lo, lo + 545 - 2**-10], lo = 800 + 545 i, exact in float64: every
# O_TOTALPRICE (whole cents in [857.71, 555285.17]) lies in exactly one
T5_TIER_LO, T5_TIER_W, T5_TIER_SPAN = 800.0, 545.0, 545.0 - 2.0**-10
T5_CAPACITY = 1 << 25
U_VALUES, U_CAPACITY = 1_000_000, 1 << 26


def _codes(chars, vocab):
    """uint8 character codes -> uint32 codes into ``vocab`` (sorted, "" at
    index 0), by a 256-entry lookup on the card."""
    lut = torch.zeros(256, dtype=torch.int32, device=DEV)
    for i, v in enumerate(vocab[1:], 1):
        lut[ord(v)] = i
    return lut[chars.to(torch.int64)].view(torch.uint32)


def facade_tables(t, gen):
    """The SF10 columns as Tables on the card: the flags as uint32 codes
    plus dictionaries (no host string arrays), C_MKTSEGMENT drawn uniformly
    from its 5 values (4.2.3), dates as int32 days, and Q13's o_comment
    NOT LIKE '%special%requests%' as a seeded 1% flag."""
    n_c, n_o = t["c_custkey"].shape[0], t["o_orderkey"].shape[0]
    seg = torch.randint(1, 6, (n_c,), generator=gen, device=DEV).to(torch.int32)
    lineitem = Table({
        "l_orderkey": t["l_orderkey"], "l_returnflag": _codes(t["l_returnflag"], RETURNFLAGS),
        "l_linestatus": _codes(t["l_linestatus"], LINESTATUSES),
        "l_quantity": t["l_quantity"], "l_extendedprice": t["l_extendedprice"],
        "l_discount": t["l_discount"], "l_tax": t["l_tax"], "l_shipdate": t["l_shipdate"],
    }, dictionaries={"l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUSES}, device=DEV)
    orders = Table({
        "o_orderkey": t["o_orderkey"], "o_custkey": t["o_custkey"],
        "o_orderdate": t["o_orderdate"], "o_totalprice": t["o_totalprice"],
        "o_shippriority": torch.zeros(n_o, dtype=torch.int32, device=DEV),
        "o_special": torch.rand(n_o, generator=gen, device=DEV) < 0.01,
    }, device=DEV)
    customer = Table({"c_custkey": t["c_custkey"], "c_mktsegment": seg.view(torch.uint32)},
                     dictionaries={"c_mktsegment": SEGMENTS}, device=DEV)
    return lineitem, orders, customer


def t1_q1(li):
    """TPC-H Q1 (2.4.1) through Table calls."""
    t = li.filter(li["l_shipdate"] <= Q1_SHIPDATE)
    t = t.with_columns(disc_price=t["l_extendedprice"] * (1 - t["l_discount"]))
    t = t.with_columns(charge=t["disc_price"] * (1 + t["l_tax"]))
    t = t.aggregate(["l_returnflag", "l_linestatus"], {
        "sum_qty": ("sum", "l_quantity"), "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", "disc_price"), "sum_charge": ("sum", "charge"),
        "avg_qty": ("mean", "l_quantity"), "avg_price": ("mean", "l_extendedprice"),
        "avg_disc": ("mean", "l_discount"), "count_order": "count"})
    return t.sort_by(["l_returnflag", "l_linestatus"])


def check_t1(raw, got):
    """T1 against phase 8's Q1 oracle: the string codes decode to the flag
    characters, the aggregates in the order Q1_AGGS lists them."""
    k = int(got.count)
    chars = {}
    for name, vocab in (("l_returnflag", RETURNFLAGS), ("l_linestatus", LINESTATUSES)):
        lut = torch.tensor([0] + [ord(v) for v in vocab[1:]], dtype=torch.int32, device=DEV)
        chars[name] = lut[got[name][:k].view(torch.int32).to(torch.int64)].to(torch.uint8)
        check(list(got.dictionary(name)) == list(vocab), f"T1 {name} dictionary")
    aggs = [got[c][:k] for c in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
                                 "avg_qty", "avg_price", "avg_disc", "count_order")]
    return check_q1(raw, ((chars["l_returnflag"], chars["l_linestatus"]), aggs, got.count))


def t2_q3(li, orders, customer):
    """TPC-H Q3 (2.4.3): CUSTOMER filtered on 'BUILDING' joins ORDERS
    before the date, then LINEITEM after it (two joins, one K2 launch
    each), revenue summed per (l_orderkey, o_orderdate, o_shippriority),
    the top 10 by revenue desc, o_orderdate."""
    c = customer.filter(customer["c_mktsegment"].view(torch.int32)
                        == int(customer.code("c_mktsegment", "BUILDING").view(torch.int32)))
    o = orders.filter(orders["o_orderdate"] < Q3_DATE).select(
        "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority").rename(
        {"o_custkey": "c_custkey", "o_orderkey": "l_orderkey"})
    co, ovf1 = c.join(o, "c_custkey", capacity=T2_CAPACITY[0])
    lf = li.filter(li["l_shipdate"] > Q3_DATE).select("l_orderkey", "l_extendedprice",
                                                      "l_discount")
    col, ovf2 = co.join(lf, "l_orderkey", capacity=T2_CAPACITY[1])
    col = col.with_columns(revenue=col["l_extendedprice"] * (1 - col["l_discount"]))
    agg = col.aggregate(["l_orderkey", "o_orderdate", "o_shippriority"],
                        {"revenue": ("sum", "revenue")})
    agg = agg.with_columns(neg_date=-agg["o_orderdate"])
    return agg.top_k(10, ["revenue", "neg_date"]), (ovf1, ovf2)


def check_t2(raw, li, orders, customer, out):
    """The Q3 oracle: membership by sort + searchsorted, revenue per order
    by torch.unique + index_add_ (near-exact), the top 10 by a stable sort;
    revenues within the recursive-summation bound."""
    got, ovfs = out
    check(not any(bool(o) for o in ovfs), "T2: a join overflowed its capacity")
    seg = customer["c_mktsegment"].view(torch.int32)
    bc = torch.sort(raw["c_custkey"][seg == 2]).values
    ok_o = raw["o_orderdate"] < Q3_DATE
    pos = torch.searchsorted(bc, raw["o_custkey"]).clamp(max=bc.shape[0] - 1)
    ok_o &= bc[pos] == raw["o_custkey"]
    ok_keys, ok_idx = torch.sort(_rank(raw["o_orderkey"])[ok_o])
    ok_dates = raw["o_orderdate"][ok_o][ok_idx]
    lk = _rank(raw["l_orderkey"])
    p = torch.searchsorted(ok_keys, lk).clamp(max=ok_keys.shape[0] - 1)
    ok_l = (ok_keys[p] == lk) & (raw["l_shipdate"] > Q3_DATE)
    rev = raw["l_extendedprice"][ok_l] * (1 - raw["l_discount"][ok_l])
    uk, inv, cnt = torch.unique(lk[ok_l], return_inverse=True, return_counts=True)
    exact = exact_sums(rev, inv, uk.shape[0])
    dates = ok_dates[torch.searchsorted(ok_keys, uk)]
    order = torch.sort(dates, stable=True).indices  # uk ascending: ties by key
    order = order[torch.sort(exact[order], stable=True, descending=True).indices][:10]
    k = int(got.count)
    check(k == min(10, uk.shape[0]), "T2 row count")
    check_exact(got["l_orderkey"][:k], uk[order].to(torch.int32).view(torch.uint32),
                "T2 l_orderkey")
    check_exact(got["o_orderdate"][:k], dates[order], "T2 o_orderdate")
    check_exact(got["o_shippriority"][:k], torch.zeros(k, dtype=torch.int32, device=DEV),
                "T2 o_shippriority")
    a = torch.zeros(uk.shape[0], dtype=torch.float64, device=DEV).index_add_(0, inv, rev.abs())
    bound = (cnt[order] - 1) * U64 * a[order] + 8 * U64 * a[order]
    err = (got["revenue"][:k] - exact[order]).abs()
    check(bool((err <= bound).all()), "T2 revenue above its bound")
    return (f"{int(ok_o.sum()):,} BUILDING orders before {Q3_DATE}, {int(ok_l.sum()):,} "
            f"lineitems, {uk.shape[0]:,} groups; top {k} bit-exact, revenue within "
            f"{float((err / bound).max()):.2e} of its bound")


def t3_q13(orders, customer):
    """TPC-H Q13 (2.4.13): CUSTOMER left join ORDERS (the o_comment filter
    as a 1% flag), count(o_orderkey) per customer (the unmatched right side
    is NULL and not counted), the customers per count, sorted."""
    o = orders.filter(~orders["o_special"]).select("o_orderkey", "o_custkey").rename(
        {"o_custkey": "c_custkey"})
    co, ovf = customer.join(o, "c_custkey", capacity=T3_CAPACITY, how="left")
    per = co.aggregate("c_custkey", {"c_count": ("count", "o_orderkey")})
    dist = per.aggregate("c_count", {"custdist": "count"})
    return dist.sort_by(["custdist", "c_count"], descending=True), ovf


def check_t3(raw, out):
    got, ovf = out
    check(not bool(ovf), "T3: the join overflowed its capacity")
    n_c = raw["c_custkey"].shape[0]
    keep = ~raw["o_special"]
    per = torch.zeros(n_c + 1, dtype=torch.int64, device=DEV).index_add_(
        0, raw["o_custkey"][keep], torch.ones(int(keep.sum()), dtype=torch.int64, device=DEV))
    per = per[raw["c_custkey"]]  # one count per customer (keys 1..n_c)
    cc, dist = torch.unique(per, return_counts=True)
    order = torch.sort(cc, stable=True, descending=True).indices
    order = order[torch.sort(dist[order], stable=True, descending=True).indices]
    k = int(got.count)
    check(k == cc.shape[0], "T3 row count")
    check_exact(got["c_count"][:k], cc[order].to(torch.int32), "T3 c_count")
    check_exact(got["custdist"][:k], dist[order].to(torch.int32), "T3 custdist")
    return (f"{n_c:,} customers, {int(per.sum()):,} counted orders, {k} distinct counts; "
            "bit-exact")


T4_OPS = {"rn": "row_number", "rk": "rank", "pr": "percent_rank",
          "cs": ("cumsum", "o_totalprice"), "lg": ("lag", "o_totalprice", 1),
          "rs": ("rolling_sum", "o_totalprice", 2, 0), "rm": ("range_min", "o_totalprice", 30, 0)}


def t4_windows(orders):
    """T4: the seven window ops over ORDERS by customer and order date,
    then a running sum over all 15M rows as one partition."""
    o = orders.select("o_custkey", "o_orderdate", "o_totalprice")
    w = o.window(T4_OPS, partition_by="o_custkey", order_by="o_orderdate")
    return w.window({"all_cs": ("cumsum", "o_totalprice")}, order_by="o_orderdate")


def check_t4(raw, got):
    """The window oracle: a stable torch.sort by (custkey, date), run bounds
    by torch.searchsorted, exact sums as int64 cents; floats within the
    recursive-summation bound of their frame, the rest bit-exact."""
    key, date, x = raw["o_custkey"], raw["o_orderdate"], raw["o_totalprice"]
    n = key.shape[0]
    perm = torch.sort(date, stable=True).indices
    perm = perm[torch.sort(key[perm], stable=True).indices]
    ks, ds, xs = key[perm], date[perm], x[perm]
    comb = ks * (1 << 32) + ds.to(torch.int64)
    i = torch.arange(n, device=DEV)
    start = torch.searchsorted(ks, ks, side="left")
    end = torch.searchsorted(ks, ks, side="right") - 1
    peer = torch.searchsorted(comb, comb, side="left")
    cents = torch.round(xs * 100).to(torch.int64)
    csum = torch.cumsum(cents, 0)

    def back(r):  # sorted order -> input order
        out = torch.empty_like(r)
        out[perm] = r
        return out

    def float_ok(name, want_cents, n_terms, abs_sum):
        want = want_cents.to(torch.float64) / 100
        bound = (n_terms.to(torch.float64) - 1).clamp(min=0) * U64 * abs_sum \
            + 4 * U64 * abs_sum
        err = (got[name] - back(want)).abs()
        check(bool((err <= back(bound)).all()), f"T4 {name} above its bound")
        return float((err / back(bound).clamp(min=1e-300)).max())

    rn = i - start + 1
    check_exact(got["rn"], back(rn.to(torch.int32)), "T4 row_number")
    rank = peer - start + 1
    check_exact(got["rk"], back(rank.to(torch.int32)), "T4 rank")
    cnt = end - start + 1
    pr = torch.where(cnt > 1, (rank - 1).to(torch.float32)
                     / (cnt - 1).clamp(min=1).to(torch.float32), 0.0)
    check_exact(got["pr"], back(pr), "T4 percent_rank")
    prev = torch.where(start > 0, csum[(start - 1).clamp(min=0)], 0)
    shares = [float_ok("cs", csum - prev, rn, (csum - prev).to(torch.float64) / 100)]
    lag = torch.where(i > start, xs[(i - 1).clamp(min=0)], 0.0)
    check_exact(got["lg"], back(lag), "T4 lag")
    ws = torch.maximum(start, i - 2)
    before = torch.where(ws > 0, csum[(ws - 1).clamp(min=0)], 0)
    shares.append(float_ok("rs", csum - before, i - ws + 1,
                           (csum - before).to(torch.float64) / 100))
    lo = torch.searchsorted(comb, comb - 30, side="left")  # the frame [d - 30, d], peers
    hi = torch.searchsorted(comb, comb, side="right") - 1
    rm = xs[hi]
    for k in range(1, int((hi - lo).max()) + 1):  # brute force over the frame
        j = hi - k
        rm = torch.where(j >= lo, torch.minimum(rm, xs[j.clamp(min=0)]), rm)
    check_exact(got["rm"], back(rm), "T4 range_min")
    # one partition: the running sum in date order (ties in input order)
    pa = torch.sort(date, stable=True).indices
    ca = torch.cumsum(torch.round(x[pa] * 100).to(torch.int64), 0)
    want = torch.empty_like(ca)
    want[pa] = ca
    ra = torch.empty_like(i)
    ra[pa] = i + 1
    shares.append(float_ok("all_cs", want[perm], ra[perm], want[perm].to(torch.float64) / 100))
    return (f"{n:,} rows, {int((start == i).sum()):,} partitions; ranks, lag and range_min "
            f"bit-exact, sums within {max(shares):.2e} of their bound")


def t5_inputs(raw, gen):
    """T5's right sides: 1024 disjoint price tiers; two date windows of
    90-365 days per customer (overlapping at random), shuffled; 1M values
    to UNNEST with counts uniform in [0, 128]."""
    lo = T5_TIER_LO + T5_TIER_W * torch.arange(T5_TIERS, dtype=torch.float64, device=DEV)
    tiers = Table({"lo": lo, "hi": lo + T5_TIER_SPAN,
                   "tier": torch.arange(T5_TIERS, dtype=torch.int32, device=DEV)}, device=DEV)
    n_c = raw["c_custkey"].shape[0]
    cust = torch.arange(1, n_c + 1, device=DEV).repeat_interleave(2)
    start = torch.randint(STARTDATE, ENDDATE, (2 * n_c,), generator=gen, device=DEV)
    length = torch.randint(90, 366, (2 * n_c,), generator=gen, device=DEV)
    shuffle = torch.randperm(2 * n_c, generator=gen, device=DEV)
    windows = Table({"o_custkey": cust[shuffle], "w_lo": start[shuffle].to(torch.int32),
                     "w_hi": (start + length)[shuffle].to(torch.int32),
                     "wid": torch.arange(2 * n_c, dtype=torch.int32, device=DEV)}, device=DEV)
    values = Table({
        "v": torch.randint(-(1 << 31), 1 << 31, (U_VALUES,), dtype=torch.int32, generator=gen,
                           device=DEV),
        "n": torch.randint(0, 129, (U_VALUES,), dtype=torch.int32, generator=gen, device=DEV),
    }, device=DEV)
    return tiers, windows, values


def t5_tiers(orders, tiers):
    return orders.select("o_orderkey", "o_totalprice").join_band(
        tiers, "o_totalprice", "between", ("lo", "hi"), capacity=orders.num_rows)


def t5_windows(orders, windows):
    return orders.select("o_orderkey", "o_custkey", "o_orderdate").join_band(
        windows, "o_orderdate", "between", ("w_lo", "w_hi"), on="o_custkey",
        capacity=T5_CAPACITY)


def check_t5_tiers(raw, tiers, out):
    got, ovf = out
    x = raw["o_totalprice"]
    tier = torch.floor((x - T5_TIER_LO) / T5_TIER_W).to(torch.int64)
    lo = tiers["lo"][tier]
    tier = torch.where(x < lo, tier - 1, torch.where(x > lo + T5_TIER_SPAN, tier + 1, tier))
    check(bool(((x >= tiers["lo"][tier]) & (x <= tiers["hi"][tier])).all()),
          "T5 tiers oracle: a price outside its tier")
    n = x.shape[0]
    check(not bool(ovf) and int(got.count) == n, "T5 tiers: one match per order")
    check_exact(got["o_orderkey"][:n], raw["o_orderkey"], "T5 tiers o_orderkey")
    check_exact(got["tier"][:n], tier.to(torch.int32), "T5 tiers tier")
    return f"{n:,} orders, each in one of {T5_TIERS} tiers; bit-exact"


def check_t5_windows(raw, windows, out):
    """Pairs (order, window) with lo <= date <= hi of the order's customer,
    by order, then by (lo, input position) of the customer's windows."""
    got, ovf = out
    key, wlo, whi, wid = (windows[c] for c in ("o_custkey", "w_lo", "w_hi", "wid"))
    perm = torch.sort(wlo, stable=True).indices
    perm = perm[torch.sort(key[perm], stable=True).indices]  # by (custkey, lo, position)
    ks = key[perm]
    first = torch.searchsorted(ks, raw["o_custkey"])
    d = raw["o_orderdate"]
    hits = []
    for j in (0, 1):  # the customer's two windows in band order
        w = perm[first + j]
        hits.append((d >= wlo[w]) & (d <= whi[w]))
    m = torch.stack(hits, 1)  # (orders, 2)
    rows = torch.nonzero(m)  # row-major: by order, then band order
    want_wid = wid[perm[first[rows[:, 0]] + rows[:, 1]]]
    k = int(got.count)
    check(not bool(ovf) and k == rows.shape[0], f"T5 windows: {k} rows, want {rows.shape[0]}")
    check_exact(got["o_orderkey"][:k], _bits(raw["o_orderkey"])[rows[:, 0]].view(torch.uint32),
                "T5 windows o_orderkey")  # gathered as the signed view
    check_exact(got["wid"][:k], want_wid, "T5 windows wid")
    both = int(m.all(1).sum())
    return f"{k:,} pairs, {both:,} orders in both windows; bit-exact"


def check_t5_unnest(values, out):
    got, ovf = out
    want = torch.repeat_interleave(values["v"], values["n"])
    k = int(got.count)
    check(not bool(ovf) and k == want.shape[0], "T5 UNNEST count")
    check_exact(got["v"][:k], want, "T5 UNNEST values")
    check_exact(got["n"][:k], torch.repeat_interleave(values["n"], values["n"]), "T5 UNNEST n")
    return f"{U_VALUES:,} rows -> {k:,}; bit-exact"


def table_path(gen):
    """T1-T5: the relational facade at TPC-H SF10 on the card, each workload
    checked once against its torch oracle with its K2 launches counted.
    Returns the workloads (label -> (call, rows in)) for timing."""
    raw = tpch_sf10(gen)
    li, orders, customer = facade_tables(raw, gen)
    raw["o_special"] = orders["o_special"]
    tiers, windows, values = t5_inputs(raw, gen)
    log(f"Table facade at SF10 on the card: {li.num_rows:,} lineitems, {orders.num_rows:,} "
        f"orders, {customer.num_rows:,} customers")
    work = {
        "T1 Q1: filter, with_columns, aggregate by 2 string keys, sort_by":
            (lambda: t1_q1(li), lambda g: check_t1(raw, g), 0, li.num_rows),
        "T2 Q3: CUSTOMER ('BUILDING') join ORDERS join LINEITEM, aggregate, top_k(10)":
            (lambda: t2_q3(li, orders, customer),
             lambda g: check_t2(raw, li, orders, customer, g), 2,
             li.num_rows + orders.num_rows + customer.num_rows),
        "T3 Q13: CUSTOMER left join ORDERS, count(o_orderkey), aggregate, sort_by":
            (lambda: t3_q13(orders, customer), lambda g: check_t3(raw, g), 1,
             orders.num_rows + customer.num_rows),
        "T4 7 window ops over ORDERS by o_custkey, o_orderdate; cumsum in one partition":
            (lambda: t4_windows(orders), lambda g: check_t4(raw, g), 0, orders.num_rows),
        "T5a ORDERS join_band 1024 disjoint price tiers (one candidate a row)":
            (lambda: t5_tiers(orders, tiers), lambda g: check_t5_tiers(raw, tiers, g), 0,
             orders.num_rows),
        "T5b ORDERS join_band 2 date windows per customer on o_custkey (candidates > 1)":
            (lambda: t5_windows(orders, windows), lambda g: check_t5_windows(raw, windows, g),
             1, orders.num_rows + windows.num_rows),
        "T5c Table.unnest of 1M rows, counts in [0, 128]":
            (lambda: values.unnest("n", U_CAPACITY), lambda g: check_t5_unnest(values, g), 1,
             U_VALUES),
    }
    for label, (call, verify, k2_calls, _) in work.items():
        before = expand.LAUNCHES
        got = call()
        sync_table(got)
        calls = expand.LAUNCHES - before
        check(calls == k2_calls, f"{label}: {calls} K2 launches, expected {k2_calls}")
        log(f"{label.split(':')[0].split()[0]}: matches the torch oracle, K2 launches {calls}; "
            f"{verify(got)}")
        del got
    return ({label: (call, rows_in) for label, (call, _, _, rows_in) in work.items()},
            {label.split()[0]: (call, k2) for label, (call, _, k2, _) in work.items() if k2})


def sync_table(out):
    t = out[0] if isinstance(out, tuple) else out
    timing.sync(list(t._cols.values()))


# ---------------------------------------------------------------- phase 10

# TPC-H Q1, Q3, Q13 and Q18 (2.4.1, 2.4.3, 2.4.13, 2.4.18) as SQL text over
# phase 9's tables, with their substitution parameters. The planner's
# namespace is flat and an equi-join renames the right key onto the left's
# name, so Q3 groups by o_orderkey (equal to l_orderkey after the join).
S_QUERIES = {
    "S1": ("Q1", "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
           "SUM(l_extendedprice) AS sum_base_price, "
           "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
           "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
           "AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price, "
           "AVG(l_discount) AS avg_disc, COUNT(*) AS count_order FROM lineitem "
           "WHERE l_shipdate <= DATE '1998-09-02' GROUP BY l_returnflag, l_linestatus "
           "ORDER BY l_returnflag, l_linestatus", {}),
    "S2": ("Q3", "SELECT o_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
           "o_orderdate, o_shippriority FROM customer "
           "JOIN orders ON c_custkey = o_custkey JOIN lineitem ON o_orderkey = l_orderkey "
           "WHERE c_mktsegment = 'BUILDING' AND o_orderdate < DATE '1995-03-15' "
           "AND l_shipdate > DATE '1995-03-15' "
           "GROUP BY o_orderkey, o_orderdate, o_shippriority "
           "ORDER BY revenue DESC, o_orderdate LIMIT 10", {"capacity": 1 << 26}),
    "S3": ("Q13", "SELECT c_count, COUNT(*) AS custdist FROM "
           "(SELECT c_custkey, COUNT(o_orderkey) AS c_count FROM customer "
           "LEFT OUTER JOIN (SELECT o_orderkey, o_custkey FROM orders WHERE NOT o_special) o "
           "ON c_custkey = o_custkey GROUP BY c_custkey) AS c_orders "
           "GROUP BY c_count ORDER BY custdist DESC, c_count DESC", {"capacity": T3_CAPACITY}),
    "S4": ("Q18", "SELECT c_custkey, o_orderkey, o_orderdate, o_totalprice, "
           "SUM(l_quantity) AS sum_qty FROM customer "
           "JOIN orders ON c_custkey = o_custkey JOIN lineitem ON o_orderkey = l_orderkey "
           "WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey "
           "HAVING SUM(l_quantity) > 300) "
           "GROUP BY c_custkey, o_orderkey, o_orderdate, o_totalprice "
           "ORDER BY o_totalprice DESC, o_orderdate LIMIT 100", {"capacity": 1 << 26}),
}
S_FLOATS = {"S1": ("sum_base_price", "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
                   "avg_disc"),
            "S2": ("revenue",), "S3": (), "S4": ()}


def check_s4(raw, got):
    """Q18 against phase 8's oracle: sum(l_quantity) per order by
    torch.unique + index_add_, the orders above 300 with their customer,
    date and price, ordered as the query's stable sort leaves them (by
    price desc, then date, then the group keys (c_custkey, o_orderkey))."""
    lk = _rank(raw["l_orderkey"])
    uk, inv = torch.unique(lk, return_inverse=True)
    sums = torch.zeros_like(uk).index_add_(0, inv, raw["l_quantity"].to(torch.int64))
    keep = sums > 300
    kk, ks = uk[keep], sums[keep]
    o_sorted, o_idx = torch.sort(_rank(raw["o_orderkey"]))
    at = torch.searchsorted(o_sorted, kk)
    check(torch.equal(o_sorted[at], kk), "S4: every key an order")
    pos = o_idx[at]
    tp, od, ck = raw["o_totalprice"][pos], raw["o_orderdate"][pos], raw["o_custkey"][pos]
    perm = torch.sort(ck, stable=True).indices  # kk ascending: ties by (custkey, orderkey)
    perm = perm[torch.sort(od[perm], stable=True).indices]
    perm = perm[torch.sort(tp[perm], stable=True, descending=True).indices][:100]
    k = int(got.count)
    check(k == min(100, kk.shape[0]), "S4 row count")
    check_exact(got["o_totalprice"][:k], tp[perm], "S4 o_totalprice")
    check_exact(got["o_orderdate"][:k], od[perm], "S4 o_orderdate")
    check_exact(got["o_orderkey"][:k], kk[perm].to(torch.int32).view(torch.uint32),
                "S4 o_orderkey")
    check_exact(got["c_custkey"][:k], ck[perm], "S4 c_custkey")
    check_exact(got["sum_qty"][:k], ks[perm].to(torch.int32), "S4 sum_qty")
    return f"{kk.shape[0]:,} orders above 300 of {uk.shape[0]:,}; top {k} bit-exact"


def _s_check(name, raw, li, orders, customer, got, ovf):
    check(not bool(ovf), f"{name}: a join overflowed its capacity")
    if name == "S1":
        return check_t1(raw, got)
    if name == "S2":
        return check_t2(raw, li, orders, customer,
                        (got.rename({"o_orderkey": "l_orderkey"}), (ovf,)))
    if name == "S3":
        return check_t3(raw, (got, ovf))
    return check_s4(raw, got)


def same_result(name, a, b):
    """The optimized and the unoptimized plan's results: the same columns,
    row count and, but for the float sums (each already held to its bound
    by the oracle), the same bits."""
    check(a.column_names == b.column_names, f"{name}: optimized columns {a.column_names} "
          f"!= unoptimized {b.column_names}")
    k = int(a.count) if a.count is not None else a.num_rows
    kb = int(b.count) if b.count is not None else b.num_rows
    check(k == kb, f"{name}: optimized {k} rows != unoptimized {kb}")
    for c in a.column_names:
        if c not in S_FLOATS[name]:
            check_exact(a[c][:k], b[c][:k], f"{name} {c}: optimized vs unoptimized plan")


def sql_path(gen):
    """S1-S4: TPC-H Q1, Q3, Q13 and Q18 as SQL text through ``rst.sql(text,
    tables).collect()`` over the phase-9 Tables at SF10, each checked against
    its torch oracle, its unoptimized plan against its optimized one, with
    its K2 and run-ends launches counted. Returns the workloads (label ->
    (call, rows in)) for timing and those with expansions (name -> (call, K2
    calls))."""
    raw = tpch_sf10(gen)
    li, orders, customer = facade_tables(raw, gen)
    raw["o_special"] = orders["o_special"]
    tables = {"lineitem": li, "orders": orders, "customer": customer}
    rows_in = {"S1": li.num_rows, "S2": li.num_rows + orders.num_rows + customer.num_rows,
               "S3": orders.num_rows + customer.num_rows,
               "S4": 2 * li.num_rows + orders.num_rows + customer.num_rows}
    log(f"SQL at SF10 on the card: {li.num_rows:,} lineitems, {orders.num_rows:,} orders, "
        f"{customer.num_rows:,} customers")
    work, k2 = {}, {}
    for name, (q, text, kw) in S_QUERIES.items():
        plan = rst.sql(text, tables, **kw)
        plan_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            rst.sql(text, tables, **kw).optimized()
            plan_ms.append(1e3 * (time.perf_counter() - t0))
        log(f"{name} TPC-H {q}: {text}")
        log(f"{name} optimized plan (host planning, parse and optimize: median "
            f"{median(plan_ms):.3f} ms of 5):\n" + plan.explain())
        before, re_before = expand.LAUNCHES, run_ends.LAUNCHES
        got, ovf = plan.collect(return_overflow=True)
        sync_table(got)
        calls, re_calls = expand.LAUNCHES - before, run_ends.LAUNCHES - re_before
        log(f"{name}: matches the torch oracle, K2 launches {calls}, run-ends launches "
            f"{re_calls}; {_s_check(name, raw, li, orders, customer, got, ovf)}")
        unopt, uovf = plan.collect(optimize_plan=False, return_overflow=True)
        _s_check(name, raw, li, orders, customer, unopt, uovf)
        same_result(name, got, unopt)
        log(f"{name}: the unoptimized plan matches the oracle and the optimized plan")
        del got, unopt

        def call(text=text, kw=kw):
            return rst.sql(text, tables, **kw).collect()

        work[f"{name} TPC-H {q} as SQL"] = (call, rows_in[name])
        if calls:
            k2[name] = (call, calls)
    return work, k2


# ---------------------------------------------------------------- phase 11

# The distributed layer on one card: a mesh of D_SHARDS slots on cuda:0
# (one card cannot host several NCCL ranks, so the slots share one process
# and the exchange is device-local copies).
D_SHARDS = 4
D1_ROWS = MAIN_ROWS[1]  # 250M uniform (u64, u64) rows, 4.0 GB
D_SMALL = MAIN_ROWS[0]  # 31.25M rows: the other exchanges, 8 slots, skew
D3_CAPACITY = (1 << 25, 1 << 23)  # per slot: J1 ~15M rows, J2 ~3.9M rows, 2x headroom
D3_SKEW_ROWS = 1 << 20  # the forced skew fallback's sides
D3_SKEW_CAPACITY = 1 << 21  # per slot: the hot slot's ~4M rows overflow it
A1_GROUPS = 8  # Q1's 4 groups and the padding group, per slot
A2_GROUPS = 1 << 24  # per slot: ~9.4M of the 15M orders a slot, padding group included
D5_UNIQUE = 1 << 20  # per slot: ~1M distinct o_custkey in all
D5_TOP = 100
D5_QS = (0.0, 0.01, 0.25, 0.5, 0.75, 0.99, 1.0)
R_SLOT_CAPACITY = R_CAPACITY // D_SHARDS
# the workloads whose plan moves rows between slots: their profile must
# show the exchange's range (the aggregates, top_k, unique, filter, repeat
# and set operators exchange only partial results, by all-gather)
MUST_EXCHANGE = ("D1", "D2", "D3", "D5-quantiles")


def _pad_rows(x, fill):
    """``x`` padded to a multiple of D_SHARDS rows (the API asks callers to
    pad to equal blocks) with rows of bit pattern ``fill`` (integer
    dtypes; the padding is written through the signed view) or value
    ``fill`` (floats)."""
    extra = -x.shape[0] % D_SHARDS
    if not extra:
        return x
    if x.is_floating_point():
        return torch.cat([x, torch.full((extra,), fill, dtype=x.dtype, device=x.device)])
    b = _bits(x)
    nbits = 8 * x.element_size()
    fill &= (1 << nbits) - 1
    fill -= (1 << nbits) if fill >> (nbits - 1) else 0
    return torch.cat([b, torch.full((extra,), fill, dtype=b.dtype, device=x.device)]).view(x.dtype)


def _canonical(cols):
    """The rows of ``cols`` (equal-length tensors) as bit patterns, sorted
    lexicographically by every column (stable LSD passes of torch.sort):
    two joins' outputs agree as multisets iff these agree."""
    b = [_bits(c).to(torch.int64) for c in cols]
    perm = torch.arange(b[0].shape[0], device=b[0].device)
    for c in reversed(b):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return [c[perm] for c in b]


def _dist_rows(cols, counts):
    """The concatenated valid prefixes of sharded columns."""
    return [rdist.valid_rows(c, counts) for c in cols]


def _check_sorted_slots(k, v, counts, ref_k, ref_v, label):
    """Slot by slot: the valid prefix against the stable-sort oracle's
    rows, and the padding tail (all-ones keys, zero values)."""
    off = 0
    for s, c in enumerate(counts.tolist()):
        kb, vb = _bits(k.blocks[s]), _bits(v.blocks[s])
        check(torch.equal(kb[:c], _bits(ref_k[off:off + c]))
              and torch.equal(vb[:c], _bits(ref_v[off:off + c])), f"{label}: slot {s} rows")
        check(bool((kb[c:] == -1).all()) and bool((vb[c:] == 0).all()), f"{label}: slot {s} tail")
        off += c
    check(off == ref_k.shape[0], f"{label}: {off} valid rows of {ref_k.shape[0]}")


def _sort_oracle(keys, vals):
    """Stable torch.sort of u64 keys (their rank words) with the values,
    as int64 bit views (CUDA indexing has no unsigned kernels)."""
    perm = torch.sort(keys.view(torch.int64) ^ (-(1 << 63)), stable=True).indices
    return _bits(keys)[perm], _bits(vals)[perm]


def _time_run_starts(ks, mesh):
    """D1's one-word run starts (each slot's rows below each composite
    splitter): the searchsorted route of ``_below_starts`` against the
    reference's compare-sum ``_below_counts`` on the same sorted slots,
    equal counts required, both timed (CUDA events, median of 5)."""
    n_local = ks.block_rows
    s_words = [[torch.sort(b.view(torch.int64) ^ (-(1 << 63)), stable=True).values]
               for b in ks.blocks]
    sws, sp = rdsort._composite_splitters(mesh, s_words)
    sp = sp.to(torch.int64)

    def starts(fn):
        return [fn(w, r * n_local, sws, sp) for w, r in zip(s_words, mesh.local)]

    def searchsorted():
        return starts(rdsort._below_starts)

    def compare_sum():
        return starts(rdsort._below_counts)

    check(all(torch.equal(a[1:], b) for a, b in zip(searchsorted(), compare_sum())),
          "D1 run starts: searchsorted and compare-sum disagree")
    ms = {f.__name__: median(timing.cuda_time_ms(f, runs=5)) for f in (searchsorted, compare_sum)}
    log(f"D1 run starts of {len(s_words)} slots x {n_local:,} rows, {mesh.size - 1} splitters: "
        f"searchsorted {ms['searchsorted']:.3f} ms, compare-sum {ms['compare_sum']:.3f} ms "
        f"(equal counts)")


def d_sort(gen, mesh, mesh8):
    """D1 and D2: the distributed sort on uniform, step-uniform and
    all-equal keys, 4 and 8 slots and the forced fallback, each bit-exact
    against a stable torch.sort. Returns the workloads."""
    work = {}
    keys = dist.key_uniform(gen, D1_ROWS, torch.uint64)
    vals = dist.key_uniform(gen, D1_ROWS, torch.uint64)
    cap = rdsort.exchange_capacity(D1_ROWS // D_SHARDS, D_SHARDS)
    ks, vs = rdist.shard_rows(mesh, keys, vals)
    k, v, counts, ovf = rdsort.distributed_sort_pairs(ks, vs, mesh)
    torch.cuda.synchronize()
    ref_k, ref_v = _sort_oracle(keys, vals)
    check(not bool(ovf), "D1: overflow")
    check(int(counts.max()) <= cap, f"D1: a slot holds {int(counts.max())} rows > {cap}")
    _check_sorted_slots(k, v, counts, ref_k, ref_v, "D1")
    log(f"D1: {D1_ROWS:,} (u64, u64) rows on {D_SHARDS} slots bit-exact vs stable torch.sort; "
        f"overflow False; counts {counts.tolist()} (bound {cap:,})")
    del k, v, ref_k, ref_v
    _time_run_starts(ks, mesh)
    work["D1 distributed_sort_pairs 250M uniform (u64, u64), 4 slots"] = (
        lambda: rdsort.distributed_sort_pairs(ks, vs, mesh),
        lambda: _sort_oracle(keys, vals), D1_ROWS)

    n = D_SMALL
    small_k, small_v = keys[:n].clone(), vals[:n].clone()
    ref_k, ref_v = _sort_oracle(small_k, small_v)
    sk8, sv8 = rdist.shard_rows(mesh8, small_k, small_v)

    def call():
        return rdsort.distributed_sort_pairs(sk8, sv8, mesh8)

    k, v, counts, ovf = call()
    check(not bool(ovf), "D1 8 slots: overflow")
    check(int(counts.max()) <= rdsort.exchange_capacity(n // mesh8.size, mesh8.size),
          "D1 8 slots: count above the bound")
    _check_sorted_slots(k, v, counts, ref_k, ref_v, "D1 8 slots")
    log(f"D1 8 slots: {n:,} rows bit-exact, counts {counts.tolist()}")
    del k, v
    work["D1-8slots distributed_sort_pairs 31.25M, 8 slots"] = (
        call, lambda: _sort_oracle(small_k, small_v), n)
    del ref_k, ref_v

    for name, x in (("step_uniform", dist.step_uniform(gen, n, 16, torch.uint64)),
                    ("all_equal", torch.full((n,), 0x0123456789ABCDEF, dtype=torch.int64,
                                             device=DEV).view(torch.uint64))):
        xs, svs = rdist.shard_rows(mesh, x, small_v)
        ref_k, ref_v = _sort_oracle(x, small_v)
        k, v, counts, ovf = rdsort.distributed_sort_pairs(xs, svs, mesh)
        check(not bool(ovf), f"D2 {name}: overflow")
        check(int(counts.max()) <= rdsort.exchange_capacity(n // D_SHARDS, D_SHARDS),
              f"D2 {name}: a count above the bound")
        _check_sorted_slots(k, v, counts, ref_k, ref_v, f"D2 {name}")
        forced = rdsort.distributed_sort_pairs(xs, svs, mesh, capacity=n // D_SHARDS)
        check(bool(forced[3]), f"D2 {name}: capacity=n_local did not overflow")
        _check_sorted_slots(*forced[:3], ref_k, ref_v, f"D2 {name} fallback")
        log(f"D2 {name}: {n:,} rows bit-exact, counts {counts.tolist()} within the bound; "
            f"capacity=n_local overflows and the fallback is exact")
        del k, v, forced, ref_k, ref_v
        work[f"D2-{name} distributed_sort_pairs 31.25M {name}, 4 slots"] = (
            lambda xs=xs, svs=svs: rdsort.distributed_sort_pairs(xs, svs, mesh),
            lambda x=x: _sort_oracle(x, small_v), n)
    return work


def d_join(t, gen, mesh):
    """D3: J1 and J2 as distributed joins at SF10 (K2 once per slot), held
    against the single-device ``rst.hash_join`` as multisets of rows; a
    forced skew fallback at 2**20 rows. Returns (workloads, K2 shapes, K2
    launches and run-ends launches of the distributed calls)."""
    lk, lv = t["o_orderkey"], t["o_custkey32"]
    rk = _pad_rows(t["l_orderkey"], 0xFFFFFFFF)  # no order has that key
    rv = _pad_rows(t["l_extendedprice"], 0.0)
    j1 = [rdist.shard_rows(mesh, x) for x in (lk, lv, rk, rv)]
    j2 = [rdist.shard_rows(mesh, t[k]) for k in ("c_custkey", "c_acctbal", "o_custkey",
                                                  "o_totalprice")]
    hot_l = torch.randint(0, D3_SKEW_ROWS, (D3_SKEW_ROWS,), generator=gen, device=DEV)
    hot_l[:D3_SKEW_ROWS // 4] = 7
    hot_r = torch.randint(0, D3_SKEW_ROWS, (D3_SKEW_ROWS,), generator=gen, device=DEV)
    hot_r[:16] = 7
    skew_v = torch.arange(D3_SKEW_ROWS, dtype=torch.int32, device=DEV)
    sk = [rdist.shard_rows(mesh, x) for x in (hot_l, skew_v, hot_r, skew_v)]
    work = {
        "D3-J1 ORDERS inner join LINEITEM, 4 slots": (
            lambda: rdq.distributed_hash_join(*j1, mesh, capacity_per_shard=D3_CAPACITY[0]),
            lambda: rst.hash_join(t["o_orderkey"], t["o_custkey32"], t["l_orderkey"],
                                  t["l_extendedprice"], capacity=J1_CAPACITY),
            D_SHARDS, lk.shape[0] + rk.shape[0]),
        "D3-J2 CUSTOMER left join ORDERS, 4 slots": (
            lambda: rdq.distributed_hash_join(*j2, mesh, capacity_per_shard=D3_CAPACITY[1],
                                              how="left"),
            lambda: rst.hash_join(t["c_custkey"], t["c_acctbal"], t["o_custkey"],
                                  t["o_totalprice"], capacity=J2_CAPACITY, how="left"),
            D_SHARDS, t["c_custkey"].shape[0] + t["o_custkey"].shape[0]),
        "D3-skew 2**20 x 2**20 join, a key on 1/4 of the left rows: exact fallback": (
            lambda: rdq.distributed_hash_join(*sk, mesh, capacity_per_shard=D3_SKEW_CAPACITY),
            lambda: rst.hash_join(hot_l, skew_v, hot_r, skew_v,
                                  capacity=D_SHARDS * D3_SKEW_CAPACITY),
            None, 2 * D3_SKEW_ROWS),
    }
    launches = re_launches = 0
    for label, (call, single, k2, _) in work.items():
        before, re_before = expand.LAUNCHES, run_ends.LAUNCHES
        jk, jlv, jrv, counts, ovf = call()
        torch.cuda.synchronize()
        calls, re_calls = expand.LAUNCHES - before, run_ends.LAUNCHES - re_before
        launches, re_launches = launches + calls, re_launches + re_calls
        if k2 is not None:
            check(calls == k2, f"{label}: {calls} K2 launches, expected {k2}")
        wk, wlv, wrv, wc, wo = single()
        check(not bool(ovf) and not bool(wo), f"{label}: overflow")
        wc = int(wc)
        got = _canonical(_dist_rows([jk, jlv, jrv], counts))
        want = _canonical([wk[:wc], wlv[:wc], wrv[:wc]])
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{label}: rows differ from the single-device join")
        log(f"{label.split()[0]}: {wc:,} rows, the single-device join's multiset; per-slot "
            f"counts {counts.tolist()}; K2 launches {calls}, run-ends launches {re_calls}")
        del jk, jlv, jrv, got, want, wk, wlv, wrv
    return ({label: (call, single, rows) for label, (call, single, _, rows) in work.items()},
            {"D3-J1": (work["D3-J1 ORDERS inner join LINEITEM, 4 slots"][0], D_SHARDS),
             "D3-J2": (work["D3-J2 CUSTOMER left join ORDERS, 4 slots"][0], D_SHARDS)},
            launches, re_launches)


def d_aggregate(t, mesh):
    """D4: A1 (Q1's multi-aggregate) and A2 (sum(l_quantity) by l_orderkey,
    15M groups) as distributed aggregates at SF10, held against phase 8's
    oracles. Q1's filtered rows and LINEITEM pad to 4 equal blocks with
    rows of a group that sorts last, and that group is checked too."""
    rf, ls, qty, price, disc, _, disc_price, charge = q1_inputs(t)
    a1_cols = [_pad_rows(rf, 0xFF), _pad_rows(ls, 0xFF)]
    a1_vals = [_pad_rows(x, 0) for x in (qty, price, disc_price, charge, qty, price, disc, qty)]
    pad1 = a1_cols[0].shape[0] - rf.shape[0]
    a1 = [rdist.shard_rows(mesh, x) for x in a1_cols + a1_vals]
    l_key = _pad_rows(t["l_orderkey"], 0xFFFFFFFF)
    pad2 = l_key.shape[0] - t["l_orderkey"].shape[0]
    a2 = rdist.shard_rows(mesh, l_key, _pad_rows(t["l_quantity"], 0))
    work = {
        "D4-A1 Q1 multi-aggregate by (returnflag, linestatus), 4 slots": (
            lambda: rdq.distributed_hash_aggregate(a1[:2], a1[2:], mesh, Q1_AGGS,
                                                   max_groups=A1_GROUPS),
            lambda: q1(t), t["l_orderkey"].shape[0]),
        "D4-A2 sum(l_quantity) by l_orderkey (15M groups), 4 slots": (
            lambda: rdq.distributed_hash_aggregate(a2[0], a2[1], mesh, "sum",
                                                   max_groups=A2_GROUPS),
            lambda: rst.hash_aggregate(t["l_orderkey"], t["l_quantity"], "sum"),
            t["l_orderkey"].shape[0]),
    }
    (g_rf, g_ls), aggs, count, ovf = work[next(iter(work))][0]()
    g = int(count) - (1 if pad1 else 0)
    check(not bool(ovf), "D4-A1: overflow")
    if pad1:
        check(int(g_rf[g]) == 0xFF and int(g_ls[g]) == 0xFF and int(aggs[7][g]) == pad1,
              "D4-A1: the padding group")
    log(f"D4-A1: matches phase 8's Q1 oracle; {check_q1(t, ((g_rf, g_ls), aggs, torch.tensor(g)))}"
        f" (+ the padding group of {pad1} rows)")
    uk, sums, count, ovf = work["D4-A2 sum(l_quantity) by l_orderkey (15M groups), 4 slots"][0]()
    check(not bool(ovf), "D4-A2: overflow")
    lk = _rank(t["l_orderkey"])
    wk, inv = torch.unique(lk, return_inverse=True)
    ws = torch.zeros_like(wk).index_add_(0, inv, t["l_quantity"].to(torch.int64))
    g = wk.shape[0]
    check(int(count) == g + (1 if pad2 else 0), "D4-A2: group count")
    check(torch.equal(_rank(uk[:g]), wk) and torch.equal(sums[:g], ws.to(torch.int32)),
          "D4-A2: keys or sums")
    log(f"D4-A2: {g:,} groups, keys and int32 sums exact vs torch.unique + index_add_"
        f" (+ the padding group of {pad2} rows)")
    return {label: (call, single, rows) for label, (call, single, rows) in work.items()}


def d_operators(t, gen, mesh):
    """D5: top_k, unique, quantiles, filter, repeat (K2 once per slot) and
    the set operators on SF10 columns, each against a torch oracle.
    Returns (workloads, K2 shapes, K2 launches of the distributed calls)."""
    o = [rdist.shard_rows(mesh, t[k]) for k in ("o_totalprice", "o_orderdate", "o_orderkey",
                                                 "o_custkey")]
    neg_date = rdist.shard_rows(mesh, -t["o_orderdate"])
    price = _pad_rows(t["l_extendedprice"], 0.0)
    price_s = rdist.shard_rows(mesh, price)
    cust = rdist.shard_rows(mesh, t["c_custkey"])
    r_values = torch.randint(-(1 << 31), 1 << 31, (R_VALUES,), dtype=torch.int32,
                             generator=gen, device=DEV)
    r_counts = torch.randint(0, 129, (R_VALUES,), dtype=torch.int32, generator=gen, device=DEV)
    rv_s, rc_s = rdist.shard_rows(mesh, r_values, r_counts)
    date_cut = _days(1995, 1, 1)
    keep = rdist.shard_rows(mesh, t["o_orderdate"] < date_cut)
    work = {
        "D5-top_k top 100 orders by (o_totalprice desc, o_orderdate), 4 slots": (
            lambda: rdq.distributed_top_k([o[0], neg_date], D5_TOP, o[2], mesh=mesh),
            lambda: rst.top_k([t["o_totalprice"], -t["o_orderdate"]], D5_TOP, t["o_orderkey"]),
            t["o_orderkey"].shape[0]),
        "D5-unique distinct o_custkey with counts, 4 slots": (
            lambda: rdq.distributed_unique(o[3], mesh, max_unique=D5_UNIQUE),
            lambda: rst.unique(t["o_custkey"]), t["o_custkey"].shape[0]),
        "D5-quantiles 7 quantiles of l_extendedprice, 4 slots": (
            lambda: rdq.distributed_quantiles(price_s, D5_QS, mesh),
            lambda: rst.quantiles(price, D5_QS), price.shape[0]),
        "D5-filter ORDERS o_orderdate < 1995-01-01 (3 columns), 4 slots": (
            lambda: rdq.distributed_filter(keep, o[2], o[0], o[3], mesh=mesh),
            lambda: rst.filter(t["o_orderdate"] < date_cut, t["o_orderkey"], t["o_totalprice"],
                               t["o_custkey"]), t["o_orderkey"].shape[0]),
        "D5-R repeat of 1M i32 values, counts in [0, 128], 4 slots": (
            lambda: rdq.distributed_repeat(rv_s, rc_s, mesh,
                                           total_size_per_shard=R_SLOT_CAPACITY),
            lambda: rst.repeat(r_values, r_counts, total_size=R_CAPACITY), R_VALUES),
        "D5-sets o_custkey intersect / except / union c_custkey, 4 slots": (
            lambda: [f(o[3], cust, mesh, max_unique=D5_UNIQUE)
                     for f in (rdq.distributed_set_intersect, rdq.distributed_set_difference,
                               rdq.distributed_set_union)],
            lambda: [f(t["o_custkey"], t["c_custkey"])
                     for f in (rst.set_intersect, rst.set_difference, rst.set_union)],
            t["o_custkey"].shape[0] + t["c_custkey"].shape[0]),
    }
    # the oracles: stable torch.sort, torch.unique, a boolean mask,
    # torch.repeat_interleave and torch.isin
    (tp, nd), ok = work[next(iter(work))][0]()
    perm = torch.sort(t["o_orderdate"], stable=True).indices
    perm = perm[torch.sort(t["o_totalprice"][perm], stable=True, descending=True).indices][:D5_TOP]
    check(torch.equal(_bits(tp), _bits(t["o_totalprice"][perm]))
          and torch.equal(nd, -t["o_orderdate"][perm])
          and torch.equal(_bits(ok), _bits(t["o_orderkey"])[perm]), "D5 top_k")
    uk, cts, num, ovf = rdq.distributed_unique(o[3], mesh, max_unique=D5_UNIQUE)
    wk, wc = torch.unique(t["o_custkey"], return_counts=True)
    check(not bool(ovf) and int(num) == wk.shape[0] and torch.equal(uk[:wk.shape[0]], wk)
          and torch.equal(cts[:wk.shape[0]], wc.to(torch.int32)), "D5 unique")
    got = rdq.distributed_quantiles(price_s, D5_QS, mesh)
    srt = torch.sort(price).values
    idx = torch.tensor([int(q * (price.shape[0] - 1)) for q in D5_QS], device=DEV)
    check(torch.equal(_bits(got), _bits(srt[idx])), "D5 quantiles")
    *cols, counts = rdq.distributed_filter(keep, o[2], o[0], o[3], mesh=mesh)
    m = t["o_orderdate"] < date_cut
    check(all(torch.equal(_bits(g), _bits(t[k])[m]) for g, k in zip(
        _dist_rows(cols, counts), ("o_orderkey", "o_totalprice", "o_custkey"))), "D5 filter")
    before = expand.LAUNCHES
    out, r_cnt, r_ovf = rdq.distributed_repeat(rv_s, rc_s, mesh,
                                               total_size_per_shard=R_SLOT_CAPACITY)
    torch.cuda.synchronize()
    k2_r = expand.LAUNCHES - before
    check(k2_r == D_SHARDS, f"D5 repeat: {k2_r} K2 launches, expected {D_SHARDS}")
    check(not bool(r_ovf) and torch.equal(
        rdist.valid_rows(out, r_cnt), torch.repeat_interleave(r_values, r_counts)), "D5 repeat")
    inter, diff, union = work["D5-sets o_custkey intersect / except / union c_custkey, 4 slots"][0]()
    ou, cu = torch.unique(t["o_custkey"]), torch.unique(t["c_custkey"])
    for (keys_, cnt_, ovf_), want, name in (
            (inter, ou[torch.isin(ou, cu)], "intersect"), (diff, ou[~torch.isin(ou, cu)], "except"),
            (union, torch.unique(torch.cat([ou, cu])), "union")):
        check(not bool(ovf_) and int(cnt_) == want.shape[0]
              and torch.equal(keys_[:want.shape[0]], want), f"D5 {name}")
    log(f"D5: top_k, unique ({wk.shape[0]:,} keys), quantiles, filter ({int(m.sum()):,} rows), "
        f"repeat ({int(r_cnt.sum()):,} rows, K2 launches {k2_r}) and intersect / except / "
        f"union ({int(inter[1]):,} / {int(diff[1]):,} / {int(union[1]):,}) match their torch "
        f"oracles")
    return ({label: (call, single, rows) for label, (call, single, rows) in work.items()},
            {"D5-R": (work["D5-R repeat of 1M i32 values, counts in [0, 128], 4 slots"][0],
                      D_SHARDS)}, k2_r)


def _range_device_us(prof, key):
    """Device time torch.profiler attributes to the CPU range ``key``
    (the kernels launched inside it); None when the range never ran."""
    for e in prof.key_averages():
        if e.key == key and getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            return us if us is not None else getattr(e, "cuda_time_total", 0.0)
    return None


def _share(what, us, busy):
    if us is None:
        return f"no {what} in this plan"
    if not (busy and us):
        return f"the {what}'s share not measured"
    return f"the {what} {us / 1e3:.3f} ms = {100 * us / busy:.1f}%"


def time_dist(work, must_exchange=MUST_EXCHANGE):
    """Each D workload: wall time (CUDA events, median of 5), device busy
    and idle time and the exchange's and the all-gathers' shares of the busy
    time (torch.profiler), peak memory above the inputs and K2 launches,
    with its single-device counterpart's wall time and peak beside it. The
    workloads named in ``must_exchange`` fail without an exchange range."""
    out = {}
    for label, (call, single, rows_in) in work.items():
        name = label.split()[0]
        row = {}
        for side, fn in (("dist", call), ("single", single)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = expand.LAUNCHES
            res = fn()
            torch.cuda.synchronize()
            row[f"{side}_k2"] = expand.LAUNCHES - before
            row[f"{side}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            del res
            row[f"{side}_ms"] = median(timing.cuda_time_ms(fn, runs=5))
        fn = call
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = []
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            if e.key in (rcoll.EXCHANGE_RANGE, rcoll.GATHER_RANGE):
                continue  # a range's own device-side annotation, not a kernel
            us = getattr(e, "self_device_time_total", None)
            kernels.append((us if us is not None else getattr(e, "self_cuda_time_total", 0.0),
                            e.key))
        kernels.sort(reverse=True)
        busy = sum(us for us, _ in kernels)
        exch = _range_device_us(prof, rcoll.EXCHANGE_RANGE)
        gath = _range_device_us(prof, rcoll.GATHER_RANGE)
        if name.startswith(must_exchange):
            check(exch is not None, f"{name}: the profile shows no exchange range")
        row.update(busy_ms=busy / 1e3, exchange_ms=exch and exch / 1e3,
                   all_gather_ms=gath and gath / 1e3)
        out[name] = row
        share = f"{_share('exchange', exch, busy)}, {_share('all-gather', gath, busy)}"
        log(f"{name}: median {row['dist_ms']:.3f} ms ({rows_in / row['dist_ms'] / 1e3:.1f} M "
            f"input rows/s); device busy "
            + (f"{busy / 1e3:.3f} ms in {len(kernels)} kernels, idle "
               f"{row['dist_ms'] - busy / 1e3:.3f} ms ({100 * (1 - busy / 1e3 / row['dist_ms']):.1f}%"
               f" of the wall time); {share}" if busy else
               "not measured (the profiler showed no device time)")
            + f"; peak {row['dist_peak_gib']:.2f} GiB above the inputs; K2 launches "
            f"{row['dist_k2']}; single device: median {row['single_ms']:.3f} ms, peak "
            f"{row['single_peak_gib']:.2f} GiB, K2 launches {row['single_k2']}")
        if busy:
            log(f"{name} top device costs: " + "; ".join(
                f"{k[:60]} {us / 1e3:.3f} ms ({100 * us / busy:.1f}%)"
                for us, k in kernels[:5]))
    return out


def distributed_path(gen):
    """Phase 11: D1-D5 on a 4-slot mesh on cuda:0, each checked against its
    oracle, then timed. Returns (the K2 shapes it recorded, K2 launches of
    the checked distributed calls, the joins (name -> call), whose unions
    are the only ones of the path, their run-ends launches, and the
    segmented-sum kernel's launches of the checked D3-D5 calls)."""
    mesh = rdist.data_mesh(D_SHARDS, device=DEV)
    mesh8 = rdist.data_mesh(2 * D_SHARDS, device=DEV)
    log(f"mesh: {mesh}")
    work = d_sort(gen, mesh, mesh8)
    time_dist(work)
    del work
    torch.cuda.empty_cache()
    t = tpch_sf10(gen)
    log(f"TPC-H SF10 for the distributed path: {t['o_orderkey'].shape[0]:,} orders, "
        f"{t['l_orderkey'].shape[0]:,} lineitems, {t['c_custkey'].shape[0]:,} customers")
    ss_before = segment_sum.LAUNCHES
    join_work, k2_join, join_launches, re_launches = d_join(t, gen, mesh)
    agg_work = d_aggregate(t, mesh)
    op_work, k2_ops, op_launches = d_operators(t, gen, mesh)
    ss_launches = segment_sum.LAUNCHES - ss_before
    time_dist({**join_work, **agg_work, **op_work})
    joins = {label.split()[0]: call for label, (call, *_) in join_work.items()}
    return ({**k2_join, **k2_ops}, join_launches + op_launches, joins, re_launches,
            ss_launches)


MR_ROWS = D1_ROWS  # a card's rows in the 4-card sort cell
MR_RUNS = (61_000_000, 64_500_000, 62_000_000)  # and the rest: 4 runs of unequal size


def _zipf_runs(gen, lengths):
    """Runs back to back, each sorted: int64 keys with P(k >= x) = x**-0.1
    (1, 2, 3, ...: long runs of equal keys in every run)."""
    u = torch.rand(sum(lengths), device=DEV, generator=gen, dtype=torch.float64)
    keys = u.clamp_(min=1e-300).pow_(-10.0).clamp_(max=2.0**62).to(torch.int64)
    del u
    at = 0
    for n in lengths:
        keys[at:at + n] = torch.sort(keys[at:at + n]).values
        at += n
    return keys


def merge_at_cell_size(gen):
    """The merge kernel at a card's final step in the 4-card sort cell:
    MR_ROWS (int64 key, int64 payload) rows in 4 Zipf-like runs, bit-exact
    against its plain version into outputs poisoned with 0x5A5A5A5A (rows
    past the runs must stay so), then timed beside its bound (each operand
    read and written once), the plain version and a stable torch.sort of
    the concatenation with the payload gathered by its indices."""
    lengths = list(MR_RUNS) + [MR_ROWS - sum(MR_RUNS)]
    word = _zipf_runs(gen, lengths)
    vals = torch.randint(-2**62, 2**62, (MR_ROWS,), device=DEV, generator=gen)
    cols = [word, vals]
    outs = [torch.full((MR_ROWS + 2,), POISON, dtype=torch.int32, device=DEV)
            .repeat_interleave(2).view(torch.int64) for _ in cols]
    before = merge_runs.LAUNCHES
    merge_runs.launch(word, lengths, cols, outs)
    torch.cuda.synchronize()
    check(merge_runs.LAUNCHES == before + 1, "merge at the cell size: not one launch")
    ref = merge_runs.merge_runs_plain(word, lengths, cols, [0, 0], MR_ROWS)
    for o, r, what in zip(outs, ref, ("keys", "payload")):
        check(torch.equal(o[:MR_ROWS], r), f"merge at the cell size: {what} differ from plain")
        check(bool((o[MR_ROWS:].view(torch.int32) == POISON).all()),
              f"merge at the cell size: {what} written past the runs")
    del ref

    def library():
        srt = torch.sort(word, stable=True)
        return srt.values, vals[srt.indices]

    mk, mp, ml = interleaved_ms(lambda: merge_runs.launch(word, lengths, cols, outs),
                                lambda: merge_runs.merge_runs_plain(word, lengths, cols, [0, 0],
                                                                    MR_ROWS),
                                library)
    nbytes = 32 * MR_ROWS
    bound = nbytes / HBM_BYTES_PER_MS
    log(f"merge at the cell size: {MR_ROWS:,} (int64, int64) rows in runs of {lengths}: kernel "
        f"{mk:.3f} ms ({nbytes / mk / 1e6:.0f} GB/s), bound {bound:.3f} ms ({100 * bound / mk:.0f}%"
        f" of it), plain {mp:.3f} ms, stable torch.sort + gather {ml:.3f} ms; bit-exact")
    return {"shape": f"{MR_ROWS:,} (int64, int64) rows in 4 runs {lengths}", "rows": MR_ROWS,
            "ms": mk, "plain_ms": mp, "bound_ms": bound, "library_ms": ml}


def merges_of(path, run):
    """Run ``run()`` with the merge kernel's launches and the distributed
    sort's merged final steps counted; a path that merged and never
    launched the kernel fails. Returns (run's result, launches)."""
    launches, merges = merge_runs.LAUNCHES, rdsort.FINAL_MERGES
    out = run()
    launches, merges = merge_runs.LAUNCHES - launches, rdsort.FINAL_MERGES - merges
    check(not merges or launches, f"the {path} path merged {merges} times and never launched "
          "the merge kernel")
    log(f"{path} path: {merges} final steps merged, merge kernel calls {launches}")
    return out, launches


# ---------------------------------------------------------------- phase 12

# DistTable on the same 4-slot mesh of the card, over phase 9's tables
DT_GROUPS = (16, 1 << 18, 1 << 19)  # per slot: Q1 (4 groups, 4 filtered, padding), Q3, Q13
DT2_CAPACITY = (1 << 20, 1 << 20)  # per slot: ~365k BUILDING orders, ~75k of their lineitems
DT3_CAPACITY = 1 << 23  # per slot: ~3.7M kept orders + ~125k customers without one
DT5_SLOT_CAPACITY = T5_CAPACITY // D_SHARDS
DT_ASOF_ROWS = 1 << 20  # the sharded right side of the ASOF joins
DT4_OPS = {**T4_OPS, "ld": ("lead", "o_totalprice", 1), "nv": ("nth_value", "o_totalprice", 2)}
# the SQL knobs over DistTable sources: the planner joins every row before
# it filters (S2: ~15M per slot after the second join), and Q18's subquery
# and Q3's fused WHERE group ~10M (order key, flag) groups a slot
DS_CAPACITY = 24_000_000
DS_KW = {"DS1": {"max_groups": 16}, "DS2": {"max_groups": 1 << 24},
         "DS3": {"max_groups": 1 << 20}, "DS4": {"max_groups": 1 << 24}}
# the eager-aggregation rewrite over a DistTable: a broadcast lookup join
DS_LOOKUP = ("SELECT o_custkey, SUM(o_totalprice) AS spent, COUNT(*) AS n FROM orders "
             "JOIN customer ON o_custkey = c_custkey GROUP BY o_custkey ORDER BY o_custkey")
MUST_EXCHANGE_DT = ("DT2", "DT3", "DT4", "DT5-asof", "DS2", "DS3", "DS4")


class Fallbacks:
    """Records every replicated fallback the distributed layer takes while
    active: an aggregate's, DISTINCT's or set operator's (``_fallback``
    with its overflow flag set), and the single-device function each other
    plan runs instead: a join's ``hash_join``, a sort's
    ``_global_sort_fallback``, a window's ``_replicated`` and an ASOF
    join's ``join_asof`` (the DistTable verbs call none of them
    otherwise)."""

    def __enter__(self):
        self.taken = []
        self._saved = [(rdq, "_fallback"), (rdq.Q, "hash_join"),
                       (rdsort, "_global_sort_fallback"), (rdw, "_replicated"),
                       (rda.R, "join_asof")]
        self._orig = [getattr(m, a) for m, a in self._saved]

        def flagged(f):
            def fallback(overflow, *a, **kw):
                if overflow:
                    self.taken.append("aggregate/distinct/set-op")
                return f(overflow, *a, **kw)
            return fallback

        def taken(f, what):
            def call(*a, **kw):
                self.taken.append(what)
                return f(*a, **kw)
            return call

        fb, *rest = self._orig
        new = [flagged(fb)] + [taken(f, w) for f, w in zip(rest, ("join", "sort", "window",
                                                                  "asof"))]
        for (m, a), f in zip(self._saved, new):
            setattr(m, a, f)
        return self

    def __exit__(self, *exc):
        for (m, a), f in zip(self._saved, self._orig):
            setattr(m, a, f)


def _padded_table(t):
    """``t`` with its rows zero-padded to a multiple of D_SHARDS (the padding
    outside the valid count), so it shards into equal blocks."""
    n = t.num_rows
    if not n % D_SHARDS:
        return t
    cols = {c: _pad_rows(t[c], 0) for c in t.column_names}
    return Table(cols, n, dictionaries=t._dicts, device=DEV)


def dt1_q1(li):
    """Q1 as T1, through DistTable calls (a filter, two computed columns,
    the distributed aggregate; the sort on its result)."""
    col = rst.col
    t = li.filter(col("l_shipdate") <= Q1_SHIPDATE)
    t = t.with_columns(disc_price=col("l_extendedprice") * (1 - col("l_discount")))
    t = t.with_columns(charge=col("disc_price") * (1 + col("l_tax")))
    t = t.aggregate(["l_returnflag", "l_linestatus"], {
        "sum_qty": ("sum", "l_quantity"), "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", "disc_price"), "sum_charge": ("sum", "charge"),
        "avg_qty": ("mean", "l_quantity"), "avg_price": ("mean", "l_extendedprice"),
        "avg_disc": ("mean", "l_discount"), "count_order": "count"}, max_groups=DT_GROUPS[0])
    return t.sort_by(["l_returnflag", "l_linestatus"])


def dt2_q3(li, orders, customer):
    """Q3 as T2: three filters, two co-partitioned joins (K2 once per slot
    each), the distributed aggregate, the top 10."""
    col = rst.col
    c = customer.filter(col("c_mktsegment") == "BUILDING")
    o = orders.filter(col("o_orderdate") < Q3_DATE).select(
        "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority").rename(
        {"o_custkey": "c_custkey", "o_orderkey": "l_orderkey"})
    co, ovf1 = c.join(o, "c_custkey", capacity_per_shard=DT2_CAPACITY[0])
    lf = li.filter(col("l_shipdate") > Q3_DATE).select("l_orderkey", "l_extendedprice",
                                                       "l_discount")
    rows, ovf2 = co.join(lf, "l_orderkey", capacity_per_shard=DT2_CAPACITY[1])
    rows = rows.with_columns(revenue=col("l_extendedprice") * (1 - col("l_discount")))
    agg = rows.aggregate(["l_orderkey", "o_orderdate", "o_shippriority"],
                         {"revenue": ("sum", "revenue")}, max_groups=DT_GROUPS[1])
    agg = agg.with_columns(neg_date=-agg["o_orderdate"])
    return agg.top_k(10, ["revenue", "neg_date"]), (ovf1, ovf2)


def dt3_q13(orders, customer):
    """Q13 as T3: CUSTOMER left join ORDERS (K2 once per slot), the count of
    the matched orders per customer (the unmatched side is NULL), then the
    customers per count."""
    o = orders.filter(~rst.col("o_special")).select("o_orderkey", "o_custkey").rename(
        {"o_custkey": "c_custkey"})
    co, ovf = customer.join(o, "c_custkey", capacity_per_shard=DT3_CAPACITY, how="left")
    per = co.aggregate("c_custkey", {"c_count": ("count", "o_orderkey")},
                       max_groups=DT_GROUPS[2])
    dist_ = per.aggregate("c_count", {"custdist": "count"})
    return dist_.sort_by(["custdist", "c_count"], descending=True), ovf


def dt4_windows(orders):
    """T4's seven window ops plus lead and nth_value over ORDERS by
    customer and date, then the running sum over every row as one
    partition, as DistTable windows."""
    o = orders.select("o_custkey", "o_orderdate", "o_totalprice")
    w = o.window(DT4_OPS, partition_by="o_custkey", order_by="o_orderdate")
    return w.window({"all_cs": ("cumsum", "o_totalprice")}, order_by="o_orderdate")


def dt5_inputs(raw, gen):
    """The sharded right side of the ASOF joins: DT_ASOF_ROWS rate changes
    on seeded dates (ties among them)."""
    d = torch.randint(STARTDATE, ENDDATE, (DT_ASOF_ROWS,), generator=gen, device=DEV)
    return Table({"o_orderdate": d.to(torch.int32),
                  "rate": torch.randint(0, 1 << 20, (DT_ASOF_ROWS,), dtype=torch.int32,
                                        generator=gen, device=DEV)}, device=DEV)


def _np_same(label, a, b, floats=(), multiset=False):
    """A DistTable result (``a``, or its to_table()) against the
    single-device one: the same columns and valid rows; integers, dates,
    codes, selected values and masks bit for bit (as multisets of rows with
    ``multiset``). The float sums and means in ``floats`` differ by their
    summation order: the workload's oracle holds each to its
    recursive-summation bound instead."""
    ta = a.to_table() if hasattr(a, "to_table") else a
    check(ta.column_names == b.column_names, f"{label}: columns {ta.column_names} != "
          f"{b.column_names}")
    ka = ta.num_rows if ta.count is None else int(ta.count)
    kb = b.num_rows if b.count is None else int(b.count)
    check(ka == kb, f"{label}: {ka} rows != {kb}")
    cols = [c for c in ta.column_names if c not in floats]
    if multiset:
        ga = _canonical([ta[c][:ka] for c in cols])
        gb = _canonical([b[c][:kb] for c in cols])
        check(all(torch.equal(x, y) for x, y in zip(ga, gb)), f"{label}: rows differ")
    else:
        for c in cols:
            check_exact(ta[c][:ka], b[c][:kb], f"{label} {c}")
    for c in ta.column_names:
        ma, mb = ta.null_mask(c), b.null_mask(c)
        check((ma is None) == (mb is None) and (ma is None or torch.equal(ma[:ka], mb[:kb])),
              f"{label} {c}: NULL masks differ")


def dist_table_path(gen):
    """Phase 12: DT1-DT5 and DS1-DS4 over DistTables on the 4-slot mesh at
    SF10, each checked against its torch oracle where phase 9 / 10 has one
    and against the single-device Table / SQL result, K2 and run-ends
    launches and replicated fallbacks read around each call. Returns
    (workloads for time_dist, K2 expansions for k2_at_shapes, K2 launches,
    run-ends launches)."""
    mesh = rdist.data_mesh(D_SHARDS, device=DEV)
    raw = tpch_sf10(gen)
    li, orders, customer = facade_tables(raw, gen)
    raw["o_special"] = orders["o_special"]
    tiers, windows, values = t5_inputs(raw, gen)
    rates = dt5_inputs(raw, gen)
    DT = rst.DistTable
    d_li, d_orders, d_customer = (DT.from_table(_padded_table(t), mesh)
                                  for t in (li, orders, customer))
    d_values, d_rates = DT.from_table(values, mesh), DT.from_table(rates, mesh)
    log(f"DistTable at SF10 on {D_SHARDS} slots of the card: {d_li!r}, {d_orders!r}, "
        f"{d_customer!r}")
    otk = orders.select("o_orderkey", "o_orderdate")
    d_otk = d_orders.select("o_orderkey", "o_orderdate")
    s_tables = {"lineitem": li, "orders": orders, "customer": customer}
    d_tables = {"lineitem": d_li, "orders": d_orders, "customer": d_customer}

    def with_table(out):
        return (out[0].to_table(), out[1])

    work = {
        "DT1 Q1 as T1: filter, with_columns, aggregate (4 groups), sort_by": (
            lambda: dt1_q1(d_li), lambda: t1_q1(li), lambda g: check_t1(raw, g),
            0, S_FLOATS["S1"]),
        "DT2 Q3 as T2: 3 filters, 2 co-partitioned joins, aggregate, top_k(10)": (
            lambda: dt2_q3(d_li, d_orders, d_customer), lambda: t2_q3(li, orders, customer),
            lambda g: check_t2(raw, li, orders, customer, g), 2 * D_SHARDS, ("revenue",)),
        "DT3 Q13 as T3: CUSTOMER left join ORDERS, two aggregates": (
            lambda: dt3_q13(d_orders, d_customer), lambda: t3_q13(orders, customer),
            lambda g: check_t3(raw, g), D_SHARDS, ()),
        "DT4 T4's windows + lead, nth_value, and one 15M-row partition, as DistTable.window": (
            lambda: dt4_windows(d_orders), lambda: dt4_windows(orders),
            lambda g: check_t4(raw, g.to_table()), 0, ("cs", "rs", "all_cs")),
        "DT5a ORDERS join_band 1024 replicated price tiers": (
            lambda: d_orders.select("o_orderkey", "o_totalprice").join_band(
                tiers, "o_totalprice", "between", ("lo", "hi"),
                capacity_per_shard=d_orders.rows_per_shard),
            lambda: t5_tiers(orders, tiers),
            lambda g: check_t5_tiers(raw, tiers, with_table(g)), 0, ()),
        "DT5b ORDERS join_band 2 replicated date windows per customer on o_custkey": (
            lambda: d_orders.select("o_orderkey", "o_custkey", "o_orderdate").join_band(
                windows, "o_orderdate", "between", ("w_lo", "w_hi"), on="o_custkey",
                capacity_per_shard=DT5_SLOT_CAPACITY),
            lambda: t5_windows(orders, windows),
            lambda g: check_t5_windows(raw, windows, with_table(g)), D_SHARDS, ()),
        "DT5-asof ORDERS join_asof 1M sharded rates on o_orderdate, backward": (
            lambda: d_otk.join_asof(d_rates, "o_orderdate", matched_col="m"),
            lambda: otk.join_asof(rates, "o_orderdate", matched_col="m"), None, 0, ()),
        "DT5-asoftol ORDERS join_asof 1M sharded rates, nearest within 2 days": (
            lambda: d_otk.join_asof(d_rates, "o_orderdate", direction="nearest", tolerance=2,
                                    matched_col="m"),
            lambda: otk.join_asof(rates, "o_orderdate", direction="nearest", tolerance=2,
                                  matched_col="m"), None, 0, ()),
        "DT5c DistTable.unnest of 1M rows, counts in [0, 128]": (
            lambda: d_values.unnest("n", U_CAPACITY // D_SHARDS),
            lambda: values.unnest("n", U_CAPACITY),
            lambda g: check_t5_unnest(values, with_table(g)), D_SHARDS, ()),
    }
    for name, (q, text, kw) in S_QUERIES.items():
        dname = "D" + name  # DS1-DS4
        dkw = dict(capacity_per_shard=DS_CAPACITY, exchange_capacity_factor=2.0,
                   **DS_KW[dname])

        def dcall(text=text, dkw=dkw):
            return rst.sql(text, d_tables, **dkw).collect(return_overflow=True)

        def scall(text=text, kw=kw):
            return rst.sql(text, s_tables, **kw).collect(return_overflow=True)

        work[f"{dname} TPC-H {q} as SQL over DistTable sources"] = (
            dcall, scall, lambda g, name=name: _s_check(name, raw, li, orders, customer, *g),
            None, S_FLOATS[name])

    launches, re_launches, k2 = 0, 0, {}
    for label, (call, single, verify, k2_calls, floats) in work.items():
        name = label.split()[0]
        before, re_before = expand.LAUNCHES, run_ends.LAUNCHES
        with Fallbacks() as fb:
            got = call()
            torch.cuda.synchronize()
        calls, re_calls = expand.LAUNCHES - before, run_ends.LAUNCHES - re_before
        launches, re_launches = launches + calls, re_launches + re_calls
        check(not fb.taken, f"{name}: unforced replicated fallback {fb.taken}")
        if k2_calls is not None:
            check(calls == k2_calls, f"{name}: {calls} K2 launches, expected {k2_calls}")
        if calls:
            k2[name] = (call, calls)
        note = verify(got) if verify is not None else "no torch oracle (single-device only)"
        want = single()
        g = got[0] if isinstance(got, tuple) else got
        w = want[0] if isinstance(want, tuple) else want
        if isinstance(got, tuple):
            check(not bool(got[1]) if not isinstance(got[1], tuple)
                  else not any(bool(o) for o in got[1]), f"{name}: overflow")
        _np_same(name, g, w, floats=floats, multiset=name in ("DT5b",))
        log(f"{name}: matches the single-device result; K2 launches {calls}, run-ends "
            f"launches {re_calls}; replicated fallbacks none; {note}")
        del got, want, g, w
    plan = rst.sql(DS_LOOKUP, d_tables, max_groups=1 << 20, capacity_per_shard=DS_CAPACITY)
    text = plan.explain()
    check("join[lookup on o_custkey]" in text, "DS-lookup: no broadcast lookup join in the plan")
    log("DS-lookup (the eager-aggregation rewrite over DistTable sources): " + DS_LOOKUP
        + "\n" + text)
    re_before = run_ends.LAUNCHES
    got = plan.collect()
    torch.cuda.synchronize()
    re_calls = run_ends.LAUNCHES - re_before
    re_launches += re_calls
    want = rst.sql(DS_LOOKUP, s_tables).collect()
    _np_same("DS-lookup", got, want, floats=("spent",))
    k = int(want.count)
    err = (got["spent"][:k] - want["spent"][:k]).abs()
    n = want["n"][:k].to(torch.float64)  # sum |x| <= n * max price: the parity bound
    check(bool((err <= 2 * n * U64 * got["spent"][:k].abs()).all()),
          "DS-lookup spent beyond its summation bound")
    log(f"DS-lookup: matches the single-device SQL result; run-ends launches {re_calls}")
    timed = {label: (call, single, rows_in(label, li, orders, customer))
             for label, (call, single, *_) in work.items()}
    return timed, k2, launches, re_launches


def rows_in(label, li, orders, customer):
    """Input rows of a phase-12 workload (for the rows/s figure)."""
    name = label.split()[0]
    return {"DT1": li.num_rows, "DT2": li.num_rows + orders.num_rows + customer.num_rows,
            "DT3": orders.num_rows + customer.num_rows, "DS1": li.num_rows,
            "DS2": li.num_rows + orders.num_rows + customer.num_rows,
            "DS3": orders.num_rows + customer.num_rows,
            "DS4": 2 * li.num_rows + orders.num_rows + customer.num_rows,
            "DT5c": U_VALUES}.get(name, orders.num_rows)



# ---------------------------------------------------------------- phase 13

# the demo CLI (the reference's `cargo run -r`), persisted datasets, the
# demo's ops and queries suites, a TPC-H SF1 load from text into SQL, the
# native host sort and string interning, and the examples
DEMO_SIZES = ("0.5", "1.0", "1.5", "2.0", "2.5", "3.0", "3.5", "4.0")  # GB, src/main.rs:104
DEMO_RUNS = 5
DEMO_OTHER = (("zipf", ("--zipf-s", "1.1")), ("geometric", ()),
              ("step_uniform", ("--steps", "1000")))
DEMO_OTHER_SIZES = ("0.5", "4.0")
DEMO_GEN_ROWS = "1.25e8"  # 1 GB of u64 keys
DEMO_OPS_N = 1 << 24  # the demo's --ops-n and --groups defaults
DEMO_GROUPS = 1 << 20
DEMO_SMALL = 1 << 20  # the card-against-CPU runs of every op and query
# TPC-H SF1 (specification 4.2.3 and 4.2.5): ORDERS 1.5M, CUSTOMER 150k,
# PART 200k, SUPPLIER 10k, LINEITEM 1-7 rows per order
SF1_ORDERS, SF1_CUSTOMERS, SF1_PARTS, SF1_SUPPLIERS = 1_500_000, 150_000, 200_000, 10_000
SF1_CAPACITY = 1 << 23  # Q3's joins: every LINEITEM row (~6M) joins
# the columns of phase 10's S1 (Q1) and S2 (Q3)
S_COLUMNS = ("l_orderkey", "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
             "l_discount", "l_tax", "l_shipdate", "o_orderkey", "o_custkey", "o_orderdate",
             "o_shippriority", "c_custkey", "c_mktsegment")
HOST_SORT_ROWS = MAIN_ROWS[0]  # 31.25M (u64,u64) rows, the sweep's 0.5 GB point
WRITE_WORKERS = 8
# the words dbgen's text grammar draws from (4.2.2.10), for comments
TEXT_WORDS = (
    "furiously sly careful blithe quick fluffy slow quiet ruthless thin close dogged daring "
    "brave stealthy permanent enticing idle busy regular final ironic even bold silent "
    "packages requests accounts deposits foxes ideas theodolites pinto beans instructions "
    "dependencies excuses platelets asymptotes courts dolphins multipliers sauternes warthogs "
    "frets dinos attainments somas tithes waters orbits pearls sleep wake are cajole haggle "
    "nag use boost affix detect integrate maintain nod was lose sublate solve thrash promise "
    "engage hinder print x-ray breach eat grow impress mold poach serve run dazzle snooze doze "
    "unwind kindle play hang believe doubt about above according to across after against "
    "along alongside among around at atop before behind beneath beside besides between "
    "beyond by despite during except for from inside instead of into near of on outside "
    "over past since through throughout to toward under until up upon without with within"
).split()
SEGMENT_NAMES = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")


def _demo(*argv):
    """One run of the port's demo CLI (its lines go to standard output)."""
    t0 = time.perf_counter()
    demo.main([*argv, "--device", DEV])
    return time.perf_counter() - t0


def _i32(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def demo_sort_checks(gen):
    """One batch of each (row type, distribution, size) of 13a made by the
    demo's generators, sorted by both of its engines and held bit for bit
    against a stable ``torch.sort``; the payload is the row index, so the
    check sees stability. K1 is first held against its plain version on the
    calls of one more u32 sort at the first and the last size, whose rows
    are let go before the check (at 500M rows the recorded calls, their
    plain versions and the checked batch do not fit together). Returns (K1
    rows, max abs err)."""
    points = [("uniform", (), s) for s in DEMO_SIZES]
    points += [(d, kw, s) for d, kw in DEMO_OTHER for s in DEMO_OTHER_SIZES]
    k1_rows, k1_err = {}, 0
    for dt_name in ("u32", "u64"):
        fns = demo._engine_fns(dt_name, ["comparator", "pallas"])
        for dist_name, kw, gb in points:
            args = demo._parse_args(["--dist", dist_name, *kw])
            n = int(float(gb) * 1e9 / {"u32": 8, "u64": 16}[dt_name])
            if dt_name == "u32" and dist_name == "uniform" and gb in (DEMO_SIZES[0],
                                                                       DEMO_SIZES[-1]):
                calls = record_k1(lambda: fns["pallas"](demo._make_rows(gen, n, dt_name, args)))
                k1_rows[f"u32 {gb} GB"], e = k1_against_plain(
                    calls, f"demo (u32,u32) {gb} GB ({n:,} rows)")
                k1_err = max(k1_err, e)
                del calls
                torch.cuda.empty_cache()
            rows = demo._make_rows(gen, n, dt_name, args)
            if dt_name == "u64":
                idx = keys.split64(torch.arange(n, dtype=torch.int64, device=DEV) ^ (-(1 << 63)))
                rows = (rows[0], rows[1], *idx)
                del idx
            else:
                rows = (rows[0], torch.arange(n, dtype=torch.int32, device=DEV).view(torch.uint32))
            if dt_name == "u64":
                srt = torch.sort(keys.merge64(rows[0], rows[1]), stable=True)
                want = (*keys.split64(srt.values), rows[2][srt.indices], rows[3][srt.indices])
            else:
                srt = torch.sort(keys.encode(rows[0]), stable=True)
                want = (_i32(rows[0])[srt.indices], _i32(rows[1])[srt.indices])
            distinct = int(torch.unique_consecutive(srt.values).shape[0])
            del srt
            for eng, fn in fns.items():
                got = fn(rows)
                check(all(torch.equal(_i32(g), _i32(w)) for g, w in zip(got, want)),
                      f"13a: {eng} differs from a stable torch.sort on ({dt_name},{dt_name}) "
                      f"{dist_name} rows at {gb} GB")
                del got
            log(f"13a check: ({dt_name},{dt_name}) {dist_name} {gb} GB = {n:,} rows "
                f"({distinct:,} distinct keys): comparator and pallas bit-exact against a "
                f"stable torch.sort")
            del rows, want
            torch.cuda.empty_cache()
    return k1_rows, k1_err


def demo_sweep(gen):
    """13a: the reference's sweep through the port's CLI, both row types and
    both engines, then the other three distributions, each batch checked
    first. Returns (K1 launches in the timed sweep, K1 rows, max err)."""
    before = sample_sort.FALLBACKS
    k1_rows, k1_err = demo_sort_checks(gen)
    torch.cuda.empty_cache()
    extract.LAUNCHES = 0
    t = _demo("--sizes", *DEMO_SIZES, "--dtypes", "u32", "u64",
              "--engines", "comparator", "pallas", "--runs", str(DEMO_RUNS))
    log(f"13a sweep: {t:.1f} s")
    for dist_name, kw in DEMO_OTHER:
        t = _demo("--sizes", *DEMO_OTHER_SIZES, "--dtypes", "u32", "u64", "--dist", dist_name,
                  *kw, "--engines", "comparator", "pallas", "--runs", str(DEMO_RUNS))
        log(f"13a {dist_name}: {t:.1f} s")
    launches = extract.LAUNCHES
    check(launches > 0, "the demo's sweep never launched the extract kernel")
    check(sample_sort.FALLBACKS == before,
          f"13a: the sample engine fell back to the comparator "
          f"{sample_sort.FALLBACKS - before} times")
    log(f"13a: extract kernel calls {launches}; no comparator fallback")
    return launches, k1_rows, k1_err


def demo_datasets():
    """13b: a persisted 1 GB zipf dataset, written by the CLI, read back bit
    for bit and sorted by both engines from the file."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "zipf.raw")
        t = _demo("--gen-data", path, "--n", DEMO_GEN_ROWS, "--dist", "zipf", "--dtypes", "u64")
        arr = rio.read_raw(path)
        # the same draw: the demo's --seed 0 and the zipf exponent 1.1
        want = dist.zipf(torch.Generator(device=DEV).manual_seed(0), int(float(DEMO_GEN_ROWS)),
                         torch.uint64, s=1.1).view(torch.int64).cpu().numpy().view(np.uint64)
        check(arr.dtype == np.uint64 and np.array_equal(arr, want),
              "13b: read_raw does not return the generated keys")
        log(f"13b: --gen-data {t:.1f} s; read_raw returns the {arr.size:,} generated keys "
            f"bit for bit ({np.unique(arr[:1 << 22]).shape[0]:,} distinct of the first 4M)")
        del arr, want
        _demo("--data", path, "--engines", "comparator", "pallas", "--runs", "3")


def _nonneg_bound(a, b, m, mean=False):
    """The allowed |a - b| of two float sums (or means) of the same ``m``
    non-negative terms, added in different orders: each is within
    (m - 1) u S of the exact sum S (phase 8's bound; here S = sum|x|), and
    S <= |v| / (1 - (m - 1) u) for either computed sum v; a mean adds its
    division's rounding."""
    u = U32 if a.dtype == np.float32 else U64
    k = np.maximum(np.asarray(m, np.float64) - 1, 0) * u
    share = k / (1 - k) + (2 * u if mean else 0.0)
    return share * (np.abs(a.astype(np.float64)) + np.abs(b.astype(np.float64)))


def _var_bound(a, b, k, v, groups):
    """hash_aggregate(k, v, "var") on the card (``a``) and the CPU (``b``):
    (keys, var, groups), numpy. Each group's variance is held to the exact
    one (float64 from ``v``'s integers) within phase 8's two-pass bound,
    computed with the group's own row count, sum|x| and sum (x - mean)^2;
    returns the allowed |a - b| of the var column (0 on padding rows)."""
    keys, num = a[0], int(a[2])
    v = v.astype(np.float64)
    m = np.bincount(k, minlength=groups).astype(np.float64)
    mean = np.bincount(k, weights=v, minlength=groups) / np.maximum(m, 1)
    s_abs = np.bincount(k, weights=np.abs(v), minlength=groups)
    s2 = np.bincount(k, weights=(v - mean[k]) ** 2, minlength=groups)
    g = keys[:num]
    m, mean, s_abs, s2 = m[g], mean[g], s_abs[g], s2[g]
    check(bool((m > 0).all()), "demo-hash_aggregate_var: a key that is in no row")
    b_mean = ((m - 1) * U32 * s_abs + 8 * U64 * s_abs) / m + 2 * U32 * np.abs(mean)
    var = s2 / m
    b_var = (m + 3) * U32 * s2 / m + b_mean**2 + 2 * U32 * var + 8 * U64 * s2
    for side, got in (("card", a[1]), ("CPU", b[1])):
        err = np.abs(got[:num].astype(np.float64) - var)
        check(bool((err <= b_var).all()), f"demo-hash_aggregate_var: the {side}'s var "
              f"beyond its two-pass bound of the exact one")
    bound = np.zeros(a[1].shape[0])
    bound[:num] = 2 * b_var
    return bound


def _demo_float_bounds(name, a, b):
    """{column or index: allowed |card - CPU| per element} of the float
    results of one 13c entry at DEMO_SMALL rows: sums and means of
    non-negative terms within the summation bound of their own group's row
    count (a count the result carries, else counted from the entry's rows),
    copied floats bit for bit, the variance as _var_bound says."""
    if name == "demo-hash_aggregate_var":
        d = demo.ops_data(DEMO_SMALL, DEMO_GROUPS, 0)
        return {1: _var_bound(a, b, d["k"], d["v"], DEMO_GROUPS)}
    per_cust = np.bincount(demo.queries_data(DEMO_SMALL, 0)["line"]["custkey"])
    if name == "demo-q1":
        return {"rev": _nonneg_bound(a["rev"], b["rev"], a["n"]),
                "aq": _nonneg_bound(a["aq"], b["aq"], a["n"], mean=True)}
    if name == "demo-q3":
        return {"rev": _nonneg_bound(a["rev"], b["rev"], per_cust[a["custkey"]])}
    if name == "demo-qwin":
        return {"price": np.zeros(a["price"].shape[0]),
                "tot": _nonneg_bound(a["tot"], b["tot"], per_cust[a["custkey"]])}
    if name in ("demo-qdate", "demo-qfan"):
        return {"rev": _nonneg_bound(a["rev"], b["rev"], a["cnt"])}
    return {}


def _as_numpy(x):
    """A result (a Table, tensors, or nested dicts / tuples / lists of
    them) as numpy, unsigned tensors by their bits."""
    if isinstance(x, Table):
        return x.to_numpy()
    if isinstance(x, dict):
        return {k: _as_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_as_numpy(v) for v in x)
    if torch.is_tensor(x):
        return (_bits(x) if x.dtype in (torch.uint32, torch.uint64) else x).cpu().numpy()
    return x


def _same_numpy(label, a, b, bounds):
    """Two results as _as_numpy gives them: integers, strings and masks bit
    for bit, each float column or element within ``bounds`` of its name or
    index (the allowed |a - b| per element). A float result that has no
    bound fails. Returns the largest share of its bound any float used."""
    check(type(a) is type(b), f"{label}: types differ")
    if isinstance(a, (dict, tuple, list)):
        keys = list(a) if isinstance(a, dict) else range(len(a))
        check(len(a) == len(b) and list(keys) == (list(b) if isinstance(b, dict)
                                                  else list(range(len(b)))),
              f"{label}: columns differ")
        return max([_same_numpy(f"{label} {k}", a[k], b[k], {None: bounds.get(k)})
                    for k in keys] + [0.0])
    check(a.dtype == b.dtype and a.shape == b.shape, f"{label}: dtype or shape differ")
    if isinstance(a, np.ma.MaskedArray):
        check(np.array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b)), f"{label}: masks")
        a, b = np.ma.getdata(a), np.ma.getdata(b)
    if a.dtype.kind != "f":
        check(np.array_equal(a, b), f"{label}: values differ")
        return 0.0
    bound = bounds.get(None)
    check(bound is not None, f"{label}: a float result with no stated bound")
    err = np.abs(a.astype(np.float64) - b.astype(np.float64))
    check(bool((err <= bound).all()), f"{label}: card and CPU floats beyond the bound")
    return float(np.max(err / np.maximum(bound, 1e-300), initial=0.0))


def demo_suites():
    """13c: the ops and queries suites at the demo's defaults (their lines),
    with K2's launches counted around them; every op and query once more at
    DEMO_SMALL rows on the card and on the CPU (the same builder), held
    equal (floats by _demo_float_bounds); the K2 expansions of each entry at
    the demo's size for k2_at_shapes, and the entries with merge-rank unions
    for run_ends_at_shapes. Returns (K2 launches, K2 workloads, run-ends
    launches, run-ends workloads)."""
    expand.LAUNCHES = run_ends.LAUNCHES = 0
    t = _demo("--suite", "ops", "--ops-n", str(DEMO_OPS_N), "--groups", str(DEMO_GROUPS),
              "--runs", str(DEMO_RUNS))
    log(f"13c ops suite: {t:.1f} s")
    t = _demo("--suite", "queries", "--ops-n", str(DEMO_OPS_N), "--runs", str(DEMO_RUNS))
    log(f"13c queries suite: {t:.1f} s")
    launches, re_launches = expand.LAUNCHES, run_ends.LAUNCHES
    check(launches > 0, "the demo's suites never launched the expand kernel")
    check(re_launches > 0, "the demo's suites never launched the run-ends kernel")
    log(f"13c: expand kernel calls {launches}, run-ends kernel calls {re_launches}")
    k2, re = {}, {}
    entries = [(f"demo-{k}", functools.partial(demo.build_op, k, groups=DEMO_GROUPS))
               for k in demo.OPS]
    entries += [(f"demo-{k}", functools.partial(demo.build_query, k)) for k in demo.QUERIES]
    for name, build in entries:
        fn, args = build(DEMO_OPS_N, 0, DEV)
        before, re_before = expand.LAUNCHES, run_ends.LAUNCHES
        fn(*args)
        torch.cuda.synchronize()
        calls, re_calls = expand.LAUNCHES - before, run_ends.LAUNCHES - re_before
        if calls:
            k2[name] = (lambda fn=fn, args=args: fn(*args), calls)
        if re_calls:
            re[name] = lambda fn=fn, args=args: fn(*args)
        del fn, args
        fn_c, args_c = build(DEMO_SMALL, 0, DEV)
        fn_h, args_h = build(DEMO_SMALL, 0, "cpu")
        a, b = _as_numpy(fn_c(*args_c)), _as_numpy(fn_h(*args_h))
        share = _same_numpy(name, a, b, _demo_float_bounds(name, a, b))
        log(f"13c {name}: card = CPU at {DEMO_SMALL:,} rows (floats used {share:.2e} of "
            f"their bound); K2 launches at {DEMO_OPS_N:,} rows: {calls}, run-ends: {re_calls}")
    return launches, k2, re_launches, re


def _text(rng, n, lo, hi, pool):
    """n comments of lo..hi characters cut from ``pool`` at random offsets,
    as dbgen does (4.2.2.10), as a fixed-width unicode array; the first
    and last characters are never spaces (the loader strips fields)."""
    lens = rng.integers(lo, hi + 1, n)
    offs = rng.integers(0, pool.shape[0] - hi, n)
    cps = pool[offs[:, None] + np.arange(hi)]
    cps[np.arange(hi)[None, :] >= lens[:, None]] = 0
    sp, x = ord(" "), ord("x")
    cps[:, 0] = np.where(cps[:, 0] == sp, x, cps[:, 0])
    last = (np.arange(n), lens - 1)
    cps[last] = np.where(cps[last] == sp, x, cps[last])
    return np.ascontiguousarray(cps).view(f"<U{hi}").reshape(n)


def tpch_sf1(seed):
    """LINEITEM (16 columns), ORDERS (9) and CUSTOMER (8) of TPC-H 1.4.1 at
    SF1 as numpy columns, with the spec's value domains (4.2.3): sparse
    order keys, customers without orders, dates from STARTDATE, money as
    whole cents (kept as int64 cents; the file holds them with 2 decimals),
    comments of the spec's lengths cut from a text pool. Returns
    {table: {column: (kind, array)}} with kind int / money / date / str."""
    rng = np.random.default_rng(seed)
    pool = np.array(list(" ".join(rng.choice(TEXT_WORDS, 400_000))), dtype="<U1").view(np.uint32)
    n_c, n_o = SF1_CUSTOMERS, SF1_ORDERS
    c_custkey = np.arange(1, n_c + 1, dtype=np.int64)
    nation = rng.integers(0, 25, n_c)
    alnum = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789,"),
                     dtype="<U1").view(np.uint32)
    customer = {
        "c_custkey": ("int", c_custkey),
        "c_name": ("str", np.array([f"Customer#{k:09d}" for k in c_custkey.tolist()])),
        "c_address": ("str", _text(rng, n_c, 10, 40, alnum[rng.integers(0, alnum.shape[0],
                                                                          1 << 20)])),
        "c_nationkey": ("int", nation),
        "c_phone": ("str", np.array([f"{a + 10}-{b}-{c}-{d}" for a, b, c, d in zip(
            nation.tolist(), rng.integers(100, 1000, n_c).tolist(),
            rng.integers(100, 1000, n_c).tolist(), rng.integers(1000, 10000, n_c).tolist())])),
        "c_acctbal": ("money", rng.integers(-99_999, 1_000_000, n_c)),
        "c_mktsegment": ("str", np.array(SEGMENT_NAMES)[rng.integers(0, 5, n_c)]),
        "c_comment": ("str", _text(rng, n_c, 29, 116, pool)),
    }
    i = np.arange(n_o, dtype=np.int64)
    orderkey = (i // 8) * 32 + i % 8 + 1  # sparse keys: 8 of every 32
    u = rng.integers(0, n_c * 2 // 3, n_o)
    o_custkey = 3 * (u // 2) + 1 + u % 2  # no customer whose key is a multiple of 3
    orderdate = rng.integers(STARTDATE, ENDDATE - 151 + 1, n_o)
    per = rng.integers(1, 8, n_o)
    of = np.repeat(np.arange(n_o), per)
    n_l = of.shape[0]
    first = np.cumsum(per) - per
    partkey = rng.integers(1, SF1_PARTS + 1, n_l)
    supp_i = rng.integers(0, 4, n_l)
    suppkey = (partkey + supp_i * (SF1_SUPPLIERS // 4 + (partkey - 1) // SF1_SUPPLIERS)) \
        % SF1_SUPPLIERS + 1
    qty = rng.integers(1, 51, n_l)
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)  # P_RETAILPRICE cents
    ext = qty * retail
    disc, tax = rng.integers(0, 11, n_l), rng.integers(0, 9, n_l)
    ship = orderdate[of] + rng.integers(1, 122, n_l)
    commit = orderdate[of] + rng.integers(30, 91, n_l)
    receipt = ship + rng.integers(1, 31, n_l)
    rflag = np.where(receipt <= CURRENTDATE, np.where(rng.integers(0, 2, n_l) == 0, "R", "A"),
                     "N")
    lstatus = np.where(ship > CURRENTDATE, "O", "F")
    # O_TOTALPRICE: sum of extendedprice * (1 + tax) * (1 - discount), in cents
    charge = (ext * (100 + tax) * (100 - disc) + 5_000) // 10_000
    total = np.bincount(of, weights=charge, minlength=n_o).astype(np.int64)
    n_f = np.bincount(of, weights=(lstatus == "F").astype(np.float64), minlength=n_o)
    ostatus = np.where(n_f == per, "F", np.where(n_f == 0, "O", "P"))
    day = np.datetime64("1970-01-01", "D")
    lineitem = {
        "l_orderkey": ("int", orderkey[of]),
        "l_partkey": ("int", partkey),
        "l_suppkey": ("int", suppkey),
        "l_linenumber": ("int", np.arange(n_l) - first[of] + 1),
        "l_quantity": ("int", qty),
        "l_extendedprice": ("money", ext),
        "l_discount": ("money", disc),
        "l_tax": ("money", tax),
        "l_returnflag": ("str", rflag),
        "l_linestatus": ("str", lstatus),
        "l_shipdate": ("date", day + ship.astype("timedelta64[D]")),
        "l_commitdate": ("date", day + commit.astype("timedelta64[D]")),
        "l_receiptdate": ("date", day + receipt.astype("timedelta64[D]")),
        "l_shipinstruct": ("str", np.array(INSTRUCTIONS)[rng.integers(0, 4, n_l)]),
        "l_shipmode": ("str", np.array(MODES)[rng.integers(0, 7, n_l)]),
        "l_comment": ("str", _text(rng, n_l, 10, 43, pool)),
    }
    orders = {
        "o_orderkey": ("int", orderkey),
        "o_custkey": ("int", o_custkey),
        "o_orderstatus": ("str", ostatus),
        "o_totalprice": ("money", total),
        "o_orderdate": ("date", day + orderdate.astype("timedelta64[D]")),
        "o_orderpriority": ("str", np.array(PRIORITIES)[rng.integers(0, 5, n_o)]),
        "o_clerk": ("str", np.array([f"Clerk#{k:09d}" for k in
                                     rng.integers(1, 1001, n_o).tolist()])),
        "o_shippriority": ("int", np.zeros(n_o, np.int64)),
        "o_comment": ("str", _text(rng, n_o, 19, 78, pool)),
    }
    return {"lineitem": lineitem, "orders": orders, "customer": customer}


def _format(kind, a):
    """One column as a list of its text fields."""
    if kind == "money":
        return [f"-{-c // 100}.{-c % 100:02d}" if c < 0 else f"{c // 100}.{c % 100:02d}"
                for c in a.tolist()]
    return a.astype(str).tolist()


def _write_part(path, kinds, cols):
    """Worker: a chunk of rows as '|'-delimited lines into ``path``."""
    fields = [_format(k, c) for k, c in zip(kinds, cols)]
    with open(path, "w") as f:
        f.write("\n".join(map("|".join, zip(*fields))))
        f.write("\n")


def write_tbl(path, table, pool):
    """A table as dbgen's '|'-delimited layout with a header row, written
    in row chunks by ``pool``'s worker processes."""
    names = list(table)
    kinds = [table[c][0] for c in names]
    n = table[names[0]][1].shape[0]
    step = -(-n // (4 * WRITE_WORKERS))
    parts = [f"{path}.{i}" for i in range(0, n, step)]
    pool.starmap(_write_part, [(p, kinds, [table[c][1][i:i + step] for c in names])
                               for p, i in zip(parts, range(0, n, step))])
    with open(path, "w") as out:
        out.write("|".join(names) + "\n")
        out.flush()
        for p in parts:
            with open(p) as f:
                shutil.copyfileobj(f, out, 1 << 24)
            os.remove(p)


def _numpy_value(kind, a):
    """The column a Table built directly from numpy takes, and what the
    loaded column must equal: cents as float(text) = cents / 100."""
    return a / 100 if kind == "money" else a


def check_loaded(name, t, table):
    """Every column of a loaded Table against the numpy column it was
    written from: strings through their vocabulary, dates as date32 days
    with no cast, integers as int64, money as float(text)."""
    for c, (kind, a) in table.items():
        got = t[c]
        if kind == "str":
            vocab = t._dicts[c]
            dec = vocab[_bits(got).cpu().numpy()]
            check(np.array_equal(dec, a), f"13d {name}.{c}: strings differ")
        elif kind == "date":
            check(got.dtype == torch.int32 and np.array_equal(
                got.cpu().numpy(), a.astype(np.int64).astype(np.int32)),
                f"13d {name}.{c}: dates differ")
        else:
            want = _numpy_value(kind, a)
            check(got.dtype == torch.from_numpy(want).dtype and np.array_equal(
                _bits(got).cpu().numpy(), _bits(torch.from_numpy(want)).numpy()),
                f"13d {name}.{c}: values differ")


def sf1_load():
    """13d: TPC-H SF1 written as '|'-delimited text, loaded with
    ``Table.from_csv``, every column checked, Q1 and Q3 as SQL over the
    loaded tables against the same SQL over Tables built from the numpy
    columns; ``strings.encode`` / ``unify`` and the native intern on the
    data against numpy; the native host sort against numpy and the card's
    ``torch.sort``. After each file's ``from_csv``, its two steps are
    timed once more on their own: the parse (``utils/io.read_csv_encoded``)
    and the upload (``Table`` of the parsed columns)."""
    check(native.native_available() and csvio.csv_native_available(),
          "13d: the native host libraries did not build")
    loaded, timer = {}, profiling.PhaseTimer()

    with tempfile.TemporaryDirectory() as d:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(WRITE_WORKERS) as pool:
            t1 = time.perf_counter()
            up = pool.map_async(abs, range(WRITE_WORKERS))  # the workers start meanwhile
            data = tpch_sf1(SEED)
            log(f"13d: TPC-H SF1 made in {time.perf_counter() - t1:.2f} s: "
                + ", ".join(f"{k} {v[next(iter(v))][1].shape[0]:,} rows x {len(v)} columns"
                            for k, v in data.items()))
            up.get()
            log(f"13d: {WRITE_WORKERS} writer processes up after {time.perf_counter() - t1:.2f} s")
            for name, table in data.items():
                path = os.path.join(d, f"{name}.tbl")
                t1 = time.perf_counter()
                write_tbl(path, table, pool)
                w = time.perf_counter() - t1
                size = os.path.getsize(path)
                n = table[next(iter(table))][1].shape[0]
                torch.cuda.synchronize()
                with timer.phase(f"{name} from_csv"):
                    t = rst.Table.from_csv(path, delimiter="|", device=DEV)
                    timing.sync(list(t._cols.values()))
                cols, dicts, masks = timer.time_fn(f"{name} parse", functools.partial(
                    rio.read_csv_encoded, path, delimiter="|"))
                timer.time_fn(f"{name} upload", lambda: list(rst.Table(
                    cols, dictionaries=dicts, null_masks=masks or None, device=DEV)._cols.values()))
                del cols, dicts, masks
                total, p, up = (ph[1] for ph in timer.phases[-3:])
                log(f"13d {name}: wrote {size / 1e6:.1f} MB in {w:.2f} s "
                    f"({WRITE_WORKERS} processes); Table.from_csv {total:.2f} s; its two steps "
                    f"alone: parse {p:.2f} s ({size / p / 1e6:.1f} MB/s, {n / p / 1e6:.2f} M "
                    f"rows/s), upload {up:.3f} s")
                check_loaded(name, t, table)
                log(f"13d {name}: every column equals the column it was written from")
                loaded[name] = t
    log("13d Table.from_csv, then its parse and upload alone, per file:\n" + timer.report())
    # the columns Q1 and Q3 read, straight from numpy (the comments, names,
    # addresses and phones they do not read would only add encode time)
    direct = {name: rst.Table({c: _numpy_value(k, a) for c, (k, a) in table.items()
                               if c in S_COLUMNS}, device=DEV)
              for name, table in data.items()}
    for s, kw in (("S1", {}), ("S2", {"capacity": SF1_CAPACITY})):
        q, text, _ = S_QUERIES[s]
        got, ovf = rst.sql(text, loaded, **kw).collect(return_overflow=True)
        want, wovf = rst.sql(text, direct, **kw).collect(return_overflow=True)
        check(not bool(ovf) and not bool(wovf), f"13d {s}: a join overflowed")
        a, b = got.to_numpy(), want.to_numpy()
        if s == "S1":  # every float is a sum or mean of a group's count_order rows
            bounds = {c: _nonneg_bound(a[c], b[c], a["count_order"], mean=c.startswith("avg"))
                      for c in a if a[c].dtype.kind == "f"}
        else:  # Q3's revenue sums the lineitems of one order
            per_order = np.bincount(data["lineitem"]["l_orderkey"][1])
            bounds = {"revenue": _nonneg_bound(a["revenue"], b["revenue"],
                                               per_order[a["o_orderkey"]])}
        share = _same_numpy(f"13d {s}: loaded against in-memory tables", a, b, bounds)
        floats = [c for c in a if a[c].dtype.kind == "f"]
        same_bits = all(np.array_equal(a[c].view(np.uint8), b[c].view(np.uint8)) for c in floats)
        log(f"13d {s}: every integer, string and date of the loaded tables' result equals the "
            f"in-memory tables' bit for bit; the float sums and means "
            + ("too" if same_bits else f"within {share:.2e} of the summation bound (the "
               f"card's float index_add_ adds in no fixed order)"))
        ms = median(timing.cuda_time_ms(lambda: rst.sql(text, loaded, **kw).collect(), runs=5))
        log(f"13d {s} TPC-H {q} over the loaded SF1 tables: {ms:.3f} ms (median of 5), "
            f"{len(a[next(iter(a))])} rows")
    del loaded, direct

    # encode (np.unique) and the native merge against numpy
    comments = data["lineitem"]["l_comment"][1]
    t1 = time.perf_counter()
    codes, vocab = rst.strings.encode(comments)
    enc = time.perf_counter() - t1
    nv, inv = np.unique(comments, return_inverse=True)
    check(nv[0] != "" and vocab[0] == "" and np.array_equal(vocab[1:], nv)
          and np.array_equal(codes, inv + 1), "13d: strings.encode differs from np.unique")
    other = rst.strings.encode(data["orders"]["o_comment"][1])[1]
    t1 = time.perf_counter()
    union, ra, rb = rst.strings.unify(vocab, other)
    uni = time.perf_counter() - t1
    t1 = time.perf_counter()
    want_u = np.union1d(vocab, other)
    npu2 = time.perf_counter() - t1
    check(np.array_equal(union, want_u) and np.array_equal(ra, np.searchsorted(want_u, vocab))
          and np.array_equal(rb, np.searchsorted(want_u, other)),
          "13d: strings.unify differs from np.union1d")
    log(f"13d strings.encode of l_comment ({comments.shape[0]:,} rows, {vocab.shape[0] - 1:,} "
        f"distinct): {enc:.2f} s (np.unique), equal; strings.unify of the "
        f"l_comment and o_comment vocabularies ({vocab.shape[0]:,} + {other.shape[0]:,} -> "
        f"{union.shape[0]:,}): {uni:.2f} s native (np.union1d {npu2:.2f} s), equal")
    # the native intern beside np.unique on a column of few distinct values
    modes = data["lineitem"]["l_shipmode"][1]
    t1 = time.perf_counter()
    codes0, firsts = csvio.intern_rows(modes)
    nat = time.perf_counter() - t1
    t1 = time.perf_counter()
    nv = np.unique(modes)
    npu = time.perf_counter() - t1
    check(sorted(modes[firsts].tolist()) == nv.tolist()
          and np.array_equal(modes[firsts][codes0], modes),
          "13d: csvio.intern_rows differs from np.unique")
    log(f"13d csvio.intern_rows of l_shipmode ({modes.shape[0]:,} rows, {nv.shape[0]} distinct): "
        f"{nat:.2f} s native, np.unique {npu:.2f} s, the same values")
    del data, comments, codes, vocab, inv, nv, other, union, want_u, modes, codes0, firsts

    # the native host sort beside the card's torch.sort on the same rows
    rng = np.random.default_rng(SEED)
    hk = rng.integers(0, 2**64, HOST_SORT_ROWS, dtype=np.uint64)
    hv = rng.integers(0, 2**64, HOST_SORT_ROWS, dtype=np.uint64)
    t1 = time.perf_counter()
    sk, sv = native.host_sort_pairs(hk, hv)
    hs = time.perf_counter() - t1
    perm = np.argsort(hk, kind="stable")
    check(np.array_equal(sk, hk[perm]) and np.array_equal(sv, hv[perm]),
          "13d: host_sort_pairs differs from numpy's stable argsort")
    del perm, sk, sv
    dk = keys.encode(torch.from_numpy(hk.view(np.int64)).to(DEV).view(torch.uint64))
    dv = torch.from_numpy(hv.view(np.int64)).to(DEV)

    def card():
        s = torch.sort(dk, stable=True)
        return s.values, dv[s.indices]

    ms = median(timing.cuda_time_ms(card, runs=5))
    log(f"13d native.host_sort_pairs of {HOST_SORT_ROWS:,} uniform (u64,u64) rows: {hs:.3f} s "
        f"on {nhost.num_threads()} host threads, equal to numpy's stable argsort; the card's "
        f"stable torch.sort + payload gather of the same rows: {ms:.3f} ms")


def _oracle_query(t_keys, t_amounts, a_keys, a_tier, thr):
    keep = t_amounts > thr
    tk, ta = t_keys[keep], t_amounts[keep]
    mask = np.isin(tk, a_keys[a_tier == 1])
    tk, ta = tk[mask], ta[mask]
    ref_keys, inv = np.unique(tk, return_inverse=True)
    return ref_keys, np.bincount(inv, weights=ta).astype(np.int64) & 0xFFFFFFFF


def _host(x, num):
    return (_bits(x).to(torch.int64) & 0xFFFFFFFF if x.dtype == torch.uint32
            else x.to(torch.int64))[:num].cpu().numpy()


def _example(name, call, k1, k2, re):
    """One example's run on the card: ``call()``'s result, its K1, K2 and
    run-ends launches recorded (name -> call for k1_against_plain and
    run_ends_at_shapes, name -> (call, launches) for k2_at_shapes)."""
    b1, b2, b3 = extract.LAUNCHES, expand.LAUNCHES, run_ends.LAUNCHES
    out = call()
    torch.cuda.synchronize()
    if extract.LAUNCHES > b1:
        k1[name] = call
    if expand.LAUNCHES > b2:
        k2[name] = (call, expand.LAUNCHES - b2)
    if run_ends.LAUNCHES > b3:
        re[name] = call
    log(f"13e {name}: K1 launches {extract.LAUNCHES - b1}, K2 launches {expand.LAUNCHES - b2}, "
        f"run-ends launches {run_ends.LAUNCHES - b3}")
    return out


def examples_path():
    """13e: the three examples at their default sizes on the card, each held
    to the numpy oracle of tests/test_examples.py, then each example's own
    main. Returns (K1, K2 and run-ends workloads) as _example records them."""
    k1, k2, re = {}, {}, {}
    rng = np.random.default_rng(SEED)
    dev = lambda a: torch.from_numpy(a.view(np.int32)).to(DEV).view(torch.uint32)  # noqa: E731
    n, n_acc = 1 << 20, 1 << 12
    t_keys = rng.integers(0, n_acc, n).astype(np.uint32)
    t_amounts = rng.integers(0, 1 << 16, n).astype(np.uint32)
    a_keys = np.arange(n_acc, dtype=np.uint32)
    a_tier = rng.integers(0, 3, n_acc).astype(np.uint32)
    q_args = (dev(t_keys), dev(t_amounts), dev(a_keys), dev(a_tier), 1 << 14)
    uk, sums, ng, ovf = _example("ex-query_demo", lambda: ex_query.build_query(
        n_acc, join_capacity=int(n * 1.1))(*q_args), k1, k2, re)
    ref_k, ref_s = _oracle_query(t_keys, t_amounts, a_keys, a_tier, 1 << 14)
    ng = int(ng)
    check(not bool(ovf) and ng == ref_k.shape[0] and np.array_equal(_host(uk, ng), ref_k)
          and np.array_equal(_host(sums, ng) & 0xFFFFFFFF, ref_s),
          "13e: query_demo differs from its oracle")
    log(f"13e query_demo: {n:,} rows -> {ng} groups, equal to the numpy oracle")

    n, n_q, n_sym = 100_000, 100_000 // 16, 64
    sym = rng.integers(0, n_sym, n).astype(np.uint32)
    qty = rng.integers(1, 500, n).astype(np.uint32)
    ts = np.sort(rng.integers(0, 1 << 30, n).astype(np.uint32))
    q_ts = rng.integers(0, 1 << 30, n_q).astype(np.uint32)
    q_px = rng.integers(90, 110, n_q).astype(np.uint32)
    t_args = tuple(map(dev, (sym, qty, ts, q_ts, q_px)))
    s, cnt, notional, num = _example(
        "ex-table_demo", lambda: ex_table.build_pipeline(min_qty=250)(*t_args), k1, k2, re)
    num = int(num)
    keep = qty > 250
    ks, kq, kt = sym[keep], qty[keep], ts[keep]
    order = np.argsort(q_ts, kind="stable")
    hi = np.searchsorted(q_ts[order], kt, side="right")
    px = np.where(hi > 0, q_px[order][np.clip(hi - 1, 0, None)], 0).astype(np.uint32)
    notl = (kq * px).astype(np.uint32)
    ref = sorted((int(u), int((ks == u).sum()), int(np.sum(notl[ks == u], dtype=np.uint32)))
                 for u in np.unique(ks))
    got = sorted(zip(_host(s, num).tolist(), _host(cnt, num).tolist(),
                     _host(notional, num).tolist()))
    check(num == len(ref) and got == ref and list(_host(notional, num)) == sorted(
        (r[2] for r in ref), reverse=True), "13e: table_demo differs from its oracle")
    log(f"13e table_demo: {n:,} trades x {n_q:,} quotes -> {num} symbols, equal to the oracle")

    n, n_sym, min_qty = 1 << 18, 64, 100
    sym = rng.integers(0, n_sym, n).astype(np.uint32)
    qty = rng.integers(1, 1000, n).astype(np.uint32)
    ts = rng.integers(0, 1 << 30, n).astype(np.uint32)
    mesh = rdist.data_mesh(D_SHARDS, device=DEV)
    d_args = (dev(sym), dev(qty), dev(ts))
    s, cnt, vol, peak, num = _example("ex-dist_table_demo", lambda: ex_dist.build_pipeline(
        mesh, min_qty, n_sym * 2)(*d_args), k1, k2, re)
    num = int(num) if num is not None else s.shape[0]
    keep = qty > min_qty
    ks, kq, kt = sym[keep], qty[keep], ts[keep]
    refs = []
    for u in np.unique(ks):
        g = kq[ks == u]
        o = np.argsort(kt[ks == u], kind="stable")
        refs.append((int(u), len(g), int(g.sum()), int(np.max(np.cumsum(g[o])))))
    got = sorted(zip(_host(s, num).tolist(), _host(cnt, num).tolist(),
                     _host(vol, num).tolist(), _host(peak, num).tolist()))
    check(num == len(refs) and got == sorted(refs) and list(_host(vol, num)) == sorted(
        (r[2] for r in refs), reverse=True), "13e: dist_table_demo differs from its oracle")
    log(f"13e dist_table_demo: {n:,} trades on {mesh.size} slots -> {num} symbols, equal to "
        f"the oracle")
    for ex in (ex_query, ex_table, ex_dist):
        ex.main(["--device", DEV])
    return k1, k2, re


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")
    log("card:", card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(["extract", "expand", "run_ends", "segment_sum"])  # one nvcc each, together
    extract._kernel()
    expand._kernel()
    run_ends._kernel()
    segment_sum._kernel()
    log(f"kernel builds + load: {time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{k} {v:.2f} s" for k, v in _build.BUILD_SECONDS.items()) + ")")
    for name in ("extract", "expand", "run_ends", "segment_sum"):
        for line in _build.LOG.get(name, "").splitlines():
            if "Used" in line:
                log(f"  ptxas {name}:", line.strip())

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    err = check_kernel(rng, gen)

    extract.LAUNCHES = 0
    main_path(gen)
    k1_launches = extract.LAUNCHES
    check(k1_launches > 0, "the sort path never launched the extract kernel")
    log(f"sort path: extract kernel calls {k1_launches}")

    k1_ms, k1_plain, k1_bound, err2 = kernel_at_main_shapes(gen)

    k2_err = check_expand_kernel(rng, gen)

    expand.LAUNCHES = run_ends.LAUNCHES = 0
    work = join_path(gen)
    k2_launches, re_join = expand.LAUNCHES, run_ends.LAUNCHES
    check(k2_launches > 0, "the join path never launched the expand kernel")
    check(re_join > 0, "the join path never launched the run-ends kernel")
    log(f"join path: expand kernel calls {k2_launches}, run-ends kernel calls {re_join}")

    time_join_path(work)
    k2_rows, k2_err2 = k2_at_shapes({label.split()[0]: (call, 1)
                                     for label, (call, *_) in work.items()})
    re_join_rows = run_ends_at_shapes("join", {label.split()[0]: call
                                               for label, (call, *_) in work.items()})
    del work
    profile_wrappers(gen)

    # GROUP BY and ORDER BY at TPC-H SF10 (phase 8)
    t = tpch_sf10(gen)
    log(f"TPC-H SF10 for GROUP BY / ORDER BY: {t['l_orderkey'].shape[0]:,} lineitems, "
        f"{t['o_orderkey'].shape[0]:,} orders, {t['p_brand'].shape[0]:,} parts, "
        f"{t['ps_partkey'].shape[0]:,} partsupp rows")
    segment_sum.LAUNCHES = 0
    agg_work = groupby_path(t)
    ss_groupby = segment_sum.LAUNCHES
    check(ss_groupby > 0, "the GROUP BY path never launched the segmented-sum kernel")
    log(f"GROUP BY path: segmented-sum kernel calls {ss_groupby}")
    time_workloads(agg_work)
    del agg_work
    ss_rows = ss_at_shapes(t, gen)
    extract.LAUNCHES = 0
    ob_work = orderby_path(t, gen)
    k1_orderby = extract.LAUNCHES
    check(k1_orderby > 0, "the ORDER BY path never launched the extract kernel")
    log(f"ORDER BY path: extract kernel calls {k1_orderby}")
    time_workloads(ob_work)
    k1_ob, k1_ob_err = {}, 0
    for label, (call, _) in ob_work.items():
        name = label.split()[0]
        k1_ob[name], e = k1_against_plain(record_k1(call), name)
        k1_ob_err = max(k1_ob_err, e)
    del ob_work, t

    # the relational facade at TPC-H SF10 (phase 9)
    expand.LAUNCHES = run_ends.LAUNCHES = segment_sum.LAUNCHES = 0
    table_work, table_k2 = table_path(gen)
    k2_table, re_table, ss_table = expand.LAUNCHES, run_ends.LAUNCHES, segment_sum.LAUNCHES
    check(k2_table > 0, "the Table path never launched the expand kernel")
    check(re_table > 0, "the Table path never launched the run-ends kernel")
    check(ss_table > 0, "the Table path never launched the segmented-sum kernel")
    log(f"Table path: expand kernel calls {k2_table}, run-ends kernel calls {re_table}, "
        f"segmented-sum kernel calls {ss_table}")
    time_workloads(table_work)
    k2_table_rows, k2_err3 = k2_at_shapes(table_k2)
    re_table_rows = run_ends_at_shapes("table", {label.split()[0]: call
                                                 for label, (call, _) in table_work.items()})
    del table_work, table_k2

    # the SQL path at TPC-H SF10 (phase 10)
    expand.LAUNCHES = run_ends.LAUNCHES = segment_sum.LAUNCHES = 0
    sql_work, sql_k2 = sql_path(gen)
    k2_sql, re_sql, ss_sql = expand.LAUNCHES, run_ends.LAUNCHES, segment_sum.LAUNCHES
    check(k2_sql > 0, "the SQL path never launched the expand kernel")
    check(re_sql > 0, "the SQL path never launched the run-ends kernel")
    check(ss_sql > 0, "the SQL path never launched the segmented-sum kernel")
    log(f"SQL path: expand kernel calls {k2_sql}, run-ends kernel calls {re_sql}, "
        f"segmented-sum kernel calls {ss_sql}")
    time_workloads(sql_work)
    k2_sql_rows, k2_err4 = k2_at_shapes(sql_k2)
    re_sql_rows = run_ends_at_shapes("sql", {label.split()[0]: call
                                             for label, (call, _) in sql_work.items()},
                                     every=True)
    del sql_work, sql_k2

    # the distributed layer on a 4-slot mesh on one card (phase 11)
    torch.cuda.empty_cache()
    expand.LAUNCHES = 0  # each distributed call's launches are read around it
    (dist_k2, k2_dist, dist_joins, re_dist, ss_dist), mr_dist = merges_of(
        "distributed", lambda: distributed_path(gen))
    check(mr_dist > 0, "the distributed path never launched the merge kernel")
    check(k2_dist > 0, "the distributed path never launched the expand kernel")
    check(re_dist > 0, "the distributed path never launched the run-ends kernel")
    check(ss_dist > 0, "the distributed path never launched the segmented-sum kernel")
    log(f"distributed path: expand kernel calls {k2_dist}, run-ends kernel calls {re_dist}, "
        f"segmented-sum kernel calls {ss_dist}")
    k2_dist_rows, k2_err5 = k2_at_shapes(dist_k2)
    re_dist_rows = run_ends_at_shapes("dist", dist_joins)
    del dist_k2, dist_joins
    torch.cuda.empty_cache()
    mr_row = merge_at_cell_size(gen)

    # DistTable on the 4-slot mesh at TPC-H SF10 (phase 12)
    torch.cuda.empty_cache()
    expand.LAUNCHES = 0  # each DistTable call's launches are read around it
    segment_sum.LAUNCHES = 0
    (dt_work, dt_k2, k2_dt, re_dt), mr_dt = merges_of("DistTable",
                                                      lambda: dist_table_path(gen))
    ss_dt = segment_sum.LAUNCHES
    check(k2_dt > 0, "the DistTable path never launched the expand kernel")
    check(re_dt > 0, "the DistTable path never launched the run-ends kernel")
    check(ss_dt > 0, "the DistTable path never launched the segmented-sum kernel")
    log(f"DistTable path: expand kernel calls {k2_dt}, run-ends kernel calls {re_dt}, "
        f"segmented-sum kernel calls {ss_dt}")
    time_dist(dt_work, MUST_EXCHANGE_DT)
    re_dt_rows = run_ends_at_shapes("dist_table", {label.split()[0]: call
                                                   for label, (call, *_) in dt_work.items()})
    del dt_work
    k2_dt_rows, k2_err6 = k2_at_shapes(dt_k2)
    del dt_k2

    # the demo CLI, datasets, suites, an SF1 CSV load and the examples (phase 13)
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    k1_demo, k1_demo_rows, k1_err3 = demo_sweep(gen)
    torch.cuda.empty_cache()
    demo_datasets()
    segment_sum.LAUNCHES = 0
    k2_demo, demo_k2, re_demo, demo_re = demo_suites()
    ss_demo = segment_sum.LAUNCHES
    check(ss_demo > 0, "the demo's suites never launched the segmented-sum kernel")
    log(f"13c: segmented-sum kernel calls {ss_demo}")
    k2_demo_rows, k2_err7 = k2_at_shapes(demo_k2)
    re_demo_rows = run_ends_at_shapes("demo", demo_re)
    del demo_k2, demo_re
    torch.cuda.empty_cache()
    sf1_load()
    extract.LAUNCHES = expand.LAUNCHES = run_ends.LAUNCHES = segment_sum.LAUNCHES = 0
    ex_k1, ex_k2, ex_re = examples_path()
    k1_examples, k2_examples, re_examples = extract.LAUNCHES, expand.LAUNCHES, run_ends.LAUNCHES
    ss_examples = segment_sum.LAUNCHES
    check(k2_examples > 0, "the examples never launched the expand kernel")
    check(re_examples > 0, "the examples never launched the run-ends kernel")
    log(f"examples path: extract kernel calls {k1_examples}, expand kernel calls {k2_examples}, "
        f"run-ends kernel calls {re_examples}, segmented-sum kernel calls {ss_examples}")
    k1_ex_rows, k1_err4 = {}, 0
    for name, call in ex_k1.items():
        k1_ex_rows[name], e = k1_against_plain(record_k1(call), name)
        k1_err4 = max(k1_err4, e)
    k2_ex_rows, k2_err8 = k2_at_shapes(ex_k2)
    re_ex_rows = run_ends_at_shapes("examples", ex_re)
    del ex_k1, ex_k2, ex_re
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")
    r_row = next(r for r in k2_rows if r["shape"] == "R")
    re_by_path = {"join": re_join, "table": re_table, "sql": re_sql, "dist": re_dist,
                  "dist_table": re_dt, "demo": re_demo, "examples": re_examples}
    ss_by_path = {"groupby": ss_groupby, "table": ss_table, "sql": ss_sql, "dist": ss_dist,
                  "dist_table": ss_dt, "demo": ss_demo, "examples": ss_examples}
    re_rows = (re_join_rows + re_table_rows + re_sql_rows + re_dist_rows + re_dt_rows
               + re_demo_rows + re_ex_rows)
    re_big = max(re_rows, key=lambda r: r["rows"])
    print(json.dumps({"kernels": [{
        "name": "bucket_extract",
        "route": "cuda",
        "source": "radix_sort_tpu_torch/csrc/extract.cu",
        "replaces": "radix_sort_tpu/ops/extract.py:310",
        "launches": k1_launches + k1_orderby + k1_demo + k1_examples,
        "launches_by_path": {"sort": k1_launches, "order_by": k1_orderby, "demo": k1_demo,
                             "examples": k1_examples},
        "max_abs_err": max(err, err2, k1_ob_err, k1_err3, k1_err4),
        "ms": k1_ms,
        "plain_ms": k1_plain,
        "bound_ms": k1_bound,
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes a stable multi-region run scatter
        "shape": f"the calls of one {MAIN_ROWS[0]:,}-row (u64,u64) sort, summed",
        "order_by": k1_ob,  # the calls of one O1 / O2 call, summed, same keys
        "demo": k1_demo_rows,  # the calls of one demo (u32,u32) sort, summed, same keys
        "examples": k1_ex_rows,  # the calls of one example's run, summed, same keys
    }, {
        "name": "expand_join_runs",
        "route": "cuda",
        "source": "radix_sort_tpu_torch/csrc/expand.cu",
        "replaces": "radix_sort_tpu/ops/expand.py:330",
        "launches": k2_launches + k2_table + k2_sql + k2_dist + k2_dt + k2_demo + k2_examples,
        "launches_by_path": {"join": k2_launches, "table": k2_table, "sql": k2_sql,
                             "dist": k2_dist, "dist_table": k2_dt, "demo": k2_demo,
                             "examples": k2_examples},
        "max_abs_err": max(k2_err, k2_err2, k2_err3, k2_err4, k2_err5, k2_err6, k2_err7,
                           k2_err8),
        "ms": r_row["ms"],
        "plain_ms": r_row["plain_ms"],
        "bound_ms": r_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": r_row["library_ms"],
        "shape": "R: the repeat call, one i32 column (torch.repeat_interleave computes "
                 "the same); every shape in calls",
        "calls": (k2_rows + k2_table_rows + k2_sql_rows + k2_dist_rows + k2_dt_rows
                  + k2_demo_rows + k2_ex_rows),
    }, {
        "name": "run_end_values",
        "route": "cuda",
        "source": "radix_sort_tpu_torch/csrc/run_ends.cu",
        "replaces": None,  # the JAX package's reversed running min is an XLA scan
        "launches": sum(re_by_path.values()),
        "launches_by_path": re_by_path,
        "ms": re_big["ms"],
        "plain_ms": re_big["plain_ms"],
        "bound_ms": re_big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": re_big["library_ms"],  # zeros + scatter_reduce_ amax, as replaced
        "shape": f"{re_big['shape']}: the largest union; every SQL union and each other "
                 "path's largest in calls",
        "calls": re_rows,
    }, {
        "name": "merge_sorted_runs",
        "route": "cuda",
        "source": "radix_sort_tpu_torch/csrc/merge_runs.cu",
        "replaces": None,  # the JAX package sorts the received runs again with lax.sort
        "launches": mr_dist + mr_dt,
        "launches_by_path": {"dist": mr_dist, "dist_table": mr_dt},
        "ms": mr_row["ms"],
        "plain_ms": mr_row["plain_ms"],
        "bound_ms": mr_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mr_row["library_ms"],  # stable torch.sort + gather, never called
        "shape": mr_row["shape"],
    }, {
        "name": "segment_sum_sorted",
        "route": "cuda",
        "source": "radix_sort_tpu_torch/csrc/segment_sum.cu",
        "replaces": None,  # the JAX package's segment_sum is a scatter XLA emits
        "launches": sum(ss_by_path.values()),
        "launches_by_path": ss_by_path,
        "ms": sum(r["ms"] for r in ss_rows[:5]),
        "plain_ms": sum(r["plain_ms"] for r in ss_rows[:5]),
        "bound_ms": sum(r["bound_ms"] for r in ss_rows[:5]),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in ss_rows[:5]),  # index_add_, never called
        "shape": "Q1's five float sums, summed; q4's and q10's columns in calls",
        "calls": ss_rows,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
