"""End-to-end query on the device -- the north-star operator set composed.

Counterpart of ``examples/query_demo.py``. A miniature analytics query over
synthetic data, running entirely on the card with fixed shapes + counts:

    SELECT t.key, SUM(t.amount)
    FROM transactions t JOIN accounts a ON t.key = a.key
    WHERE t.amount > THRESHOLD AND a.tier = 1
    GROUP BY t.key ORDER BY t.key

Run: python -m radix_sort_tpu_torch.examples.query_demo [--n 1048576] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch.utils import distributions as D
from radix_sort_tpu_torch.utils.timing import sync


def _u(x):
    """A uint32 tensor's values as int64 (compares and arithmetic)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _fill(x, keep, word):
    """``where(keep, x, word)`` for a uint32 tensor and a uint32 constant."""
    w = word - (1 << 32) if word >= 1 << 31 else word  # the same bits as int32
    return torch.where(keep, x.view(torch.int32), w).view(torch.uint32)


def build_query(n_accounts: int, join_capacity: int):
    def query(t_keys, t_amounts, a_keys, a_tier, threshold):
        # WHERE t.amount > threshold  (stable compaction)
        tk, ta, n_kept = rst.filter(_u(t_amounts) > int(threshold), t_keys, t_amounts)
        # WHERE a.tier = 1 on the dimension side
        ak, _, n_acc = rst.filter(_u(a_tier) == 1, a_keys, a_tier)
        # mask the dropped tails to non-matching sentinels (distinct per
        # side so sentinel never joins sentinel) before the equi-join
        tk = _fill(tk, torch.arange(tk.shape[0], device=tk.device) < n_kept, 0xFFFFFFFF)
        ak = _fill(ak, torch.arange(ak.shape[0], device=ak.device) < n_acc, 0xFFFFFFFE)
        ones = torch.ones(ak.shape, dtype=torch.int32, device=ak.device).view(torch.uint32)
        jk, ja, _, n_pairs, overflow = rst.hash_join(tk, ta, ak, ones, capacity=join_capacity)
        # mask out slots beyond the valid pair count before aggregating
        valid = torch.arange(join_capacity, device=jk.device) < n_pairs
        jk = _fill(jk, valid, 0xFFFFFFFF)
        ja = _fill(ja, valid, 0)
        # GROUP BY key, SUM(amount) -- ascending key order by construction
        uk, sums, n_groups = rst.hash_aggregate(jk, ja, "sum")
        # the masked slots form one junk group at key 0xFFFFFFFF (dropped
        # via n_groups - 1 when any slot was masked)
        junk = torch.any(~valid)
        return uk, sums, n_groups - junk.to(n_groups.dtype), overflow

    return query


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20, help="transaction rows")
    ap.add_argument("--accounts", type=int, default=1 << 12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    gen = torch.Generator(device=args.device).manual_seed(0)
    # skewed transaction keys (Zipf over the account range), uniform amounts
    t_keys = (_u(D.zipf(gen, args.n, torch.uint32)) % args.accounts).to(torch.int32).view(torch.uint32)
    t_amounts = (_u(D.key_uniform(gen, args.n, torch.uint32)) >> 16).to(torch.int32).view(torch.uint32)
    a_keys = torch.arange(args.accounts, dtype=torch.int32, device=args.device).view(torch.uint32)
    a_tier = torch.randint(0, 3, (args.accounts,), generator=gen, device=args.device,
                           dtype=torch.int32).view(torch.uint32)
    threshold = 1 << 14

    q = build_query(args.accounts, join_capacity=int(args.n * 1.1))
    sync(q(t_keys, t_amounts, a_keys, a_tier, threshold))  # warm up
    t0 = time.perf_counter()
    uk, sums, n_groups, overflow = sync(q(t_keys, t_amounts, a_keys, a_tier, threshold))
    dt = time.perf_counter() - t0
    n_groups = int(n_groups)
    print(f"query over {args.n} rows in {dt*1e3:.1f} ms -> {n_groups} groups"
          f" (overflow={bool(overflow)})")
    print("first groups:", _u(uk)[:5].tolist(), _u(sums)[:5].tolist())


if __name__ == "__main__":
    main()
