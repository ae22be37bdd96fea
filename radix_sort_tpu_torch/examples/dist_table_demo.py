"""DistTable analytics pipeline -- the sharded relation API composed end to end.

Counterpart of ``examples/dist_table_demo.py``: trades are row-sharded over
the slots of a mesh, and every verb runs as its distributed plan
(splitter-sampled exchanges, carry-chain windows, two-phase aggregation):

    SELECT sym, COUNT(*) AS n, SUM(qty) AS volume, MAX(run) AS peak_run
    FROM (SELECT *, SUM(qty) OVER (PARTITION BY sym ORDER BY ts) AS run
          FROM trades WHERE qty > MIN_QTY)
    GROUP BY sym ORDER BY volume DESC LIMIT 5

Run (4 slots on the current card, or on the CPU with --device cpu):

    python -m radix_sort_tpu_torch.examples.dist_table_demo [--n 262144]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch.parallel import runtime
from radix_sort_tpu_torch.utils.timing import sync


def build_pipeline(mesh, min_qty: int, max_groups: int):
    def run(sym, qty, ts):
        dt = rst.DistTable({"sym": sym, "qty": qty, "ts": ts}, mesh)
        dt = dt.filter(rst.col("qty") > min_qty)
        dt = dt.window({"run": ("cumsum", "qty")}, partition_by="sym", order_by="ts")
        agg = dt.aggregate(
            "sym",
            {"n": "count", "volume": ("sum", "qty"), "peak_run": ("max", "run")},
            max_groups=max_groups,
        ).sort_by("volume", descending=True)
        return agg["sym"], agg["n"], agg["volume"], agg["peak_run"], agg.count

    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--symbols", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")

    mesh = runtime.data_mesh(4, device=args.device)
    n = -(-args.n // mesh.size) * mesh.size
    rng = np.random.default_rng(0)
    cols = [rng.integers(0, args.symbols, n).astype(np.uint32),
            rng.integers(1, 1000, n).astype(np.uint32),
            rng.integers(0, 1 << 30, n).astype(np.uint32)]
    sym, qty, ts = (torch.from_numpy(c.view(np.int32)).to(mesh.home).view(torch.uint32)
                    for c in cols)

    run = build_pipeline(mesh, min_qty=100, max_groups=args.symbols * 2)
    sync(run(sym, qty, ts))  # warm up
    t0 = time.perf_counter()
    s, cnt, vol, peak, num = sync(run(sym, qty, ts))
    dt_s = time.perf_counter() - t0
    num = int(num) if num is not None else s.shape[0]
    s, cnt, vol, peak = (x.view(torch.int32).to(torch.int64).cpu() & 0xFFFFFFFF
                         if x.dtype == torch.uint32 else x.cpu() for x in (s, cnt, vol, peak))
    print(f"{n:,} trades over {mesh.size} slots -> {num} symbols in {dt_s*1e3:.1f} ms")
    for i in range(min(5, num)):
        print(f"  sym {int(s[i]):4d}  n={int(cnt[i]):7,d}  "
              f"volume={int(vol[i]):12,d}  peak_run={int(peak[i]):12,d}")


if __name__ == "__main__":
    main()
