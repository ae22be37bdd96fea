"""Table-facade analytics pipeline -- the relation API composed end to end.

Counterpart of ``examples/table_demo.py``. A miniature market-data query on
the card:

    -- enrich each trade with the latest quote at or before it (ASOF JOIN),
    -- then aggregate per symbol and rank by notional
    SELECT symbol, COUNT(*), SUM(qty * px) AS notional
    FROM trades ASOF JOIN quotes ON trades.ts >= quotes.ts
    WHERE qty > MIN_QTY
    GROUP BY symbol ORDER BY notional DESC

Run: python -m radix_sort_tpu_torch.examples.table_demo [--n 100000] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch.utils.timing import sync


def build_pipeline(min_qty: int):
    def run(sym, qty, ts, q_ts, q_px):
        t = rst.Table({"sym": sym, "qty": qty, "ts": ts}, device=sym.device)
        t = t.filter(rst.col("qty") > min_qty)
        # ASOF JOIN: latest quote at-or-before each trade (padding rows get
        # garbage quotes, but they sit beyond t.count and every downstream
        # op is validity-aware)
        px, _, _ = rst.join_asof(t["ts"], q_ts, q_px, direction="backward")
        t = t.with_columns(px=px).with_columns(notional=rst.col("qty") * rst.col("px"))
        agg = t.aggregate(
            "sym", {"n": "count", "notional": ("sum", "notional")}
        ).sort_by("notional", descending=True)
        return agg["sym"], agg["n"], agg["notional"], agg.count

    return run


def _dev(a, device):
    return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--symbols", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    rng = np.random.default_rng(0)
    n, n_q = args.n, max(args.n // 16, 1)
    sym = rng.integers(0, args.symbols, n).astype(np.uint32)
    qty = rng.integers(1, 500, n).astype(np.uint32)
    ts = np.sort(rng.integers(0, 1 << 30, n).astype(np.uint32))
    q_ts = rng.integers(0, 1 << 30, n_q).astype(np.uint32)
    q_px = rng.integers(90, 110, n_q).astype(np.uint32)

    run = build_pipeline(min_qty=250)
    args_dev = tuple(_dev(a, args.device) for a in (sym, qty, ts, q_ts, q_px))
    sync(run(*args_dev))  # warm up
    t0 = time.perf_counter()
    s, cnt, notional, num = sync(run(*args_dev))
    dt = time.perf_counter() - t0
    num = int(num) if num is not None else s.shape[0]
    s, cnt, notional = (x.view(torch.int32).to(torch.int64).cpu() & 0xFFFFFFFF
                        if x.dtype == torch.uint32 else x.cpu() for x in (s, cnt, notional))
    print(f"{n:,} trades x {n_q:,} quotes in {dt*1e3:.1f} ms "
          f"({num} symbols); top 5 by notional:")
    for i in range(min(5, num)):
        print(f"  sym {int(s[i]):4d}  trades {int(cnt[i]):7,d}  notional {int(notional[i]):14,d}")


if __name__ == "__main__":
    main()
