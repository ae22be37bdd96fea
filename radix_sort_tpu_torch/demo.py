"""Benchmark demo CLI -- the reference's `cargo run -r` path on the GPU.

Counterpart of ``radix_sort_tpu/demo.py``, with its flags and printed lines.
Reproduces the measurement protocols of src/main.rs:

  - main.rs:101-127 (main): a GB sweep per row type; fresh rows per run;
    mean wall-clock per size. Extras: selectable distribution, keys/s and
    GB/s columns.
  - main.rs:36-45 (bench_sorts): SEVERAL engines timed on the SAME rows --
    `--engines comparator pallas` prints them side by side.
  - main.rs:47-81 (bench_sorts_data) + main.rs:83-99 (gen_data): persist a
    dataset once (`--gen-data file.raw --n ...`), bench it repeatedly and
    bit-identically (`--data file.raw`).

Every time is a host wall time of work that ends in a device
synchronisation. Everything runs on the GPU unless `--device cpu` is given;
without a GPU the demo refuses to run on it.

Run:  python -m radix_sort_tpu_torch.demo --sizes 0.5 1.0 --dtypes u32 u64 --runs 5
      python -m radix_sort_tpu_torch.demo --gen-data /tmp/d.raw --n 1e8 --dist zipf
      python -m radix_sort_tpu_torch.demo --data /tmp/d.raw --engines comparator pallas
      python -m radix_sort_tpu_torch.demo --suite queries --ops-n 65536 --device cpu

The queries and ops suites keep each workload as a builder
``(n, seed, device) -> (fn, args)`` (``QUERIES``, ``OPS``), so the same
workload can be run elsewhere and compared; the rows come from
``np.random.default_rng(seed)`` drawn exactly as the JAX demo draws them.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

import radix_sort_tpu_torch as rst
from radix_sort_tpu_torch import dates as DT
from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import pallas_sort
from radix_sort_tpu_torch.sql import sql
from radix_sort_tpu_torch.table import Table
from radix_sort_tpu_torch.utils import distributions as D
from radix_sort_tpu_torch.utils import io


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument(
        "--sizes", type=float, nargs="+",
        default=[0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
        help="data sizes in GB (element count = GB*1e9/rowbytes, main.rs:24)",
    )
    p.add_argument("--dtypes", nargs="+", default=["u32", "u64"],
                   choices=["u32", "u64"], help="key/payload word width")
    p.add_argument("--runs", type=int, default=5, help="runs per size (main.rs:102)")
    p.add_argument("--dist", default="uniform",
                   choices=["uniform", "zipf", "geometric", "step_uniform"])
    p.add_argument("--zipf-s", type=float, default=1.1)
    p.add_argument("--steps", type=int, default=1000,
                   help="distinct values for step_uniform")
    p.add_argument("--implementation", default=None,
                   help="single engine (legacy alias for --engines X)")
    p.add_argument("--engines", nargs="+", default=None,
                   help="engines timed side by side on the same rows "
                        "(main.rs:36-42), e.g. comparator pallas")
    p.add_argument("--data", default=None, metavar="FILE.raw",
                   help="bench keys from a persisted dataset "
                        "(utils.io.read_raw; main.rs:47-81)")
    p.add_argument("--gen-data", default=None, metavar="FILE.raw",
                   help="generate+persist a dataset, then exit (main.rs:83-99)")
    p.add_argument("--n", type=float, default=None,
                   help="element count for --gen-data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--suite", default="sort",
                   choices=["sort", "ops", "queries"],
                   help="sort = the reference GB sweep (default); ops = "
                        "query-operator throughputs (window / rolling / "
                        "asof join / holistic aggregates / hash join) at "
                        "--ops-n rows; queries = end-to-end SQL analytics "
                        "(TPC-H-shaped Q1/Q3/window) through the planner")
    p.add_argument("--ops-n", type=float, default=float(1 << 24),
                   help="row count for --suite ops and --suite queries")
    p.add_argument("--groups", type=float, default=float(1 << 20),
                   help="group/partition count for --suite ops")
    p.add_argument("--device", default="cuda",
                   help="where the rows live and the work runs (default cuda)")
    return p.parse_args(argv)


def _device(name):
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to run on the CPU")
    return dev


def _wait(dev):
    """Wait for the device's queued work (the sync every timing ends in)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _gen_keys(gen, n, dtype, args):
    if args.dist == "uniform":
        return D.key_uniform(gen, n, dtype)
    if args.dist == "zipf":
        return D.zipf(gen, n, dtype, s=args.zipf_s)
    if args.dist == "geometric":
        return D.geometric(gen, n, dtype=dtype)
    return D.step_uniform(gen, n, args.steps, dtype)


def _gen_limbs(gen, n, args):
    if args.dist == "uniform":
        return D.key_uniform_limbs(gen, n)
    if args.dist == "zipf":
        return D.zipf_limbs(gen, n, s=args.zipf_s)
    if args.dist == "geometric":
        return D.geometric_limbs(gen, n)
    return D.step_uniform_limbs(gen, n, args.steps)


def _engine_fns(dt_name, engines):
    """One rows -> sorted-rows function per engine name. u64 rows are
    (key hi, key lo, payload hi, payload lo) int32 rank limbs, sorted by
    ``sort_pairs_limbs``; u32 rows are (key, payload) uint32 tensors, sorted
    by ``sort_pairs``."""
    fns = {}
    for eng in engines:
        if dt_name == "u64":
            # "auto" passes through so sort_pairs_limbs resolves it from the
            # active config's default engine
            limb_eng = {"pallas": "sample", "comparator": "comparator",
                        "auto": "auto"}.get(eng)
            if limb_eng is None:
                raise SystemExit(f"u64 rows support comparator/pallas, not {eng!r}")
            fns[eng] = functools.partial(_sort_limb_rows, engine=limb_eng)
        else:
            fns[eng] = functools.partial(_sort_u32_rows, implementation=eng)
    return fns


def _sort_limb_rows(rows, engine):
    return pallas_sort.sort_pairs_limbs(*rows, engine=engine)


def _sort_u32_rows(rows, implementation):
    return rst.sort_pairs(rows[0], rows[1], implementation=implementation)


def _zero_payload(keys):
    """The reference's tuple rows carry a zero payload (distr.rs:47-51):
    as u64 rank limbs, the limbs of 0."""
    return torch.full_like(keys, -(1 << 31))


def _make_rows(gen, n, dt_name, args):
    if dt_name == "u64":
        hi, lo = _gen_limbs(gen, n, args)
        z = _zero_payload(hi)
        return hi, lo, z, z.clone()
    return D.make_pairs(_gen_keys(gen, n, torch.uint32, args))


def _upload(host, dev):
    """A persisted key array -> device rows with zero payloads."""
    if host.dtype.itemsize == 8:
        hi, lo = K.split64(K.encode(torch.from_numpy(host.view(np.int64)).to(dev)
                                    .view(torch.uint64)))
        z = _zero_payload(hi)
        return hi, lo, z, z.clone()
    keys = torch.from_numpy(host.view(np.int32)).to(dev).view(torch.uint32)
    return D.make_pairs(keys)


# ---------------------------------------------------------------- queries


Q1_SQL = ("SELECT status, COUNT(*) AS n, SUM(qty) AS sq, "
          "SUM(price * (1 - disc)) AS rev, AVG(qty) AS aq "
          "FROM l WHERE qty < 45 GROUP BY status ORDER BY status")
Q3_SQL = ("SELECT custkey, SUM(price) AS rev FROM l "
          "JOIN c USING (custkey) WHERE mktseg = 2 "
          "GROUP BY custkey ORDER BY rev DESC LIMIT 10")
QWIN_SQL = ("SELECT custkey, price, "
            "RANK() OVER (PARTITION BY custkey ORDER BY price DESC) AS r, "
            "SUM(price) OVER (PARTITION BY custkey) AS tot "
            "FROM l")
QSUB_SQL = ("SELECT custkey FROM l WHERE qty > 40 AND custkey IN "
            "(SELECT custkey FROM c WHERE mktseg < 2)")
QDATE_SQL = ("SELECT DATE_TRUNC('month', d) AS mo, COUNT(*) AS cnt, "
             "SUM(price) AS rev FROM l "
             "WHERE d >= DATE '2025-01-01' AND d < DATE '2026-01-01' "
             "GROUP BY DATE_TRUNC('month', d) ORDER BY mo")
QROLLUP_SQL = ("SELECT status, COUNT(*) AS cnt, SUM(qty) AS s FROM l "
               "GROUP BY ROLLUP(status, YEAR(d))")
QUNION_SQL = ("SELECT status, COUNT(*) AS n FROM "
              "(SELECT status FROM l WHERE qty < 10 "
              "UNION ALL SELECT status FROM l WHERE qty >= 45) "
              "GROUP BY status ORDER BY status")
# 4 contact rows per customer: the inner join has fanout 4, so the naive
# plan materializes a 4n-row join before grouping -- the eager-aggregation
# rewrite (plan._eager_join_aggregate) never expands
QFAN_SQL = ("SELECT custkey, SUM(price) AS rev, COUNT(*) AS cnt FROM l "
            "JOIN c USING (custkey) GROUP BY custkey "
            "ORDER BY rev DESC LIMIT 10")
QSTR_SQL = ("SELECT UPPER(w) AS u, COUNT(*) AS cnt FROM l "
            "WHERE w LIKE 'w0%' AND CONTAINS(w, '1') "
            "GROUP BY UPPER(w) ORDER BY cnt DESC LIMIT 20")

N_WORDS = 1024  # the string query's vocabulary


@functools.lru_cache(maxsize=2)
def queries_data(n, seed):
    """The queries suite's rows as numpy columns, drawn from
    ``np.random.default_rng(seed)`` in the JAX demo's order: LINEITEM-like
    rows, customers, 4 contacts per customer, the string vocabulary and its
    codes. Callers must not write to the arrays."""
    rng = np.random.default_rng(seed)
    n_c = max(8, n // 16)
    d_lo, d_hi = DT.parse_date("2024-01-01"), DT.parse_date("2027-01-01")
    line = {
        "status": rng.integers(0, 8, n).astype(np.uint32),
        "qty": rng.integers(1, 51, n).astype(np.int32),
        "price": (rng.random(n) * 1000).astype(np.float32),
        "disc": (rng.random(n) * 0.1).astype(np.float32),
        "custkey": rng.integers(0, n_c, n).astype(np.uint32),
        "d": rng.integers(d_lo, d_hi, n).astype(np.int32),  # ship date, epoch days
    }
    cust = {"custkey": np.arange(n_c, dtype=np.uint32),
            "mktseg": rng.integers(0, 5, n_c).astype(np.uint32)}
    cont = {"custkey": np.repeat(np.arange(n_c, dtype=np.uint32), 4),
            "region": rng.integers(0, 5, 4 * n_c).astype(np.uint32)}
    wvocab = np.sort(np.array([f"w{i:04d}" for i in rng.permutation(N_WORDS)], dtype=np.str_))
    words = {"w": rng.integers(1, N_WORDS, n).astype(np.uint32), "qty": line["qty"]}
    return {"line": line, "cust": cust, "cont": cont, "words": words, "wvocab": wvocab}


# name -> (report label, input rows per lineitem row, SQL text,
#          {alias: (source, columns)}, keyword arguments of sql() from (n, n_c))
QUERIES = {
    "q1": ("Q1 pricing summary (filter+group+4 aggs)", 1, Q1_SQL,
           {"l": ("line", ("status", "qty", "price", "disc"))},
           lambda n, n_c: {"max_groups": 8}),
    "q3": ("Q3 revenue top-10 (join+group+topk)", 1, Q3_SQL,
           {"l": ("line", ("custkey", "price")), "c": ("cust", ("custkey", "mktseg"))},
           lambda n, n_c: {"capacity": n, "max_groups": n_c}),
    "qwin": ("window rank + partition total over 1/16 parts", 1, QWIN_SQL,
             {"l": ("line", ("custkey", "price"))}, lambda n, n_c: {}),
    "qsub": ("IN-subquery semi join (filter+semi)", 1, QSUB_SQL,
             {"l": ("line", ("custkey", "qty")), "c": ("cust", ("custkey", "mktseg"))},
             lambda n, n_c: {}),
    "qdate": ("date filter + DATE_TRUNC month group", 1, QDATE_SQL,
              {"l": ("line", ("d", "price"))}, lambda n, n_c: {"max_groups": 16}),
    "qrollup": ("ROLLUP(status, YEAR(d)) 3-level aggregate", 1, QROLLUP_SQL,
                {"l": ("line", ("status", "qty", "d"))}, lambda n, n_c: {"max_groups": 64}),
    "qunion": ("UNION ALL of two filtered scans + group", 2, QUNION_SQL,
               {"l": ("line", ("status", "qty"))}, lambda n, n_c: {"max_groups": 8}),
    "qfan": ("fanout-4 join + group (eager-agg rewrite)", 1, QFAN_SQL,
             {"l": ("line", ("custkey", "price")), "c": ("cont", ("custkey", "region"))},
             lambda n, n_c: {"capacity": 4 * n, "max_groups": n_c}),
    "qstr": ("string fns: LIKE+CONTAINS filter, UPPER group", 1, QSTR_SQL,
             {"l": ("words", ("w", "qty"))}, lambda n, n_c: {"max_groups": 2 * N_WORDS}),
}


def query_tables(name, n, seed):
    """``({alias: {column: numpy array}}, {alias: dictionaries}, sql kwargs)``
    of one queries-suite entry: the same rows for either package's Table."""
    _, _, _, tables, kw = QUERIES[name]
    data = queries_data(n, seed)
    cols = {a: {c: data[src][c] for c in names} for a, (src, names) in tables.items()}
    dicts = {a: ({"w": data["wvocab"]} if src == "words" else {})
             for a, (src, _) in tables.items()}
    return cols, dicts, kw(n, max(8, n // 16))


def build_query(name, n, seed, device):
    """(fn, args) of one queries-suite entry: ``fn(*args)`` runs its SQL over
    Tables on ``device`` and returns the collected Table."""
    text = QUERIES[name][2]
    cols, dicts, kw = query_tables(name, n, seed)
    aliases = list(cols)
    tables = tuple(Table(cols[a], dictionaries=dicts[a], device=device) for a in aliases)

    def fn(*ts):
        return sql(text, dict(zip(aliases, ts)), **kw).collect()

    return fn, tables


def _timed(fn, args, runs, dev):
    """Mean wall time of ``runs`` calls, each ending in a device sync,
    after one untimed warm-up call."""
    fn(*args)
    _wait(dev)
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn(*args)
        _wait(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.mean(ts))


def _report(name, rows, dt):
    print(f"{name:45s} {dt*1e3:9.1f} ms   {rows/dt/1e6:8.1f} M rows/s", flush=True)


def _queries_suite(args):
    """End-to-end SQL analytics throughput: TPC-H-shaped queries compiled by
    the SQL frontend onto the lazy planner."""
    dev = _device(args.device)
    n = int(args.ops_n)
    print(f"device={_device_name(dev)} lineitem={n:,} "
          f"customers={max(8, n // 16):,} runs={args.runs}", flush=True)
    for name, (label, rows, *_) in QUERIES.items():
        fn, fargs = build_query(name, n, args.seed, dev)
        _report(label, rows * n, _timed(fn, fargs, args.runs, dev))


# ---------------------------------------------------------------- ops


@functools.lru_cache(maxsize=2)
def ops_data(n, groups, seed):
    """The ops suite's rows as numpy arrays, drawn from
    ``np.random.default_rng(seed)`` in the JAX demo's order. Callers must
    not write to the arrays."""
    rng = np.random.default_rng(seed)
    g = max(1, int(groups))
    k = rng.integers(0, g, n).astype(np.uint32)
    o = rng.integers(0, 1 << 31, n).astype(np.uint32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    m = n // 4
    lk = rng.integers(0, 1 << 31, m).astype(np.int32)
    rk = rng.integers(0, 1 << 31, m).astype(np.int32)
    rv = rng.integers(0, 1 << 31, m).astype(np.uint32)
    jk = rng.integers(0, max(m // 4, 1), m).astype(np.uint32)
    jk2 = rng.integers(0, max(m // 4, 1), m).astype(np.uint32)
    return {"k": k, "o": o, "v": v, "lk": lk, "rk": rk, "rv": rv, "jk": jk, "jk2": jk2}


HASH_AGGS = ("sum", "median", "mode", "argmax", "count_distinct", "var")


def _fmt(x):
    return f"{x/(1<<20):g}M" if x >= (1 << 20) else f"{x/1024:g}K"


def _op_window(d):
    return (lambda k, o, v: rst.window(["rank", ("cumsum", v), ("sum", v)],
                                       partition_by=k, order_by=o)), ("k", "o", "v")


def _op_rolling(d):
    return (lambda k, o, v: rst.window(("rolling_sum", v, 64, 32),
                                       partition_by=k, order_by=o)), ("k", "o", "v")


def _op_hagg(agg):
    return lambda d: ((lambda k, v: rst.hash_aggregate(k, v, agg)), ("k", "v"))


def _op_asof(d):
    return (lambda lk, rk, rv: rst.join_asof(lk, rk, rv, direction="backward")), ("lk", "rk", "rv")


def _op_join(d):
    cap = 8 * d["jk"].shape[0]
    return (lambda jk, jk2, rv: rst.hash_join(jk, rv, jk2, rv, capacity=cap, how="inner")), \
        ("jk", "jk2", "rv")


# name -> (report label from n, input rows from n, op(data) -> (fn, array names))
OPS = {
    "window": (lambda n: "window rank+cumsum+sum", lambda n: n, _op_window),
    "rolling": (lambda n: "window rolling_sum(64,32)", lambda n: n, _op_rolling),
    **{f"hash_aggregate_{a}": (lambda n, a=a: f"hash_aggregate {a}", lambda n: n, _op_hagg(a))
       for a in HASH_AGGS},
    "join_asof": (lambda n: f"join_asof backward {_fmt(n // 4)}x{_fmt(n // 4)}",
                  lambda n: n // 4, _op_asof),
    "hash_join": (lambda n: f"hash_join inner {_fmt(n // 4)}x{_fmt(n // 4)} "
                            f"(cap {_fmt(8 * (n // 4))})", lambda n: n // 4, _op_join),
}


def build_op(name, n, seed, device, groups=1 << 20):
    """(fn, args) of one ops-suite entry: ``fn(*args)`` runs the operator on
    tensors on ``device`` and returns its outputs."""
    d = ops_data(n, groups, seed)
    fn, names = OPS[name][2](d)
    args = tuple(torch.from_numpy(np.ascontiguousarray(d[a]).view(
        np.int32)).to(device).view(getattr(torch, d[a].dtype.name)) for a in names)
    return fn, args


def _ops_suite(args):
    """Query-operator throughput table."""
    dev = _device(args.device)
    n = int(args.ops_n)
    g = max(1, int(args.groups))
    print(f"device={_device_name(dev)} n={n:,} groups={g:,} runs={args.runs}", flush=True)
    for name, (label, rows, _) in OPS.items():
        fn, fargs = build_op(name, n, args.seed, dev, groups=g)
        _report(label(n), rows(n), _timed(fn, fargs, args.runs, dev))


# ---------------------------------------------------------------- sort


def main(argv=None):
    args = _parse_args(argv)
    if args.suite == "ops":
        _ops_suite(args)
        return
    if args.suite == "queries":
        _queries_suite(args)
        return
    dev = _device(args.device)

    if args.gen_data:
        if args.n is None:
            raise SystemExit("--gen-data needs --n")
        kw = {}
        if args.dist == "zipf":
            kw["s"] = args.zipf_s
        if args.dist == "step_uniform":
            kw["num_steps"] = args.steps
        dtype = np.uint64 if "u64" in args.dtypes and "u32" not in args.dtypes else np.uint32
        arr = io.gen_data(args.gen_data, int(args.n), dtype=dtype, dist=args.dist,
                          seed=args.seed, device=dev, **kw)
        print(f"wrote {arr.size} {arr.dtype} keys ({arr.nbytes/1e9:.2f} GB) "
              f"to {args.gen_data} (dist={args.dist})", flush=True)
        return

    engines = args.engines or ([args.implementation] if args.implementation else ["auto"])
    print(f"device={_device_name(dev)} devices={torch.cuda.device_count() if dev.type == 'cuda' else 1} "
          f"engines={engines}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if args.data:
        # bit-identical persisted dataset (bench_sorts_data, main.rs:47-81)
        host = io.read_raw(args.data)
        dt_name = {4: "u32", 8: "u64"}[host.dtype.itemsize]
        n = host.size
        fns = _engine_fns(dt_name, engines)
        data = _upload(host, dev)
        gb = host.nbytes * 2 / 1e9  # key+payload rows
        for eng in engines:
            mean = _timed(fns[eng], (data,), args.runs, dev)
            print(f"Sorted {args.data} [{n} ({dt_name},{dt_name}) rows] "
                  f"with {eng}: {mean:.4f}s  ({n/mean/1e6:.1f}M keys/s, "
                  f"{gb/mean:.2f} GB/s)", flush=True)
        return

    for dt_name in args.dtypes:
        rowbytes = {"u32": 8, "u64": 16}[dt_name]
        fns = _engine_fns(dt_name, engines)
        for gb in args.sizes:
            n = int(gb * 1e9 / rowbytes)
            warm = _make_rows(gen, n, dt_name, args)
            for eng in engines:
                fns[eng](warm)  # warm up
            del warm
            _wait(dev)
            times = {eng: [] for eng in engines}
            for _ in range(args.runs):
                data = _make_rows(gen, n, dt_name, args)
                _wait(dev)
                # every engine sorts THE SAME rows (main.rs:36-42); the
                # sorts return new tensors and leave their inputs as they are
                for eng in engines:
                    t0 = time.perf_counter()
                    out = fns[eng](data)
                    _wait(dev)
                    times[eng].append(time.perf_counter() - t0)
                    del out
                del data
            for eng in engines:
                mean = float(np.mean(times[eng]))
                tag = f" [{eng}]" if len(engines) > 1 else ""
                print(
                    f"Sorted {gb}GB of ({dt_name},{dt_name}) data in: {mean:.4f}s"
                    f"  ({n/mean/1e6:.1f}M keys/s, {gb/mean:.2f} GB/s,"
                    f" dist={args.dist}){tag}", flush=True
                )


if __name__ == "__main__":
    main()
