"""Multi-process engine smoke: one process per "host".

Counterpart of ``radix_sort_tpu/parallel/mp_smoke.py``. Each process brings
up ``torch.distributed`` through :func:`runtime.initialize_multihost`,
builds one mesh over every process's slots, and runs the distributed
engine across the process boundary, checked against numpy oracles:

  1. ``distributed_sort_pairs`` on uniform keys and on duplicate-heavy keys
     (seven distinct values: stability decides the payload order, and runs
     of equal keys split across processes).
     Then one ``distributed_hash_join`` (a left join: unmatched rows and
     the padding masks of the received shards) and one
     ``distributed_hash_aggregate`` (sum, count and median by key: the
     two-phase plan and the shuffle plan);
  2. a ``DistTable`` pipeline: a filter, then a GROUP BY (sum and count);
  3. SQL over a ``DistTable`` fact side and a ``Table`` dimension: the
     planner's eager-aggregation rewrite turns the join into a broadcast
     lookup join (``join[lookup on sym]`` in the plan).

Every process holds the same seeded numpy inputs, owns only its slots'
blocks, and checks the gathered outputs itself; it prints ``MP_SMOKE_OK``
and exits 0 only if every check passes. The slots are on the card unless
``--device cpu`` asks for CPU slots. Run it per process i of N::

    python -m radix_sort_tpu_torch.parallel.mp_smoke --process-id i \\
        --num-processes N --coordinator localhost:PORT \\
        --devices-per-process 2 --device cpu

or let :func:`runtime.run_local_cluster` launch the whole cluster.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _check_sort(mesh, keys, vals, name):
    """One cross-process distributed sort against the stable numpy sort."""
    from radix_sort_tpu_torch.parallel import dist_sort, runtime

    k, v, counts, overflow = dist_sort.distributed_sort_pairs(
        torch.from_numpy(keys), torch.from_numpy(vals), mesh)
    assert not bool(overflow), f"{name}: exchange overflow"
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(runtime.valid_rows(k, counts).cpu().numpy(), keys[order],
                                  err_msg=name)
    np.testing.assert_array_equal(runtime.valid_rows(v, counts).cpu().numpy(), vals[order],
                                  err_msg=name)


def run_smoke(coordinator: str, num_processes: int, process_id: int,
              devices_per_process: int = 1, device: str = "cuda") -> None:
    """The worker body (see the module docstring). Raises on any failure."""
    import torch.distributed as dist

    from radix_sort_tpu_torch.parallel import dist_query, runtime

    runtime.initialize_multihost(coordinator, num_processes, process_id, device=device)
    assert dist.get_world_size() == num_processes, "cluster bring-up degraded"
    assert dist.get_rank() == process_id
    mesh = runtime.data_mesh(devices_per_process, device=device)
    P = mesh.size
    assert P == num_processes * devices_per_process and len(mesh.local) == devices_per_process

    # --- 1. distributed sorts across the process boundary
    rng = np.random.default_rng(0xD15C0)
    n = 1024 * P
    vals = np.arange(n, dtype=np.uint32)
    uniform = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    step = (rng.integers(0, 7, size=n).astype(np.uint32) + 1) * np.uint32(0x24924924)
    _check_sort(mesh, uniform, vals, "uniform")
    _check_sort(mesh, step, vals, "step_dups")

    # --- 1 (cont.). a left join and a GROUP BY across the boundary
    lk = rng.integers(0, 300, n).astype(np.uint32)
    lv = np.arange(n, dtype=np.int32)
    rk = rng.integers(0, 200, n).astype(np.uint32)
    rv = rng.standard_normal(n).astype(np.float32)
    jk, jlv, jrv, cnts, ovf = dist_query.distributed_hash_join(
        *map(torch.from_numpy, (lk, lv, rk, rv)), mesh, capacity_per_shard=64 * n // P,
        how="left", exchange_capacity_factor=4.0)
    assert not bool(ovf), "join overflow"
    got = sorted(zip(*(runtime.valid_rows(c, cnts).cpu().numpy().tolist()
                       for c in (jk, jlv, jrv))))
    by_key = {}
    for k, v in zip(rk.tolist(), rv.tolist()):
        by_key.setdefault(k, []).append(v)
    want = sorted((k, a, b) for k, a in zip(lk.tolist(), lv.tolist())
                  for b in by_key.get(k, [0.0]))
    assert got == want, "left join rows"

    sym = rng.integers(0, 11, n).astype(np.uint32)
    qty = rng.integers(1, 100, n).astype(np.int32)
    uk, (s, c), cnt, ovf = dist_query.distributed_hash_aggregate(
        torch.from_numpy(sym), [torch.from_numpy(qty)] * 2, mesh, ["sum", "count"],
        max_groups=32)
    uk2, med, cnt2, ovf2 = dist_query.distributed_hash_aggregate(
        torch.from_numpy(sym), torch.from_numpy(qty), mesh, "median", max_groups=32,
        exchange_capacity_factor=4.0)
    groups = np.unique(sym)
    assert int(cnt) == int(cnt2) == len(groups) and not bool(ovf) and not bool(ovf2)
    m = len(groups)
    np.testing.assert_array_equal(uk.cpu().numpy()[:m], groups)
    np.testing.assert_array_equal(uk2.cpu().numpy()[:m], groups)
    for i, g in enumerate(groups):
        q = qty[sym == g]
        assert s[i] == q.sum() and c[i] == len(q), "aggregate sum/count"
        assert med[i] == np.sort(q)[(len(q) - 1) // 2], "aggregate median"

    # --- 2. a DistTable pipeline: filter, then a distributed aggregate
    import radix_sort_tpu_torch as rst

    sym = rng.integers(0, 11, n).astype(np.uint32)
    qty = rng.integers(1, 100, n).astype(np.uint32)
    dt = rst.DistTable({"sym": sym, "qty": qty}, mesh)
    agg = dt.filter(rst.col("qty") > 50).aggregate(
        "sym", {"vol": ("sum", "qty"), "n": ("count", "qty")}, max_groups=32)
    out = agg.to_numpy()
    keep = qty > 50
    uks = np.unique(sym[keep])
    np.testing.assert_array_equal(out["sym"], uks, err_msg="dist_table keys")
    for i, u in enumerate(uks):
        g = qty[keep][sym[keep] == u]
        assert out["vol"][i] == g.sum(), "dist_table vol"
        assert out["n"][i] == len(g), "dist_table count"

    # --- 3. SQL across the boundary: the eager-aggregated lookup join
    dsym = np.repeat(np.arange(8, dtype=np.uint32), 2)  # fanout 2
    dim = rst.Table({"sym": dsym, "seg": (dsym % 3).astype(np.uint32)}, device=mesh.home)
    lq = rst.sql("SELECT sym, SUM(qty) AS vol, COUNT(*) AS cnt FROM f JOIN d USING (sym) "
                 "WHERE seg < 2 GROUP BY sym ORDER BY sym", {"f": dt, "d": dim}, max_groups=32)
    assert "join[lookup on sym]" in lq.explain(), "eager-aggregation rewrite"
    got = lq.collect().to_numpy()
    dkeep = np.unique(dsym[dsym % 3 < 2])
    uks = np.array([u for u in np.unique(sym) if u in dkeep])
    np.testing.assert_array_equal(got["sym"], uks, err_msg="sql sym")
    for i, u in enumerate(uks):
        g = qty[sym == u]
        assert int(got["vol"][i]) == 2 * int(g.sum()), "sql vol"
        assert int(got["cnt"][i]) == 2 * len(g), "sql cnt"

    print(f"MP_SMOKE_OK process={process_id}/{num_processes} slots={P} "
          f"local={devices_per_process}", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0's store")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--devices-per-process", type=int, default=1,
                   help="shard slots each process owns")
    p.add_argument("--device", default="cuda", help="cuda (NCCL, one card per process) or cpu "
                   "(gloo)")
    a = p.parse_args(argv)
    run_smoke(a.coordinator, a.num_processes, a.process_id, a.devices_per_process, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
