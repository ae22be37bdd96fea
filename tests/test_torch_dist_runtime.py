"""The port's mesh, row sharding and collectives (parallel/runtime.py,
parallel/collectives.py), and a real 2-process cluster: two gloo processes
with two CPU slots each run the port's ``mp_smoke`` (distributed sorts,
a left join and a GROUP BY, a DistTable filter and aggregate, and SQL with
the eager-aggregation lookup join across the process boundary, each
checked against numpy inside every process), as
``tests/test_dist_multiprocess.py`` runs the JAX package's.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from radix_sort_tpu_torch.parallel import collectives, runtime


def test_data_mesh_and_sharding():
    mesh = runtime.data_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.local == (0, 1, 2, 3) and not mesh.multiprocess
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert runtime.data_mesh(device="cpu").size == 1
    named = runtime.data_mesh(devices=["cpu", "cpu"])
    assert named.size == 2 and named.home == torch.device("cpu")
    x = torch.arange(16, dtype=torch.int32)
    a, b = runtime.shard_rows(mesh, x, x * 2)
    assert isinstance(a, runtime.Sharded) and a.shape == (16,) and a.block_rows == 4
    assert [blk.tolist() for blk in a.blocks] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                                  [8, 9, 10, 11], [12, 13, 14, 15]]
    assert torch.equal(runtime.gather_rows(b), x * 2)
    assert runtime.valid_rows(a, torch.tensor([1, 0, 4, 2])).tolist() == [0, 8, 9, 10, 11, 12, 13]
    assert runtime.local_blocks(mesh, a) is a.blocks
    assert [blk.tolist() for blk in runtime.local_blocks(mesh, x)] == [blk.tolist()
                                                                      for blk in a.blocks]


def test_sharding_errors():
    mesh = runtime.data_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="equal blocks"):
        runtime.shard_rows(mesh, torch.zeros(10))
    with pytest.raises(ValueError, match="local slots"):
        runtime.Sharded(mesh, [torch.zeros(3)])
    with pytest.raises(ValueError, match="one shape"):
        runtime.Sharded(mesh, [torch.zeros(3)] * 3 + [torch.zeros(2)])
    other = runtime.data_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        runtime.local_blocks(mesh, runtime.shard_rows(other, torch.zeros(4)))
    with pytest.raises(TypeError):
        runtime.local_blocks(mesh, np.zeros(4))
    with pytest.raises(ValueError, match="contiguous"):
        runtime.Mesh([0, 1, 0], ["cpu"] * 2, rank=0)


def test_collectives_in_one_process():
    mesh = runtime.data_mesh(3, device="cpu")
    xs = [torch.tensor([s, 10 * s], dtype=torch.int64) for s in range(3)]
    assert collectives.all_gather(mesh, xs).tolist() == [0, 0, 1, 10, 2, 20]
    assert not collectives.any_true(mesh, [torch.tensor(False)] * 3)
    assert collectives.any_true(mesh, [torch.tensor(False), torch.tensor([True]),
                                       torch.tensor(False)])
    # slot s sends s + d copies of 100 s + d to slot d; landing source-major
    sizes = [[s + d for d in range(3)] for s in range(3)]
    pieces = [[torch.full((s + d,), 100 * s + d, dtype=torch.float32) for d in range(3)]
              for s in range(3)]
    recv = collectives.all_to_all(mesh, pieces, sizes)
    for d in range(3):
        got = torch.cat(recv[d]).tolist()
        assert got == [100 * s + d for s in range(3) for _ in range(s + d)]


def test_multiprocess_init_failure_is_not_swallowed(monkeypatch):
    """An explicitly requested cluster whose bring-up fails raises; the
    no-argument single-process call stays a no-op."""
    def boom(*a, **kw):
        raise ValueError("rendezvous failed")

    monkeypatch.setattr(dist, "init_process_group", boom)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="rendezvous"):
        runtime.initialize_multihost(num_processes=4, process_id=2, device="cpu")
    with pytest.raises(ValueError, match="rendezvous"):
        runtime.initialize_multihost("localhost:1", 2, 0, device="cpu")
    runtime.initialize_multihost(device="cpu")
    runtime.initialize_multihost(num_processes=1, device="cpu")


def test_nccl_cluster_needs_a_card_per_process(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs as many"):
        runtime.run_local_cluster(num_processes=2, devices_per_process=1, device="cuda")


def test_two_process_cluster():
    results = runtime.run_local_cluster(num_processes=2, devices_per_process=2, device="cpu",
                                        timeout=300)
    assert len(results) == 2
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert f"MP_SMOKE_OK process={pid}/2 slots=4 local=2" in out, out[-2000:]
