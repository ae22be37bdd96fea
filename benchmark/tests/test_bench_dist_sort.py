"""The distributed sort's cell: planted faults in what
``dist_sort.distributed_sort_pairs`` hands back come out not correct, with
rows mismatched, on a mesh of 4 CPU slots at the configuration's tiny size."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import cells_of

CELLS = cells_of("dist_sort_pairs")


def run(reg, cell, seed=2**31 + 11):
    return harness.run_cell(reg, cell, seed, 0.3, False, device="cpu")[0]


def signed(x):
    return x.view(torch.int64)


def unchanged(keys, values, mesh, real):
    """The input handed back as the sorted rows."""
    counts = torch.full((mesh.size,), keys.block_rows, dtype=torch.int32)
    return keys, values, counts, torch.tensor(False)


def unsorted_slot(keys, values, mesh, real):
    """Slot 1's valid rows left in reverse order."""
    k, v, counts, overflow = real(keys, values, mesh)
    c = int(counts[1])
    for col in (k, v):
        col.blocks[1] = torch.cat([signed(col.blocks[1])[:c].flip(0),
                                   signed(col.blocks[1])[c:]]).view(col.dtype)
    return k, v, counts, overflow


def altered(keys, values, mesh, real):
    """One key changed."""
    k, v, counts, overflow = real(keys, values, mesh)
    k.blocks[2] = (signed(k.blocks[2]).clone() ^ torch.tensor(1)).view(k.dtype)
    return k, v, counts, overflow


def swapped(keys, values, mesh, real):
    """Two rows of one key swapped across a slot boundary (stability)."""
    k, v, counts, overflow = real(keys, values, mesh)
    for s in range(mesh.size - 1):
        c = int(counts[s])
        a, b = signed(k.blocks[s]), signed(k.blocks[s + 1])
        if c and int(counts[s + 1]) and int(a[c - 1]) == int(b[0]):
            x, y = signed(v.blocks[s]).clone(), signed(v.blocks[s + 1]).clone()
            x[c - 1], y[0] = int(y[0]), int(x[c - 1])
            v.blocks[s], v.blocks[s + 1] = x.view(v.dtype), y.view(v.dtype)
            return k, v, counts, overflow
    raise AssertionError("no key spans a slot boundary")


def short_count(keys, values, mesh, real):
    """Slot 0's count one short."""
    k, v, counts, overflow = real(keys, values, mesh)
    counts = counts.clone()
    counts[0] -= 1
    return k, v, counts, overflow


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, unsorted_slot, altered, swapped, short_count],
                         ids=lambda f: f.__name__)
def test_dist_sort_faults_come_out_not_correct(reg, cell, fault, monkeypatch):
    from radix_sort_tpu_torch.parallel import dist_sort

    real = dist_sort.distributed_sort_pairs
    monkeypatch.setattr(dist_sort, "distributed_sort_pairs",
                        lambda k, v, mesh, **kw: fault(k, v, mesh, real))
    res = run(reg, cell)
    assert not res["correct"]
    assert res["checks"]["mismatched_rows"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_an_overflow_counts_as_failed(reg, cell, monkeypatch):
    from radix_sort_tpu_torch.parallel import dist_sort

    real = dist_sort.distributed_sort_pairs
    monkeypatch.setattr(dist_sort, "distributed_sort_pairs",
                        lambda k, v, mesh: real(k, v, mesh, capacity=k.block_rows))
    res = run(reg, cell)
    assert not res["correct"] and res["failed"] == res["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_fewer_cards_than_slots_raise(reg, cell, monkeypatch):
    from benchmark.drivers import dist_sort_pairs as DS

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    dev = harness.Device("cpu")
    dev.cuda = True
    with pytest.raises(RuntimeError, match="4 mesh slots need 4 cards; 3 visible"):
        DS.slot_devices(dev, 4)
