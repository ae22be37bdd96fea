"""The exchange's copies between mesh slots (``parallel/collectives.py``)
and the distributed sort's landing of them in its padded receive buffers
(``dist_sort._ragged_exchange``).

On the CPU: the round schedule, and the landing bit for bit against the
list-then-``torch.cat`` form it replaced, on meshes of CPU slots. The tests
marked ``cuda`` need two or more cards and skip otherwise: they hold the
copies that run on every card at once to the plain ``.to()`` landing. No
JAX here, so where only PyTorch with CUDA is installed:

    python -m pytest --noconftest -q tests/test_torch_dist_exchange.py
"""

import numpy as np
import pytest
import torch

from radix_sort_tpu_torch.parallel import collectives as C
from radix_sort_tpu_torch.parallel import dist_sort, runtime


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_exchange_rounds_pair_every_slot_once(p):
    rounds = C.exchange_rounds(p)
    assert len(rounds) == p - 1
    for rnd in rounds:
        assert sorted(s for s, _ in rnd) == list(range(p))
        assert sorted(d for _, d in rnd) == list(range(p))
    pairs = [sd for rnd in rounds for sd in rnd]
    assert sorted(pairs) == [(s, d) for s in range(p) for d in range(p) if s != d]


def ragged_exchange_by_cat(mesh, slot_ops, fills, slot_starts, capacity):
    """``_ragged_exchange`` as it was: every run received as a tensor of
    its own, then joined with the fill tail by ``torch.cat``."""
    P = mesh.size
    n_local = slot_ops[0][0].shape[0]
    starts = C.all_gather(mesh, slot_starts).reshape(P, P).tolist()
    allc = [[(starts[s][d + 1] if d + 1 < P else n_local) - starts[s][d] for d in range(P)]
            for s in range(P)]
    oo = [[0] * P for _ in range(P)]
    sz = [[0] * P for _ in range(P)]
    for d in range(P):
        acc = 0
        for s in range(P):
            oo[s][d] = min(acc, capacity)
            sz[s][d] = min(allc[s][d], capacity - oo[s][d])
            acc += allc[s][d]
    overflow = any(sum(allc[s][d] for s in range(P)) > capacity for d in range(P))
    recv_n = [sum(sz[s][d] for s in range(P)) for d in range(P)]
    outs = [[] for _ in mesh.local]
    for k, fill in enumerate(fills):
        pieces = [[ops[k][starts[s][d]:starts[s][d] + sz[s][d]] for d in range(P)]
                  for ops, s in zip(slot_ops, mesh.local)]
        recv = C.all_to_all(mesh, pieces, sz)
        for j, d in enumerate(mesh.local):
            got = recv[j]
            tail = torch.full((capacity - recv_n[d],), fill, dtype=got[0].dtype)
            outs[j].append(torch.cat(got + [tail]))
    return outs, recv_n, overflow


def _starts(case, p, n, s):
    """Slot s's run starts ``(p,)`` int64: 0, then the ends of its runs to
    destinations 0 to p - 2."""
    if case == "balanced":
        lengths = [n // p] * p
    elif case == "zipf":  # run lengths 1 / (k + 1)**1.1 to slot s + k: skewed, yet
        w = [1 / (((d - s) % p) + 1) ** 1.1 for d in range(p)]  # every slot gets ~n
        lengths = [int(n * x / sum(w)) for x in w]
    elif case == "empty":  # every row to its own slot, every other run empty
        lengths = [n if d == s else 0 for d in range(p)]
    else:  # "overflow": two thirds of every slot to slot 0
        lengths = [2 * n // 3] + [(n - 2 * n // 3) // (p - 1)] * (p - 1)
    return torch.tensor([0] + list(np.cumsum(lengths[:-1])), dtype=torch.int64)


@pytest.mark.parametrize("p", [3, 4])
@pytest.mark.parametrize("case", ["balanced", "zipf", "empty", "overflow"])
def test_landing_in_place_matches_list_then_cat(case, p):
    rng = np.random.default_rng(p * 100 + len(case))
    n = 1000
    mesh = runtime.data_mesh(p, device="cpu")
    slot_ops = [[torch.from_numpy(rng.integers(-2**62, 2**62, n)),
                 torch.from_numpy(rng.integers(0, 2**63, n, dtype=np.uint64)),
                 torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))]
                for _ in range(p)]
    fills = [torch.iinfo(torch.int64).max, 0, -1]
    starts = [_starts(case, p, n, s) for s in range(p)]
    capacity = n if case == "overflow" else dist_sort.exchange_capacity(n, p)
    copies, peer = C.OVERLAPPED_COPIES, C.PEER_BYTES
    got = dist_sort._ragged_exchange(mesh, slot_ops, fills, starts, capacity)
    want = ragged_exchange_by_cat(mesh, slot_ops, fills, starts, capacity)
    assert got[1:3] == want[1:]  # counts, overflow
    assert got[2] == (case == "overflow")
    # the run sizes: each slot's count in source order, back to back
    assert [sum(r) for r in got[3]] == got[1] and all(len(r) == p for r in got[3])
    for g_slot, w_slot in zip(got[0], want[0]):
        for g, w in zip(g_slot, w_slot):
            assert g.dtype == w.dtype and g.shape == (capacity,)
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    # slots of one device copy nothing between cards
    assert (C.OVERLAPPED_COPIES, C.PEER_BYTES) == (copies, peer)


@pytest.mark.parametrize("op", ["sort", "route_home", "shift"])
def test_cpu_mesh_makes_no_overlapped_copies(op):
    p, n = 4, 4096
    mesh = runtime.data_mesh(p, device="cpu")
    gen = torch.Generator().manual_seed(17)
    keys = [torch.randint(0, 1 << 40, (n,), generator=gen) for _ in range(p)]
    copies, peer = C.OVERLAPPED_COPIES, C.PEER_BYTES
    if op == "sort":
        out = dist_sort.distributed_sort_pairs(runtime.Sharded(mesh, keys),
                                               runtime.Sharded(mesh, keys), mesh)
        whole = torch.cat(keys).sort(stable=True).values
        assert torch.equal(runtime.valid_rows(out[0], out[2]), whole)
    elif op == "route_home":
        perm = torch.randperm(p * n, generator=gen)
        pos = [perm[s::p] for s in range(p)]
        home = dist_sort._route_home(mesh, pos, [[k] for k in keys], n)
        flat = torch.empty(p * n, dtype=torch.int64)
        flat[torch.cat(pos)] = torch.cat(keys)
        assert torch.equal(torch.cat([h[0] for h in home]), flat)
    else:
        got = C.shift(mesh, keys, 1)
        assert torch.equal(got[0], torch.zeros(n, dtype=torch.int64))
        assert all(torch.equal(got[d], keys[d - 1]) for d in range(1, p))
    assert (C.OVERLAPPED_COPIES, C.PEER_BYTES) == (copies, peer)


# ---- on two or more cards -------------------------------------------------


@pytest.fixture
def cards():
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < 2:
        pytest.skip("needs two or more CUDA cards")
    return found


def card_mesh(cards, p):
    if cards < p:
        pytest.skip(f"needs {p} CUDA cards")
    return runtime.data_mesh(devices=[f"cuda:{i}" for i in range(p)])


def plain_land(moves):
    """The landing through plain ``copy_``, each copy between two cards
    behind PyTorch's barrier with both cards' current streams."""
    for x, y in moves:
        y.copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
def test_all_to_all_between_cards_matches_to(cards, p):
    mesh = card_mesh(cards, p)
    gen = torch.Generator().manual_seed(p)
    sizes = [torch.randint(1, 1 << 20, (p,), generator=gen).tolist() for _ in range(p)]
    pieces = [[torch.randint(-2**62, 2**62, (sizes[s][d],), generator=gen).to(f"cuda:{s}")
               for d in range(p)] for s in range(p)]
    copies = C.OVERLAPPED_COPIES
    recv = C.all_to_all(mesh, pieces, sizes)
    assert C.OVERLAPPED_COPIES - copies == p * (p - 1)
    for d in range(p):
        for s in range(p):
            assert recv[d][s].device == torch.device("cuda", d)
            assert torch.equal(recv[d][s], pieces[s][d].to(f"cuda:{d}"))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
def test_sort_between_cards_matches_plain_landing(cards, p, monkeypatch):
    mesh = card_mesh(cards, p)
    n = 1 << 18
    gen = torch.Generator().manual_seed(100 + p)
    keys = [torch.randint(0, 1 << 62, (n,), generator=gen).to(f"cuda:{s}") for s in range(p)]
    vals = [torch.randint(0, 1 << 62, (n,), generator=gen).to(f"cuda:{s}") for s in range(p)]

    def run():
        k, v, counts, overflow = dist_sort.distributed_sort_pairs(
            runtime.Sharded(mesh, keys), runtime.Sharded(mesh, vals), mesh)
        assert not bool(overflow)
        return k.blocks, v.blocks, counts.tolist()

    copies = C.OVERLAPPED_COPIES
    got = run()
    assert C.OVERLAPPED_COPIES - copies == 2 * p * (p - 1)  # one key word, one value column
    monkeypatch.setattr(C, "_land", plain_land)
    want = run()
    assert got[2] == want[2]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.device == w.device and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
def test_landed_rows_survive_reuse_of_freed_memory(cards, p):
    """Free what was sent right after the call and overwrite fresh memory
    on every card's current stream; receive into memory that pending work
    freed just before: the landed rows stay intact."""
    mesh = card_mesh(cards, p)
    n = 1 << 24  # 128 MiB a piece, so copies are in flight when the host moves on

    def piece(s, d, dev):
        return torch.arange(n, dtype=torch.int64, device=dev) * (p * p) + (s * p + d)

    pieces = [[piece(s, d, f"cuda:{s}") for d in range(p)] for s in range(p)]
    bufs = []
    for d in range(p):
        busy = torch.full((p * n,), -7, dtype=torch.int64, device=f"cuda:{d}")
        for _ in range(8):
            busy.mul_(3).add_(1)  # pending work on memory freed before the buffer is made
        del busy
        bufs.append(torch.empty((p * n,), dtype=torch.int64, device=f"cuda:{d}"))
    sizes = [[n] * p for _ in range(p)]
    offsets = [[s * n] * p for s in range(p)]
    C.all_to_all_into(mesh, [(pieces, bufs)], sizes, offsets)
    del pieces
    junk = [torch.full((p * n,), -1, dtype=torch.int64, device=f"cuda:{s}") for s in range(p)]
    for d in range(p):
        want = torch.cat([piece(s, d, f"cuda:{d}") for s in range(p)])
        assert torch.equal(bufs[d], want)
    assert all(bool((j == -1).all()) for j in junk)
