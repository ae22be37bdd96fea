"""The collectives of the distributed bodies, over every slot of a mesh.

The JAX package calls ``all_gather``, ``psum`` and ``ragged_all_to_all``
inside ``shard_map``. Here each distributed body runs in bulk-synchronous
phases over the list of this process's slots, and these functions are the
steps between the phases. Each takes one entry per local slot and works
over all P slots of the mesh:

  * slots of this process exchange by copies: within a device by views,
    between two cards by peer copies, every card's at once (each card
    sends on its own copy stream, in the rounds of
    :func:`exchange_rounds`);
  * slots of other processes through ``torch.distributed``
    (``all_gather``, ``all_to_all_single`` with split sizes,
    ``all_reduce``), every tensor sent as its bytes, so any dtype rides
    gloo and NCCL alike.

So one code path serves one process with four slots on one card, two CPU
processes with two slots each, and one process per card.

Every all-gather runs inside the ``torch.profiler`` range
:data:`GATHER_RANGE`, and every move of rows between slots (the exchanges
of :mod:`.dist_sort`, the routes home and the neighbour shifts of
:mod:`.dist_window`) inside :data:`EXCHANGE_RANGE`; the two never nest,
so a profile reads each one's device time apart. A range costs nothing
while no profiler runs. :data:`PEER_BYTES` counts the bytes these
functions move between two devices or two processes (a copy within one
device moves none), and :data:`OVERLAPPED_COPIES` the copies between two
cards made on a card's copy stream.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "any_true", "all_to_all", "all_to_all_into", "cat",
           "exchange_rounds", "shift", "EXCHANGE_RANGE", "GATHER_RANGE",
           "OVERLAPPED_COPIES", "PEER_BYTES"]

EXCHANGE_RANGE = "distributed exchange"
GATHER_RANGE = "distributed all-gather"
PEER_BYTES = 0
OVERLAPPED_COPIES = 0

# made once a process, at a card's first exchange: the card's copy stream,
# and for each (source, destination) pair a stream of the destination that
# stands current there while the pair copies (see :func:`_land`)
_COPY_STREAMS: dict = {}
_PAIR_STREAMS: dict = {}

_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def _move(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``, its bytes counted in :data:`PEER_BYTES` when
    they change device."""
    global PEER_BYTES
    if x.device != torch.device(device):
        PEER_BYTES += x.numel() * x.element_size()
    return x.to(device)


def _sent(nbytes: int) -> None:
    """Count ``nbytes`` sent to other processes in :data:`PEER_BYTES`."""
    global PEER_BYTES
    PEER_BYTES += nbytes


def cat(xs, device=None) -> torch.Tensor:
    """``torch.cat`` of 1-D tensors of one dtype on ``device``; unsigned
    dtypes are joined as their signed views (not every device has unsigned
    kernels)."""
    dtype = xs[0].dtype
    sdt = _SIGNED_VIEW.get(dtype, dtype)
    return torch.cat([_move(x.reshape(-1).view(sdt), device or x.device) for x in xs]).view(dtype)


def all_gather(mesh, xs, *, label: str = GATHER_RANGE) -> torch.Tensor:
    """``xs[i]``: local slot i's 1-D tensor (one shape and dtype on every
    slot). Returns every slot's tensor concatenated in slot order on
    ``mesh.home`` (the JAX package's tiled ``all_gather``), the same on
    every process. ``label``: the profiler range it runs in (an exchange
    that moves its rows by all-gather passes :data:`EXCHANGE_RANGE`)."""
    with torch.profiler.record_function(label):
        local = cat(xs, mesh.home)
        if not mesh.multiprocess:
            return local
        buf = _bytes(local)
        parts = [torch.empty_like(buf) for _ in range(mesh.num_processes)]
        _sent(buf.numel() * (mesh.num_processes - 1))
        dist.all_gather(parts, buf)
        return torch.cat(parts).view(local.dtype)


def any_true(mesh, flags) -> bool:
    """OR of one boolean (0-dim or 1-element tensor) per local slot over
    every slot of the mesh (the JAX package's ``psum(flag) > 0``); read on
    the host, so it synchronises."""
    v = torch.stack([f.reshape(()).to(mesh.home, torch.int32) for f in flags]).amax()
    if mesh.multiprocess:
        v = v.reshape(1).clone()
        dist.all_reduce(v, op=dist.ReduceOp.MAX)
    return bool(v.reshape(()))


def exchange_rounds(P: int):
    """The order of an exchange's copies between slots: P - 1 rounds of
    ``(source, destination)`` pairs; in round r (1 to P - 1) slot s sends to
    slot ``(s + r) % P``. Each round is a permutation, so every slot sends
    to one slot and receives from one, and every pair of two slots appears
    once."""
    return [[(s, (s + r) % P) for s in range(P)] for r in range(1, P)]


def _copy_order(P: int):
    """Every ``(source, destination)`` pair: each slot's own piece, then the
    rounds of :func:`exchange_rounds`."""
    return [(s, s) for s in range(P)] + [sd for rnd in exchange_rounds(P) for sd in rnd]


def _stream(cache, key, device):
    if key not in cache:
        cache[key] = torch.cuda.Stream(device=device)
    return cache[key]


def _recorded(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _land(moves) -> None:
    """Copy each ``(src, dst)`` pair of 1-D tensors (one length and dtype)
    in the order given, ``dst`` a view that lands in place.

    Within a device: ``dst.copy_(src)`` on the device's current stream.
    Between two CUDA cards: on the source card's copy stream, so the cards'
    copies run at once. A plain ``copy_`` between cards waits, each way,
    for the current streams of both cards, and so for every copy made
    before it; here the source's copy stream and a stream of the
    destination kept for the pair stand current while it copies, so a copy
    waits only for the pair's earlier copies. Each copy stream first waits
    for the current streams of its card and of the cards it sends to (the
    pieces are made, the destinations allocated); every card's current
    stream then waits for the copy streams that read from or wrote to it,
    so what it reads next has landed, and what it sent is not reused (the
    caching allocator hands a freed block back to that stream). No host
    sync."""
    global OVERLAPPED_COPIES, PEER_BYTES
    peer, within = [], []
    for x, y in moves:
        if x.device != y.device:
            PEER_BYTES += x.numel() * x.element_size()
        if x.device == y.device or "cpu" in (x.device.type, y.device.type):
            within.append((x, y))
        elif x.numel():
            peer.append((x, y))
    sends: dict = {}
    for x, y in peer:
        sends.setdefault(x.device.index, set()).add(y.device.index)
    cards = set(sends).union(*sends.values())
    ready = {c: _recorded(torch.cuda.current_stream(c)) for c in cards}
    for s, dests in sends.items():
        stream = _stream(_COPY_STREAMS, s, s)
        for c in dests | {s}:
            stream.wait_event(ready[c])
    for x, y in peer:
        s, d = x.device.index, y.device.index
        with torch.cuda.stream(_COPY_STREAMS[s]), \
                torch.cuda.stream(_stream(_PAIR_STREAMS, (s, d), d)):
            y.copy_(x)
        OVERLAPPED_COPIES += 1
    for x, y in within:  # behind the copy streams' start, so they overlap
        y.copy_(x)
    done = {s: _recorded(_COPY_STREAMS[s]) for s in sends}
    for c in cards:
        current = torch.cuda.current_stream(c)
        for s, dests in sends.items():
            if c == s or c in dests:
                current.wait_event(done[s])


def all_to_all(mesh, pieces, sizes):
    """Exact-count exchange. ``pieces[i][d]``: the 1-D tensor local slot i
    sends to global slot d (one dtype throughout); ``sizes[s][d]``: the
    length of what slot s sends to slot d, for every pair (host ints, the
    same on every process). Returns ``recv`` with ``recv[j][s]`` what
    global slot s sent to local slot j, on slot j's device; concatenated in
    s order it lands source-major. A piece that stays on its device is
    handed back as it is, not copied."""
    P, local = mesh.size, mesh.local
    if not mesh.multiprocess:  # this process owns every slot
        recv = [[pieces[s][d] for s in range(P)] for d in range(P)]
        moves = []
        for s, d in _copy_order(P):
            x = recv[d][s]
            if x.device != mesh.devices[d]:
                recv[d][s] = torch.empty_like(x, device=mesh.devices[d])
                moves.append((x, recv[d][s]))
        _land(moves)
        return recv
    dtype = pieces[0][0].dtype
    item = torch.empty((), dtype=dtype).element_size()
    procs = range(mesh.num_processes)
    slots_of = {r: [s for s in range(P) if mesh.owners[s] == r] for r in procs}
    # send order: destination process, its slots, then this process's slots
    send = [pieces[i][d] for r in procs for d in slots_of[r] for i in range(len(local))]
    in_split = [item * sum(sizes[s][d] for d in slots_of[r] for s in local) for r in procs]
    out_split = [item * sum(sizes[s][d] for d in local for s in slots_of[r]) for r in procs]
    sbuf = _bytes(torch.cat([_move(p, mesh.home) for p in send])) if send else None
    rbuf = torch.empty((sum(out_split),), dtype=torch.uint8, device=mesh.home)
    if sbuf is None or sbuf.numel() == 0:
        sbuf = torch.empty((0,), dtype=torch.uint8, device=mesh.home)
    _sent(sum(b for r, b in zip(procs, in_split) if r != mesh.rank))
    dist.all_to_all_single(rbuf, sbuf, out_split, in_split)
    recv = [[None] * P for _ in local]
    off = 0
    for r in procs:  # each source process packed (our slot, its slot)
        for j, d in enumerate(local):
            for s in slots_of[r]:
                nb = item * sizes[s][d]
                recv[j][s] = _move(rbuf[off:off + nb].view(dtype), mesh.devices[j])
                off += nb
    return recv


def all_to_all_into(mesh, columns, sizes, offsets) -> None:
    """:func:`all_to_all` of several columns, landed in place. ``columns``:
    one ``(pieces, outs)`` a column, ``pieces`` as :func:`all_to_all`'s and
    ``outs[j]`` local slot j's 1-D receive buffer (on its device, in the
    pieces' dtype); what global slot s sends to slot d lands at
    ``outs[j][offsets[s][d]:offsets[s][d] + sizes[s][d]]``. In one process
    every piece is one copy, between cards on the copy streams of
    :func:`_land`, column after column within each pair."""
    P, local = mesh.size, mesh.local
    if mesh.multiprocess:
        for pieces, outs in columns:
            recv = all_to_all(mesh, pieces, sizes)
            for j, d in enumerate(local):
                for s in range(P):
                    outs[j][offsets[s][d]:offsets[s][d] + sizes[s][d]].copy_(recv[j][s])
        return
    _land([(pieces[s][d], outs[d][offsets[s][d]:offsets[s][d] + sizes[s][d]])
           for s, d in _copy_order(P) for pieces, outs in columns])


def shift(mesh, xs, offset: int):
    """Neighbour shift (the JAX package's ``ppermute`` by ``offset`` slots):
    ``xs[i]``, local slot i's 1-D tensor (one shape and dtype on every
    slot), goes to global slot ``slot + offset``. Returns one tensor per
    local slot, on its device: what slot ``slot - offset`` sent, or zeros
    where there is no such slot. Runs in :data:`EXCHANGE_RANGE`."""
    P = mesh.size
    n = xs[0].shape[0]
    with torch.profiler.record_function(EXCHANGE_RANGE):
        # an exact-count exchange with one non-empty piece per source
        sizes = [[n if d == s + offset else 0 for d in range(P)] for s in range(P)]
        pieces = [[x if d == s + offset else x[:0] for d in range(P)]
                  for s, x in zip(mesh.local, xs)]
        recv = all_to_all(mesh, pieces, sizes)
        return [recv[j][d - offset] if 0 <= d - offset < P
                else torch.zeros_like(xs[0], device=dev)
                for j, (d, dev) in enumerate(zip(mesh.local, mesh.devices))]
