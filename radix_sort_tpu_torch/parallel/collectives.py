"""The collectives of the distributed bodies, over every slot of a mesh.

The JAX package calls ``all_gather``, ``psum`` and ``ragged_all_to_all``
inside ``shard_map``. Here each distributed body runs in bulk-synchronous
phases over the list of this process's slots, and these functions are the
steps between the phases. Each takes one entry per local slot and works
over all P slots of the mesh:

  * slots of this process exchange by copies (peer copies between cards);
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
while no profiler runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "any_true", "all_to_all", "cat", "shift", "EXCHANGE_RANGE",
           "GATHER_RANGE"]

EXCHANGE_RANGE = "distributed exchange"
GATHER_RANGE = "distributed all-gather"

_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def cat(xs, device=None) -> torch.Tensor:
    """``torch.cat`` of 1-D tensors of one dtype on ``device``; unsigned
    dtypes are joined as their signed views (not every device has unsigned
    kernels)."""
    dtype = xs[0].dtype
    sdt = _SIGNED_VIEW.get(dtype, dtype)
    return torch.cat([x.reshape(-1).view(sdt).to(device or x.device) for x in xs]).view(dtype)


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


def all_to_all(mesh, pieces, sizes):
    """Exact-count exchange. ``pieces[i][d]``: the 1-D tensor local slot i
    sends to global slot d (one dtype throughout); ``sizes[s][d]``: the
    length of what slot s sends to slot d, for every pair (host ints, the
    same on every process). Returns ``recv`` with ``recv[j][s]`` what
    global slot s sent to local slot j, on slot j's device; concatenated in
    s order it lands source-major."""
    P, local = mesh.size, mesh.local
    if not mesh.multiprocess:
        return [[pieces[local.index(s)][d].to(dev) for s in range(P)]
                for d, dev in zip(local, mesh.devices)]
    dtype = pieces[0][0].dtype
    item = torch.empty((), dtype=dtype).element_size()
    procs = range(mesh.num_processes)
    slots_of = {r: [s for s in range(P) if mesh.owners[s] == r] for r in procs}
    # send order: destination process, its slots, then this process's slots
    send = [pieces[i][d] for r in procs for d in slots_of[r] for i in range(len(local))]
    in_split = [item * sum(sizes[s][d] for d in slots_of[r] for s in local) for r in procs]
    out_split = [item * sum(sizes[s][d] for d in local for s in slots_of[r]) for r in procs]
    sbuf = _bytes(torch.cat([p.to(mesh.home) for p in send])) if send else None
    rbuf = torch.empty((sum(out_split),), dtype=torch.uint8, device=mesh.home)
    if sbuf is None or sbuf.numel() == 0:
        sbuf = torch.empty((0,), dtype=torch.uint8, device=mesh.home)
    dist.all_to_all_single(rbuf, sbuf, out_split, in_split)
    recv = [[None] * P for _ in local]
    off = 0
    for r in procs:  # each source process packed (our slot, its slot)
        for j, d in enumerate(local):
            for s in slots_of[r]:
                nb = item * sizes[s][d]
                recv[j][s] = rbuf[off:off + nb].view(dtype).to(mesh.devices[j])
                off += nb
    return recv


def shift(mesh, xs, offset: int):
    """Neighbour shift (the JAX package's ``ppermute`` by ``offset`` slots):
    ``xs[i]``, local slot i's 1-D tensor (one shape and dtype on every
    slot), goes to global slot ``slot + offset``. Returns one tensor per
    local slot, on its device: what slot ``slot - offset`` sent, or zeros
    where there is no such slot. Runs in :data:`EXCHANGE_RANGE`."""
    P = mesh.size
    n = xs[0].shape[0]
    with torch.profiler.record_function(EXCHANGE_RANGE):
        if not mesh.multiprocess:
            src = {s: x for s, x in zip(mesh.local, xs)}
            return [src[d - offset].to(dev) if 0 <= d - offset < P
                    else torch.zeros_like(xs[0], device=dev)
                    for d, dev in zip(mesh.local, mesh.devices)]
        # an exact-count exchange with one non-empty piece per source
        sizes = [[n if d == s + offset else 0 for d in range(P)] for s in range(P)]
        pieces = [[x if d == s + offset else x[:0] for d in range(P)]
                  for s, x in zip(mesh.local, xs)]
        recv = all_to_all(mesh, pieces, sizes)
        return [recv[j][d - offset] if 0 <= d - offset < P
                else torch.zeros_like(xs[0], device=dev)
                for j, (d, dev) in enumerate(zip(mesh.local, mesh.devices))]
