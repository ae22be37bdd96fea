"""Distributed sort: a range-partitioned exchange over the slots of a mesh.

Counterpart of ``radix_sort_tpu/parallel/dist_sort.py``, the same algorithm
(parallel sort by regular sampling with composite tie-broken splitters):

  1. a stable local sort of each slot's rows;
  2. every slot contributes ``m`` evenly spaced samples of its sorted rows;
     the gathered sketch's quantiles become the P-1 global splitters. The
     splitters and the routing use the composite order ``(key, slot-major
     position)``: position breaks ties, so duplicate keys (the reference's
     StepUniform regime, src/distr.rs:78-106, and the all-equal worst
     case) split evenly across slots, and every slot receives at most
     :func:`exchange_capacity` rows for any input;
  3. an exact-count exchange of each slot's per-destination runs, landing
     source-major in the destination's buffer
     (:func:`collectives.all_to_all`);
  4. a final stable local sort of the received rows; padding stays at the
     tail (sentinel keys, zero values).

Equal keys keep global input order: routing orders ties by source
position, the exchange lands runs in source-slot order, and both local
sorts are stable. Positions are int32 ``slot * n_local + i``, so fewer than
2**31 rows in all.

The output is range-ragged: slot s holds ``counts[s]`` valid rows padded to
a per-slot capacity, and the concatenated valid prefixes (in slot order)
are the sorted rows. If the exchange exceeds the capacity (impossible at
the provisioned bound, reachable through the ``capacity=`` override), the
entry points fall back to a replicated global sort laid out the same way
and report ``overflow``: the result is always exact.

Differences from the reference: rank words are the port's signed words
(``keys.encode``), so limb sentinels are the signed maxima, the same bits
as the reference's unsigned maxima after decoding; the run starts are read
with ``searchsorted`` for one-word keys (the same counts as the
reference's compare-sum); sample positions are computed in int64 (the
reference's int32 ``arange(m) * n_local`` wraps once ``m * n_local``
reaches 2**31, e.g. at 62.5M rows a slot on 4 slots); and the overflow
fallback is a host branch on one synchronised flag where the reference
uses ``lax.cond``.
"""

from __future__ import annotations

import torch

from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import query as Q
from radix_sort_tpu_torch.parallel import collectives as C
from radix_sort_tpu_torch.parallel.runtime import Sharded, local_blocks

__all__ = [
    "default_exchange",
    "distributed_sort",
    "distributed_sort_pairs",
    "distributed_sort_limbs",
    "exchange_capacity",
    "EXCHANGES",
]

EXCHANGES = ("ragged", "gather", "pipelined")


def _num_samples(n_local: int, num_slots: int) -> int:
    """Samples per slot for the splitter sketch: ``m = 8 P**2`` bounds the
    largest bucket at ``n/P (1 + 1/8)`` plus the sampling-gap slack, capped
    by the shard size and floored for tiny meshes."""
    return max(64, min(n_local, 8 * num_slots * num_slots))


def exchange_capacity(n_local: int, num_slots: int) -> int:
    """Deterministic per-slot receive bound of the regular-sampled composite
    partition: ``n/P + 2 P gap`` (composite keys are duplicate-free, so it
    holds for every input), plus ``P`` for boundary rounding, rounded up to
    a multiple of 8 (the reference's bound, bit for bit)."""
    m = _num_samples(n_local, num_slots)
    gap = -(-n_local // m) + 1
    cap = n_local + (num_slots * num_slots * n_local) // m
    cap += 2 * num_slots * gap + num_slots + 64
    return -(-cap // 8) * 8


def default_exchange() -> str:
    """``"ragged"`` everywhere: the port has an exact-count exchange on
    every device (the JAX package falls back to ``"gather"`` off the TPU)."""
    return "ragged"


def _sample_positions(n_local: int, m: int, device) -> torch.Tensor:
    """Midpoints of the m equal strides through a sorted shard (int64)."""
    pos = torch.arange(m, dtype=torch.int64, device=device) * n_local // m
    return pos + n_local // (2 * m)


def _sketch_quantiles(mesh, samp_ws, samp_p, per_slot):
    """Gather every slot's ``(key limbs..., pos)`` samples (lists over local
    slots), sort the pooled sketch in the composite order and return the
    P-1 quantile splitters ``(limb list, positions)`` on ``mesh.home``."""
    nk = len(samp_ws[0])
    sk = [C.all_gather(mesh, [ws[k] for ws in samp_ws]) for k in range(nk)]
    sk_p = C.all_gather(mesh, samp_p)
    out = Q._stable_sort(sk + [sk_p], num_keys=nk + 1)
    ranks = (torch.arange(mesh.size - 1, dtype=torch.int64, device=mesh.home) + 1) * per_slot - 1
    return [w[ranks] for w in out[:-1]], out[-1][ranks]


def _composite_splitters(mesh, s_limbs):
    """(P-1) composite splitters ``(key limbs..., slot-major sorted
    position)`` from each local slot's sorted limb list ``s_limbs[i]``.
    Among equal keys the stable local sort keeps input order, so sorted
    positions rank ties exactly as input positions do."""
    n_local = s_limbs[0][0].shape[0]
    m = _num_samples(n_local, mesh.size)
    ws, ps = [], []
    for limbs, r in zip(s_limbs, mesh.local):
        pos = _sample_positions(n_local, m, limbs[0].device)
        ws.append([w[pos] for w in limbs])
        ps.append((r * n_local + pos).to(torch.int32))
    return _sketch_quantiles(mesh, ws, ps, m)


def _lex_below(ws, p, sws, sp):
    """Row-wise ``(ws..., p) < (sws..., sp)`` in lexicographic order."""
    below = p < sp
    for w, sw in zip(reversed(ws), reversed(sws)):
        below = (w < sw) | ((w == sw) & below)
    return below


def _lex_ge(ws, p, sws, sp):
    """Row-wise ``(ws..., p) >= (sws..., sp)`` in lexicographic order."""
    ge = p >= sp
    for w, sw in zip(reversed(ws), reversed(sws)):
        ge = (w > sw) | ((w == sw) & ge)
    return ge


def _below_counts(s_limbs, base, sws, sp):
    """The count of rows below each composite splitter ``(sws..., sp)``
    (on the shard's device), for a shard whose row i has position
    ``base + i``: the reference's compare-sum, one splitter at a time."""
    p = base + torch.arange(s_limbs[0].shape[0], dtype=torch.int64, device=sp.device)
    return torch.stack([_lex_below(s_limbs, p, [w[t] for w in sws], sp[t]).sum()
                        for t in range(sp.shape[0])]) if sp.shape[0] else sp


def _below_starts(s_limbs, base, sws, sp):
    """Run starts ``(P,)`` int64: 0, then the count of rows below each
    composite splitter, for a shard sorted by ``(key limbs, position)``
    whose row i has position ``base + i``. One word: the equal-key run of
    each splitter from ``searchsorted``, cut at its position (the same
    counts as :func:`_below_counts`, without its pass over the shard per
    splitter). Several limbs: :func:`_below_counts`."""
    dev = s_limbs[0].device
    sws = [w.to(dev) for w in sws]
    sp = sp.to(dev, torch.int64)
    if len(s_limbs) == 1:
        w = s_limbs[0]
        lo = torch.searchsorted(w, sws[0], side="left")
        hi = torch.searchsorted(w, sws[0], side="right")
        starts = torch.minimum(torch.maximum(sp - base, lo), hi)
    else:
        starts = _below_counts(s_limbs, base, sws, sp)
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev), starts.to(torch.int64)])


def _key_splitters(mesh, s_words):
    """Key-only regular-sampled splitters (no position tiebreak) from each
    local slot's sorted routing word ``s_words[i]``: for consumers that
    must co-locate equal keys (joins, the shuffle aggregate). Balance is
    then input-dependent and overflow is flagged by the caller."""
    n_local = s_words[0].shape[0]
    m = _num_samples(n_local, mesh.size)
    sketch = C.all_gather(mesh, [w[_sample_positions(n_local, m, w.device)] for w in s_words])
    sketch = torch.sort(sketch).values
    ranks = (torch.arange(mesh.size - 1, dtype=torch.int64, device=mesh.home) + 1) * m - 1
    return sketch[ranks]


def _key_starts(s_word, splitters):
    """Key-only run starts ``(P,)`` int64 (equal keys co-locate)."""
    starts = torch.searchsorted(s_word, splitters.to(s_word.device), side="left")
    return torch.cat([starts.new_zeros((1,)), starts])


def _fill(t, fill, n):
    return torch.full((n,), fill, dtype=t.dtype, device=t.device)


def _ragged_exchange(mesh, slot_ops, fills, slot_starts, capacity):
    """Exchange each local slot's per-destination runs of every operand
    (``slot_ops[i]``, runs ``[starts[d], starts[d+1])``, the last ending at
    n_local). Every size comes from the gathered start matrix, so senders
    and receivers clamp identically even when a capacity override forces
    overflow. Returns ``(received ops per local slot, received count of
    every slot, overflow, sizes sz[src][dst] of the landed runs)``; slot
    d's buffer holds the runs of sources 0, 1, ... back to back."""
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
    with torch.profiler.record_function(C.EXCHANGE_RANGE):
        for k, fill in enumerate(fills):
            pieces = [[ops[k][starts[s][d]:starts[s][d] + sz[s][d]] for d in range(P)]
                      for ops, s in zip(slot_ops, mesh.local)]
            recv = C.all_to_all(mesh, pieces, sz)
            for j, d in enumerate(mesh.local):
                got = recv[j]
                outs[j].append(torch.cat(got + [_fill(got[0], fill, capacity - recv_n[d])]))
    return outs, recv_n, overflow, sz


def _gather_exchange(mesh, slot_ops, fills, bounds, capacity, num_keys):
    """The all-gather exchange: every slot gathers all shards (slot-major,
    so the flat index orders ties by input position) and keeps its own
    splitter range, stably sorted. P times the wire bytes of the ragged
    exchange; the reference's off-TPU path. ``bounds``: ``("composite",
    (limb list, positions))`` or ``("key", splitters)`` on the leading
    word. Returns ``(ops per local slot, count of every slot, overflow)``.
    The rows' all-gather is this mode's exchange, and profiles as one."""
    P = mesh.size
    g = [C.all_gather(mesh, [ops[k] for ops in slot_ops], label=C.EXCHANGE_RANGE)
         for k in range(len(fills))]
    n_total = g[0].shape[0]
    kind, lim = bounds
    outs, n_valid = [], []
    for me in mesh.local:
        if kind == "composite":
            sws, sp = lim
            gpos = torch.arange(n_total, dtype=torch.int64, device=mesh.home)
            ks = g[:num_keys]
            ge_lo = (_lex_ge(ks, gpos, [w[me - 1] for w in sws], sp[me - 1]) if me > 0
                     else torch.ones_like(gpos, dtype=torch.bool))
            lt_hi = (~_lex_ge(ks, gpos, [w[me] for w in sws], sp[me]) if me < P - 1
                     else torch.ones_like(gpos, dtype=torch.bool))
        else:
            w = g[0]
            ge_lo = w >= lim[me - 1] if me > 0 else torch.ones_like(w, dtype=torch.bool)
            lt_hi = w < lim[me] if me < P - 1 else torch.ones_like(w, dtype=torch.bool)
        idx = torch.nonzero(ge_lo & lt_hi).reshape(-1)
        nv = idx.shape[0]
        take = min(nv, capacity)
        srt = Q._stable_sort([Q._take(x, idx) for x in g], num_keys)
        outs.append([torch.cat([x[:take], _fill(x, f, capacity - take)])
                     for x, f in zip(srt, fills)])
        n_valid.append(nv)
    every = C.all_gather(mesh, [torch.tensor([nv], dtype=torch.int64, device=mesh.home)
                                for nv in n_valid]).tolist()
    overflow = any(nv > capacity for nv in every)
    dev_outs = [[x.to(dev) for x in ops] for ops, dev in zip(outs, mesh.devices)]
    return dev_outs, [min(nv, capacity) for nv in every], overflow


def _final_sort(ops, nk, n_valid, fills):
    """Stable sort of the valid prefix by its nk key operands; the padding
    tail (sentinel keys, zero values) stays behind it, as the reference's
    sort with a leading invalid flag leaves it."""
    srt = Q._stable_sort([x[:n_valid] for x in ops], nk)
    return [torch.cat([s, x[n_valid:]]) for s, x in zip(srt, ops)]


def _pipelined_exchange(mesh, words, values, capacity, sentinel, stripes=2):
    """The striped exchange: each slot's rows split into ``stripes``
    stripes, each sorted, routed and exchanged on its own, with one union
    sketch over all stripes. Every row carries the monotone position
    surrogate ``src_slot * n_local + stripe * stripe_len + sorted index``,
    and the final merge sorts by ``(key, surrogate)``, so global stability
    holds exactly. ``words`` / ``values``: one tensor (or None) per local
    slot. Returns ``(words, values or None, counts, overflow)``."""
    P = mesh.size
    n_local = words[0].shape[0]
    if n_local % stripes:
        raise ValueError(f"n_local ({n_local}) must be divisible by stripes")
    sl = n_local // stripes
    has_vals = values is not None
    srt = [[Q._stable_sort([w[s * sl:(s + 1) * sl]]
                           + ([v[s * sl:(s + 1) * sl]] if has_vals else []), 1)
            for s in range(stripes)] for w, v in zip(words, values or [None] * len(words))]
    m = _num_samples(sl, P)
    ws, ps = [], []
    for st, r in zip(srt, mesh.local):
        pos = _sample_positions(sl, m, st[0][0].device)
        ws.append([torch.cat([st[s][0][pos] for s in range(stripes)])])
        ps.append(torch.cat([r * n_local + s * sl + pos for s in range(stripes)]).to(torch.int32))
    sws, sp = _sketch_quantiles(mesh, ws, ps, stripes * m)
    fills = [sentinel] + ([0] if has_vals else [])
    got = [[] for _ in mesh.local]  # per local slot: (words, values, surrogate) per stripe
    overflow = False
    for s in range(stripes):
        starts = [_below_starts([st[s][0]], r * n_local + s * sl, sws, sp)
                  for st, r in zip(srt, mesh.local)]
        recv, recv_n, ovf, sz = _ragged_exchange(mesh, [st[s] for st in srt], fills, starts,
                                                 capacity)
        overflow |= ovf
        for j, d in enumerate(mesh.local):
            dev = recv[j][0].device
            sur = torch.cat([torch.arange(sz[src][d], dtype=torch.int32, device=dev)
                             + (src * n_local + s * sl) for src in range(P)])
            got[j].append([x[:recv_n[d]] for x in recv[j]] + [sur])
    out_w, out_v, counts, flags = [], [], [], []
    for j, d in enumerate(mesh.local):
        parts = got[j]
        n_valid = sum(p[0].shape[0] for p in parts)
        w = torch.cat([p[0] for p in parts])
        sur = torch.cat([p[-1] for p in parts])
        ops = [w, sur] + ([torch.cat([p[1] for p in parts])] if has_vals else [])
        merged = Q._stable_sort(ops, 2)
        take = min(n_valid, capacity)
        out_w.append(torch.cat([merged[0][:take], _fill(w, sentinel, capacity - take)]))
        if has_vals:
            out_v.append(torch.cat([merged[2][:take], _fill(merged[2], 0, capacity - take)]))
        counts.append(torch.tensor([take], dtype=torch.int64, device=mesh.home))
        flags.append(torch.tensor(n_valid > capacity))
    counts = C.all_gather(mesh, counts).tolist()
    return (out_w, out_v if has_vals else None, counts,
            overflow or C.any_true(mesh, flags))


def _local_exchange(mesh, key_ops, val_ops, capacity, sentinel, splitters=None,
                    exchange=None):
    """The distributed body: ``key_ops[i]`` / ``val_ops[i]`` are local slot
    i's key limb list and value list (one slot's operands share a length).

    ``splitters``: optional key-only (P-1,) splitters on the leading limb
    (a join routing both sides on one shared sketch: equal tuples share the
    leading limb, so they still co-locate); when None, composite
    regular-sampled ``(key limbs..., position)`` splitters are drawn from
    this data. ``exchange``: ``"ragged"`` (default), ``"gather"`` or
    ``"pipelined"`` (one key word and at most one value operand, own
    splitters). Returns ``(key ops per local slot, value ops per local
    slot, counts of every slot, overflow)``."""
    exchange = exchange or default_exchange()
    nk = len(key_ops[0])
    if exchange == "pipelined":
        if splitters is not None:
            raise ValueError("pipelined exchange draws its own splitters")
        if nk > 1 or len(val_ops[0]) > 1:
            raise ValueError("pipelined exchange supports single-word keys")
        vals = [v[0] for v in val_ops] if val_ops[0] else None
        w, v, counts, overflow = _pipelined_exchange(
            mesh, [k[0] for k in key_ops], vals, capacity, sentinel)
        return ([[x] for x in w], [[x] for x in v] if v is not None else [[] for _ in w],
                counts, overflow)
    sorted_ops = [Q._stable_sort(k + v, nk) for k, v in zip(key_ops, val_ops)]
    fills = ([sentinel] + [torch.iinfo(w.dtype).max for w in key_ops[0][1:]]
             + [0] * len(val_ops[0]))
    if splitters is None:
        bounds = ("composite", _composite_splitters(mesh, [ops[:nk] for ops in sorted_ops]))
    else:
        bounds = ("key", splitters)
    if exchange == "gather":
        recv, counts, overflow = _gather_exchange(mesh, sorted_ops, fills, bounds, capacity, nk)
        return [x[:nk] for x in recv], [x[nk:] for x in recv], counts, overflow
    n_local = sorted_ops[0][0].shape[0]
    if bounds[0] == "composite":
        sws, sp = bounds[1]
        starts = [_below_starts(ops[:nk], r * n_local, sws, sp)
                  for ops, r in zip(sorted_ops, mesh.local)]
    else:
        starts = [_key_starts(ops[0], splitters) for ops in sorted_ops]
    recv, counts, overflow, _ = _ragged_exchange(mesh, sorted_ops, fills, starts, capacity)
    recv = [_final_sort(ops, nk, counts[d], fills) for ops, d in zip(recv, mesh.local)]
    return [x[:nk] for x in recv], [x[nk:] for x in recv], counts, overflow


def _route_home(mesh, slot_pos, slot_cols, n_local):
    """Send rows home by global position (the reference's exchange by fixed
    position splitters ``(d+1) * n_local``). ``slot_pos[i]``: the int32 or
    int64 global positions of local slot i's rows, ``slot_cols[i]`` a list
    of 1-D columns of the same length. Across all slots every position in
    ``[0, P n_local)`` appears exactly once, so every destination receives
    exactly its ``n_local`` rows and the route cannot overflow (positions
    may also end early: the rows past the last one are zeros). Returns, per
    local slot, its columns in position order (a scatter by position, no
    sort)."""
    P = mesh.size
    cuts = [(d + 1) * n_local for d in range(P - 1)]
    srt, sizes_local = [], []
    for pos, cols in zip(slot_pos, slot_cols):
        sp, order = torch.sort(pos.to(torch.int64), stable=True)
        srt.append((sp, [Q._signed(c)[order] for c in cols]))
        bounds = torch.searchsorted(sp, torch.tensor(cuts, dtype=torch.int64,
                                                     device=sp.device))
        edges = torch.cat([sp.new_zeros((1,)), bounds, sp.new_full((1,), sp.shape[0])])
        sizes_local.append(edges[1:] - edges[:-1])
    sizes = C.all_gather(mesh, sizes_local).reshape(P, P).tolist()
    starts = [[sum(sizes[s][:d]) for d in range(P)] for s in range(P)]
    ncols = len(slot_cols[0])
    with torch.profiler.record_function(C.EXCHANGE_RANGE):
        got = []
        for k in range(ncols + 1):
            pieces = []
            for (sp, cs), s in zip(srt, mesh.local):
                x = sp if k == 0 else cs[k - 1]
                pieces.append([x[starts[s][d]:starts[s][d] + sizes[s][d]] for d in range(P)])
            got.append(C.all_to_all(mesh, pieces, sizes))
    outs = []
    for j, d in enumerate(mesh.local):
        pos = torch.cat(got[0][j]) - d * n_local
        cols = []
        for k, src in enumerate(slot_cols[0]):
            vals = torch.cat(got[k + 1][j])
            out = torch.zeros((n_local,), dtype=vals.dtype, device=vals.device)
            out[pos] = vals
            cols.append(out.view(src.dtype))
        outs.append(cols)
    return outs


def _global_sort_fallback(mesh, limbs, vals, capacity, fills):
    """The replicated exact path in the padded per-slot layout (overflow
    insurance): gather every input operand, sort once, give slot s rows
    ``[s n_local, (s+1) n_local)`` plus padding. Inputs and outputs are
    per-local-slot lists."""
    nk = len(limbs[0])
    n_local = limbs[0][0].shape[0]
    g = [C.all_gather(mesh, [ops[k] for ops in limbs]) for k in range(nk)]
    g += [C.all_gather(mesh, [ops[k] for ops in vals]) for k in range(len(vals[0]))]
    srt = Q._stable_sort(g, nk)
    outs = []
    for s, dev in zip(mesh.local, mesh.devices):
        outs.append([torch.cat([x[s * n_local:(s + 1) * n_local],
                                _fill(x, f, capacity - n_local)]).to(dev)
                     for x, f in zip(srt, fills)])
    return [o[:nk] for o in outs], [o[nk:] for o in outs]


def _counts_tensor(mesh, counts):
    return torch.tensor(counts, dtype=torch.int32, device=mesh.home)


def _dist_sort_impl(mesh, limbs, vals, capacity=None, exchange=None):
    """Core distributed sort over per-local-slot key limb lists ``limbs``
    and value lists ``vals``. Returns ``(key limb lists, value lists,
    counts (P,) int32, overflow 0-dim bool)``, lists per local slot."""
    nk, nv = len(limbs[0]), len(vals[0])
    P = mesh.size
    n_local = limbs[0][0].shape[0]
    for ops in [*limbs, *vals]:
        if any(x.shape[0] != n_local for x in ops):
            raise ValueError("all key/value operands must share a length")
    n = n_local * P
    if n >= 2**31:
        # routing and stability tiebreaks use int32 positions
        raise ValueError(f"distributed sort supports < 2**31 total rows (got {n}): "
                         "int32 position tiebreaks")
    if exchange not in (None,) + EXCHANGES:
        raise ValueError("exchange must be one of None (auto), 'ragged', 'gather', "
                         f"'pipelined'; got {exchange!r}")
    if exchange == "pipelined" and (nk > 1 or nv > 1):
        raise ValueError("pipelined exchange supports one key word and at most one value "
                         "operand")
    if capacity is None:
        capacity = exchange_capacity(n_local, P)
    if capacity < n_local:
        raise ValueError(f"capacity ({capacity}) must be >= n_local ({n_local})")
    sentinel = torch.iinfo(limbs[0][0].dtype).max
    fills = [sentinel] + [torch.iinfo(w.dtype).max for w in limbs[0][1:]] + [0] * nv
    no = torch.tensor(False, device=mesh.home)
    if P == 1:
        # degenerate mesh: the local stable sort in the padded layout
        ow, ov = _global_sort_fallback(mesh, limbs, vals, capacity, fills)
        return ow, ov, _counts_tensor(mesh, [n_local]), no
    ow, ov, counts, overflow = _local_exchange(mesh, limbs, vals, capacity, sentinel,
                                               exchange=exchange)
    if overflow:
        # the replicated fallback gathers the whole input: it runs only here
        ow, ov = _global_sort_fallback(mesh, limbs, vals, capacity, fills)
        counts = [n_local] * P
    return ow, ov, _counts_tensor(mesh, counts), torch.tensor(overflow, device=mesh.home)


def _encode_key_arg(mesh, keys, descending=False):
    """A public key operand -> (per-local-slot limb lists, decode). One
    column encodes to one rank word of its width; a column list to int32
    limbs. ``descending`` complements every word (stable-descending)."""
    if isinstance(keys, (list, tuple)):
        blocks = [local_blocks(mesh, c) for c in keys]
        limbs, specs = [], None
        for i in range(len(mesh.local)):
            ls, specs = Q._cols_to_limbs([b[i] for b in blocks])
            limbs.append([~w for w in ls] if descending else ls)

        def decode(ows):
            cols = [Q._limbs_to_cols([~w for w in ws] if descending else ws, specs)
                    for ws in ows]
            return [Sharded(mesh, [c[k] for c in cols]) for k in range(len(specs))]

        return limbs, decode
    blocks = local_blocks(mesh, keys)
    dtype = blocks[0].dtype
    limbs = [[~K.encode(b) if descending else K.encode(b)] for b in blocks]

    def decode1(ows):
        return Sharded(mesh, [K.decode(~ws[0] if descending else ws[0], dtype) for ws in ows])

    return limbs, decode1


def _value_arg(mesh, values, n_slots):
    """A public value operand -> (per-local-slot value lists, wrap)."""
    if values is None:
        return [[] for _ in range(n_slots)], lambda ovs: None
    multi = isinstance(values, (list, tuple))
    blocks = [local_blocks(mesh, v) for v in (values if multi else [values])]
    vals = [[Q._signed(b[i]) for b in blocks] for i in range(n_slots)]
    dts = [b[0].dtype for b in blocks]

    def wrap(ovs):
        cols = [Sharded(mesh, [ov[k].view(dt) for ov in ovs]) for k, dt in enumerate(dts)]
        return cols if multi else cols[0]

    return vals, wrap


def distributed_sort(keys, mesh, *, descending: bool = False, capacity: int | None = None,
                     exchange: str | None = None):
    """Sort ``keys`` (a :class:`Sharded` column on ``mesh`` or a global
    tensor, which is sharded first; or a list of equal-length columns,
    sorted lexicographically, primary first, and returned as a list).

    Returns ``(sorted, counts, overflow)``: ``sorted`` is sharded with
    ``capacity`` rows a slot (default :func:`exchange_capacity`), slot s's
    first ``counts[s]`` rows valid; the concatenated valid prefixes are the
    stable sort in total_cmp float order. ``descending=True`` reverses the
    key order, equal keys keeping input order. If the exchange overflows
    (only reachable through ``capacity=``) the result comes from a
    replicated global sort laid out the same way, and ``overflow`` is
    True. ``exchange``: ``"ragged"`` (default), ``"gather"`` or
    ``"pipelined"``; the concatenated result is the same for each.
    """
    limbs, decode = _encode_key_arg(mesh, keys, descending)
    ows, _, counts, overflow = _dist_sort_impl(mesh, limbs, [[] for _ in limbs], capacity,
                                               exchange)
    return decode(ows), counts, overflow


def distributed_sort_pairs(keys, values, mesh, *, descending: bool = False,
                           capacity: int | None = None, exchange: str | None = None):
    """Key/payload variant of :func:`distributed_sort` (stable). ``keys``
    and ``values`` may each be column lists. Returns ``(sorted keys,
    values, counts, overflow)``."""
    limbs, decode = _encode_key_arg(mesh, keys, descending)
    vals, wrap = _value_arg(mesh, values, len(limbs))
    ows, ovs, counts, overflow = _dist_sort_impl(mesh, limbs, vals, capacity, exchange)
    return decode(ows), wrap(ovs), counts, overflow


def distributed_sort_limbs(limbs, values=None, *, mesh, descending: bool = False,
                           capacity: int | None = None, exchange: str | None = None):
    """Raw multi-word variant: ``limbs`` is a list of big-endian rank words
    already in the port's signed rank space (e.g. ``keys.encode128``'s
    int32 limbs). Returns ``(sorted limbs, values, counts, overflow)`` in
    the padded per-slot layout of :func:`distributed_sort`."""
    if not isinstance(limbs, (list, tuple)) or not limbs:
        raise ValueError("limbs must be a non-empty list of limb arrays")
    blocks = [local_blocks(mesh, w) for w in limbs]
    for b in blocks:
        if b[0].dtype not in (torch.int8, torch.int16, torch.int32, torch.int64):
            raise ValueError(f"limbs must be signed rank-space words, got {b[0].dtype}")
    slot_limbs = [[~b[i] if descending else b[i] for b in blocks]
                  for i in range(len(mesh.local))]
    vals, wrap = _value_arg(mesh, values, len(slot_limbs))
    ows, ovs, counts, overflow = _dist_sort_impl(mesh, slot_limbs, vals, capacity, exchange)
    out = [Sharded(mesh, [~ws[k] if descending else ws[k] for ws in ows])
           for k in range(len(limbs))]
    return out, wrap(ovs), counts, overflow
