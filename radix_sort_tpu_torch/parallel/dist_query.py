"""Distributed query operators over the slots of a mesh.

Counterpart of ``radix_sort_tpu/parallel/dist_query.py``, the same plans:

  * combinable GROUP BY, DISTINCT and the set operators: a local partial
    per slot, an all-gather of the padded partials, one replicated combine;
  * holistic GROUP BY (first, last, median, ...): a shuffle by key with one
    shared splitter sketch (``dist_sort``'s key-only exchange), so each
    group lands whole on one slot, the exact single-device aggregate there,
    then the gather and combine;
  * the equi-join: both sides routed with one shared sketch, a local
    sort-merge join per slot whose expansion is kernel K2
    (``query.join_expand``), full joins completed per slot;
  * top-k, quantiles, filter and repeat (UNNEST, K2 per slot).

Inputs are :class:`~.runtime.Sharded` columns (or global tensors, sharded
first). Per-slot results come back sharded with a count per slot;
replicated results as tensors on ``mesh.home``. Every operator whose
local capacity can be breached (``max_groups``, ``max_unique``, an
exchange buffer, a join's ``capacity_per_shard``) falls back to the exact
replicated single-device operator laid out the same way; ``overflow`` then
reports only a truncation of the global capacity. The JAX package decides
that branch on the device (``lax.cond``); here the host reads one
synchronised flag.
"""

from __future__ import annotations

import math

import torch

from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import query as Q
from radix_sort_tpu_torch.ops import relational
from radix_sort_tpu_torch.parallel import collectives as C
from radix_sort_tpu_torch.parallel import dist_sort
from radix_sort_tpu_torch.parallel.runtime import Sharded, gather_rows, local_blocks

__all__ = [
    "distributed_hash_aggregate",
    "distributed_filter",
    "distributed_hash_join",
    "distributed_repeat",
    "distributed_unique",
    "distributed_top_k",
    "distributed_quantiles",
    "distributed_set_union",
    "distributed_set_intersect",
    "distributed_set_difference",
]

_INT32_MAX = (1 << 31) - 1
_MSB = 1 << 31


def _mix_limbs(limbs):
    """Routing word for composite keys: the reference's multiplicative hash
    folded over its unsigned limbs (``h = (h ^ w) * 0x9E3779B1`` mod
    2**32), computed on the port's signed limbs and returned as a signed
    rank word of the same order. Equal tuples share it (co-location) while
    its cardinality is the tuple's."""
    h = 0x9E3779B9
    for w in limbs:
        u = (w.to(torch.int64) & 0xFFFFFFFF) ^ _MSB
        h = ((h ^ u) * 0x9E3779B1) & 0xFFFFFFFF
    return (h ^ _MSB).to(torch.int32)


def _identity(dtype, combine):
    """The combine's identity, as a scalar of ``dtype``'s signed view
    (``query._signed``): padding rows carry it into the final combine."""
    if combine in ("sum", "count", "any"):
        return 0
    if combine == "all":
        return 1
    if dtype == torch.bool:
        return combine == "min"
    if dtype.is_floating_point:
        return math.inf if combine == "min" else -math.inf
    if dtype in Q._SIGNED_VIEW:  # uint16/32/64 seen as signed: max is all ones
        return -1 if combine == "min" else 0
    info = torch.iinfo(dtype)
    return info.max if combine == "min" else info.min


def _where(mask, a, b):
    """``where(mask, a, b)`` in ``a``'s dtype; ``b`` a tensor of that dtype
    or a scalar of its signed view."""
    sa = Q._signed(a)
    sb = (Q._signed(b) if torch.is_tensor(b)
          else torch.tensor(b, dtype=sa.dtype, device=sa.device))
    return torch.where(mask, sa, sb).view(a.dtype)


def _pad(a, rows):
    """``a`` zero-padded or cut to exactly ``rows`` rows."""
    return Q._fit(Q._signed(a), rows).view(a.dtype)


def _blocks(mesh, cols):
    return [local_blocks(mesh, c) for c in cols]


def _per_slot(blocks, i):
    return [b[i] for b in blocks]


def _gather_valid(mesh, slot_cols, slot_valid):
    """All-gather each column of the padded per-slot partials and their
    validity (lists over local slots)."""
    g = [C.all_gather(mesh, [cols[k] for cols in slot_cols]) for k in range(len(slot_cols[0]))]
    return g, C.all_gather(mesh, slot_valid)


def _combine(gkeys, gouts, gvalid, combines, single=False):
    """The replicated combine of gathered partials: padding rows are
    re-keyed to the first valid row anywhere and carry the combine's
    identity, so they add nothing and make no group. ``single``: one
    output through ``hash_aggregate``'s one-value form, as the reference
    calls it there. Returns ``(key cols, out cols, count)``; the count is 0
    when no row is valid."""
    any_valid = gvalid.any()
    a_idx = gvalid.to(torch.int32).argmax()
    keys2 = [_where(gvalid, g, Q._take(g, a_idx)) for g in gkeys]
    outs2 = [_where(gvalid, g, _identity(g.dtype, c)) for g, c in zip(gouts, combines)]
    fk, fo, fc = Q.hash_aggregate(keys2 if len(keys2) > 1 else keys2[0],
                                  outs2[0] if single else outs2,
                                  combines[0] if single else combines)
    fk = list(fk) if len(keys2) > 1 else [fk]
    return fk, [fo] if single else list(fo), torch.where(any_valid, fc, 0)


def _fallback(overflow, primary, global_op, total_cap):
    """Exact insurance for the partial plans: on overflow the exact
    single-device operator over the gathered global rows (``global_op()``
    -> ``(key cols, out cols, count)``) replaces ``primary``, padded or cut
    to ``total_cap`` rows; its overflow is then only a truncation of
    ``total_cap``. Returns ``(key cols, out cols, count, overflow)``."""
    if not overflow:
        ks, outs, cnt = primary
        return ks, outs, cnt, torch.tensor(False, device=cnt.device)
    fk, fo, fc = global_op()
    fk = [_pad(a, total_cap) for a in (fk if isinstance(fk, (list, tuple)) else [fk])]
    fo = [_pad(a, total_cap) for a in (fo if isinstance(fo, (list, tuple)) else [fo])]
    return fk, fo, fc.clamp(max=total_cap), fc > total_cap


def _check_aggs(aggs):
    for a in aggs:
        if not Q.valid_agg(a):
            raise ValueError(f"agg must be one of {Q.AGGREGATIONS} or 'quantile:<q>', got {a!r}")


def distributed_hash_aggregate(keys, values, mesh, agg="sum", *, max_groups: int,
                               exchange_capacity_factor: float = 2.0):
    """Group-by + reduce over sharded keys/values.

    Combinable aggregations (sum/count/min/max/mean/any/all) run the
    two-phase plan: a per-slot aggregate padded to ``max_groups`` rows, an
    all-gather of the partials and a replicated combine. Holistic ones
    (first/last/median/mode/var/std/count_distinct/argmin/argmax/quantiles)
    run the shuffle plan (``exchange_capacity_factor`` provisions each
    slot's receive buffer against key skew). Returns replicated
    ``(unique_keys, aggregates, count, overflow)``: rows [0, count) are the
    groups in ascending key order. When any slot breaches ``max_groups`` or
    a receive buffer the exact single-device aggregate runs instead, so the
    result is exact unless even ``P * max_groups`` truncates the group
    count, which ``overflow`` then reports.

    ``keys`` may be a column list (composite GROUP BY; ``unique_keys`` is
    then a list); ``values`` and ``agg`` may be parallel lists (one local
    multi-aggregate and one combine; a holistic member routes the whole
    list through the shuffle plan; ``aggregates`` is then a list).
    """
    if isinstance(agg, (list, tuple)) or isinstance(values, (list, tuple)):
        if not (isinstance(agg, (list, tuple)) and isinstance(values, (list, tuple))):
            raise ValueError("multi-aggregate needs BOTH values and agg as lists")
        if len(values) != len(agg) or not values:
            raise ValueError("values and agg lists must be non-empty and equal-length")
        _check_aggs(agg)
        if any(a not in Q.COMBINABLE_AGGREGATIONS for a in agg):
            return _holistic_aggregate(keys, list(values), list(agg), mesh, max_groups,
                                       exchange_capacity_factor)
        return _combinable_aggregate(keys, list(values), list(agg), mesh, max_groups)
    _check_aggs([agg])
    if agg not in Q.COMBINABLE_AGGREGATIONS:
        uk, outs, cnt, ovf = _holistic_aggregate(keys, [values], [agg], mesh, max_groups,
                                                 exchange_capacity_factor)
    else:
        uk, outs, cnt, ovf = _combinable_aggregate(keys, [values], [agg], mesh, max_groups,
                                                   single=agg != "mean")
    return uk, outs[0], cnt, ovf


def _combinable_aggregate(keys, val_cols, aggs, mesh, max_groups, single=False):
    """The two-phase plan. Each aggregation decomposes into combinable
    partials (mean -> sum and count, count -> a sum of counts), so one
    local multi-aggregate and one gathered combine give every output;
    means divide at the end. ``single``: one aggregation other than mean,
    through ``hash_aggregate``'s one-value form (the reference's single
    path; its single ``mean`` combines per-slot means with a -inf padding
    identity, so the port takes the sum-and-count plan for it)."""
    multi = isinstance(keys, (list, tuple))
    kb = _blocks(mesh, list(keys) if multi else [keys])
    vb = _blocks(mesh, val_cols)
    parts = []  # (value index, local partial, combine)
    for i, a in enumerate(aggs):
        if a == "mean":
            parts += [(i, "sum", "sum"), (i, "count", "sum")]
        elif a == "count":
            parts.append((i, "count", "sum"))
        else:
            parts.append((i, a, a))
    slot_cols, slot_valid, slot_ovf = [], [], []
    for i in range(len(mesh.local)):
        kc, vs = _per_slot(kb, i), _per_slot(vb, i)
        uk, outs, cnt = _local_agg(kc if multi else kc[0], vs, parts, single)
        uks = list(uk) if multi else [uk]
        slot_cols.append([_pad(u, max_groups) for u in uks] + [_pad(o, max_groups) for o in outs])
        slot_valid.append(torch.arange(max_groups, device=cnt.device) < cnt)
        slot_ovf.append(cnt > max_groups)
    g, gvalid = _gather_valid(mesh, slot_cols, slot_valid)
    nk = len(kb)
    combines = [c for _, _, c in parts]
    primary = _combine(g[:nk], g[nk:], gvalid, combines, single)

    def global_op():
        kc = [gather_rows(Sharded(mesh, b)) for b in kb]
        uk, outs, cnt = _local_agg(kc if multi else kc[0],
                                   [gather_rows(Sharded(mesh, b)) for b in vb], parts, single)
        return (list(uk) if multi else [uk]), outs, cnt

    fk, fparts, fc, ovf = _fallback(C.any_true(mesh, slot_ovf), primary, global_op,
                                    mesh.size * max_groups)
    results, pi = [], 0
    for i, a in enumerate(aggs):
        if a == "mean":
            s, c = fparts[pi], fparts[pi + 1]
            pi += 2
            mdt = torch.float64 if vb[i][0].dtype == torch.float64 else torch.float32
            results.append(s.to(mdt) / c.clamp(min=1).to(mdt))
        else:
            results.append(fparts[pi])
            pi += 1
    return (fk if multi else fk[0]), results, fc, ovf


def _local_agg(keys, vals, parts, single):
    """One aggregate of the partial plan ``parts``; returns ``(keys, out
    list, count)``."""
    if single:
        (j, a, _), = parts
        uk, out, cnt = Q.hash_aggregate(keys, vals[j], a)
        return uk, [out], cnt
    uk, outs, cnt = Q.hash_aggregate(keys, [vals[j] for j, _, _ in parts],
                                     [p for _, p, _ in parts])
    return uk, list(outs), cnt


def _holistic_aggregate(keys, val_cols, aggs, mesh, max_groups, exchange_capacity_factor):
    """The shuffle plan: rows route by key on one splitter sketch over a
    routing word (the key limb, or :func:`_mix_limbs` of every limb), so
    each group lands whole on one slot; the exact single-device aggregate
    runs there (first/last by global input order: the input position rides
    the exchange and a local re-sort restores it); the disjoint per-slot
    groups gather and merge with one ``max`` (``any`` for bools). Each
    slot aggregates only the rows it received, never its padding."""
    multi = isinstance(keys, (list, tuple))
    kb = _blocks(mesh, list(keys) if multi else [keys])
    vb = _blocks(mesh, val_cols)
    n_local = kb[0][0].shape[0]
    for b in kb[1:] + vb:
        if b[0].shape[0] != n_local:
            raise ValueError("all key/value columns must have equal length")
    v_dt = [b[0].dtype for b in vb]
    P = mesh.size
    cap = max(128, -(-int(n_local * exchange_capacity_factor) // 128) * 128)
    need_pos = any(a in ("first", "last", "argmin", "argmax") for a in aggs)
    single = len(val_cols) == 1
    key_ops, val_ops, specs = [], [], None
    for i, r in enumerate(mesh.local):
        kws, specs = Q._cols_to_limbs(_per_slot(kb, i))
        vs = [Q._signed(v) for v in _per_slot(vb, i)]
        if need_pos:
            vs.append(r * n_local + torch.arange(n_local, dtype=torch.int32, device=kws[0].device))
        key_ops.append(kws if len(kws) == 1 else [_mix_limbs(kws), *kws])
        val_ops.append(vs)
    nk = len(kws)  # key limbs, the routing word aside
    splitters = dist_sort._key_splitters(mesh, [torch.sort(k[0]).values for k in key_ops])
    ws, vss, counts, xovf = dist_sort._local_exchange(mesh, key_ops, val_ops, cap, _INT32_MAX,
                                                      splitters=splitters)
    slot_cols, slot_valid, slot_ovf = [], [], []
    for j, d in enumerate(mesh.local):
        # the received valid prefix only: the reference aggregates the whole
        # padded buffer under a leading invalid key and keeps the groups it
        # marks valid, which are these groups
        n = counts[d]
        wlist = [w[:n] for w in (ws[j][1:] if len(ws[j]) > 1 else ws[j])]
        vals = [v[:n] for v in vss[j]]
        dev = wlist[0].device
        pos_sorted = None
        if need_pos:
            # restore global input order within groups (first/last), and
            # give argmin/argmax their global positions
            srt = Q._stable_sort([*wlist, vals[-1], *vals[:-1]], nk + 1)
            wlist, pos_sorted, vals = srt[:nk], srt[nk], srt[nk + 1:]
        vals = [v.view(dt) for v, dt in zip(vals, v_dt)]
        uk, outs, nvalid = Q.hash_aggregate(wlist, vals[0] if single else vals,
                                            aggs[0] if single else aggs, _positions=pos_sorted)
        outs = [outs] if single else list(outs)
        slot_cols.append([_pad(a, max_groups) for a in list(uk) + outs])
        slot_valid.append(torch.arange(max_groups, device=dev) < nvalid)
        slot_ovf.append(nvalid > max_groups)
    g, gvalid = _gather_valid(mesh, slot_cols, slot_valid)
    gouts = g[nk:]
    combines = ["any" if o.dtype == torch.bool else "max" for o in gouts]
    primary = _combine(g[:nk], gouts, gvalid, combines)

    def global_op():
        limbs, _ = Q._cols_to_limbs([gather_rows(Sharded(mesh, b)) for b in kb])
        vs = [gather_rows(Sharded(mesh, b)) for b in vb]
        uk, outs, cnt = Q.hash_aggregate(limbs if len(limbs) > 1 else limbs[0],
                                         vs[0] if single else vs, aggs[0] if single else aggs)
        return (list(uk) if len(limbs) > 1 else [uk]), ([outs] if single else list(outs)), cnt

    overflow = xovf or C.any_true(mesh, slot_ovf)
    fk, fouts, fc, ovf = _fallback(overflow, primary, global_op, P * max_groups)
    fk_cols = Q._limbs_to_cols(fk, specs)
    return (fk_cols if multi else fk_cols[0]), fouts, fc, ovf


def distributed_unique(keys, mesh, *, max_unique: int):
    """Distinct keys and their global multiplicities: per-slot ``unique``
    padded to ``max_unique`` rows, an all-gather and a replicated count-sum
    combine. Returns replicated ``(unique_keys, counts, num, overflow)``;
    rows [0, num) are the distinct keys ascending under the total order.
    When a slot holds more than ``max_unique`` distinct keys the exact
    single-device ``unique`` runs instead (exact unless ``P * max_unique``
    truncates it, which ``overflow`` reports). ``keys`` may be a column
    list (composite DISTINCT)."""
    multi = isinstance(keys, (list, tuple))
    kb = _blocks(mesh, list(keys) if multi else [keys])
    slot_cols, slot_valid, slot_ovf = [], [], []
    for i in range(len(mesh.local)):
        kc = _per_slot(kb, i)
        uk, cts, num = Q.unique(kc if multi else kc[0])
        uks = list(uk) if multi else [uk]
        slot_cols.append([_pad(u, max_unique) for u in uks] + [_pad(cts, max_unique)])
        slot_valid.append(torch.arange(max_unique, device=num.device) < num)
        slot_ovf.append(num > max_unique)
    g, gvalid = _gather_valid(mesh, slot_cols, slot_valid)
    primary = _combine(g[:-1], g[-1:], gvalid, ["sum"], single=True)

    def global_op():
        uk, cts, num = Q.unique([gather_rows(Sharded(mesh, b)) for b in kb] if multi
                                else gather_rows(Sharded(mesh, kb[0])))
        return (list(uk) if multi else [uk]), [cts], num

    fk, fcs, num, ovf = _fallback(C.any_true(mesh, slot_ovf), primary, global_op,
                                  mesh.size * max_unique)
    return (fk if multi else fk[0]), fcs[0], num, ovf


def distributed_top_k(keys, k: int, *arrays, mesh, largest: bool = True):
    """The global top ``k`` rows of sharded keys (and co-selected arrays).

    Each slot takes its stable local top ``min(k, rows)`` candidates (the
    global top k lies in their union); the candidates gather with their
    global positions and one replicated sort by (key order, position)
    picks the first k, so ties break by input position as the
    single-device ``top_k``. Returns replicated ``(top_keys,
    *top_arrays)``; ``keys`` may be a column list."""
    multi = isinstance(keys, (list, tuple))
    kb = _blocks(mesh, list(keys) if multi else [keys])
    ab = _blocks(mesh, arrays)
    n_local = kb[0][0].shape[0]
    n = n_local * mesh.size
    if not 0 <= k <= n:
        raise ValueError(f"k must be in [0, {n}], got {k}")
    for b in kb[1:] + ab:
        if b[0].shape[0] != n_local:
            raise ValueError("all arrays must match the keys length")
    kk = min(k, n_local)
    cand_w, cand_p, cand_a, specs = [], [], [], None
    for i, r in enumerate(mesh.local):
        limbs, specs = Q._cols_to_limbs(_per_slot(kb, i))
        sel = [~w for w in limbs] if largest else limbs
        idx_all = torch.arange(n_local, dtype=torch.int32, device=limbs[0].device)
        srt = Q._stable_sort(sel + [idx_all], len(sel))
        idx = srt[-1][:kk]
        cand_w.append([(~w if largest else w)[:kk] for w in srt[:-1]])
        cand_p.append(r * n_local + idx)
        cand_a.append([Q._take(a, idx) for a in _per_slot(ab, i)])
    gw = [C.all_gather(mesh, [w[t] for w in cand_w]) for t in range(len(cand_w[0]))]
    gp = C.all_gather(mesh, cand_p)
    ga = [C.all_gather(mesh, [a[t] for a in cand_a]) for t in range(len(ab))]
    sel = [~w for w in gw] if largest else gw
    out = Q._stable_sort([*sel, gp, *ga], len(sel) + 1)
    top = [(~w if largest else w)[:k] for w in out[:len(sel)]]
    cols = Q._limbs_to_cols(top, specs)
    return ((cols if multi else cols[0]), *[a[:k] for a in out[len(sel) + 1:]])


def distributed_filter(mask, *arrays, mesh):
    """Per-slot stable compaction of sharded arrays. Returns
    ``(*compacted, counts)``: each array stays sharded with slot s's kept
    rows as its first ``counts[s]`` rows; the concatenated valid prefixes
    are the filtered relation in input order."""
    mb = local_blocks(mesh, mask)
    ab = _blocks(mesh, arrays)
    outs, cnts = [], []
    for i in range(len(mesh.local)):
        *o, c = Q.filter(mb[i], *_per_slot(ab, i))
        outs.append(o)
        cnts.append(c.reshape(1))
    counts = C.all_gather(mesh, cnts)
    return (*[Sharded(mesh, [o[t] for o in outs]) for t in range(len(ab))], counts)


def distributed_hash_join(left_keys, left_values, right_keys, right_values, mesh, *,
                          capacity_per_shard: int, exchange_capacity_factor: float = 2.0,
                          how: str = "inner"):
    """Equi-join of sharded relations (``how`` as in ``query.hash_join``).

    Both sides route with ONE splitter sketch sampled from both sides'
    keys, so matching keys land on one slot; each slot then runs a local
    sort-merge join whose expansion is kernel K2 (``query.join_expand``,
    with the received padding masked out). Full joins append each slot's
    unmatched right rows after its left-join block; right joins swap the
    sides. Returns sharded ``(keys, left_vals, right_vals)`` with
    ``capacity_per_shard`` rows a slot, ``counts`` and ``overflow``: slot
    s's valid rows are its first ``counts[s]``.

    Key-only routing cannot bound a hot key: when any slot overflows its
    exchange buffer (``exchange_capacity_factor`` x its rows) or its join
    capacity, the exact single-device join runs instead and is laid out
    in the same per-slot form; ``overflow`` then reports only a truncation
    of ``P * capacity_per_shard``. Composite keys (column lists on both
    sides) route on a hash word mixed over all key limbs.
    """
    if how not in Q.JOIN_HOWS:
        raise ValueError(f"how must be one of {Q.JOIN_HOWS}, got {how!r}")
    if how == "right":
        jk, j_rv, j_lv, cnts, ovf = distributed_hash_join(
            right_keys, right_values, left_keys, left_values, mesh,
            capacity_per_shard=capacity_per_shard,
            exchange_capacity_factor=exchange_capacity_factor, how="left")
        return jk, j_lv, j_rv, cnts, ovf
    multi = isinstance(left_keys, (list, tuple))
    if multi != isinstance(right_keys, (list, tuple)):
        raise ValueError("left and right keys must both be single columns "
                         "or both be column lists")
    lkb = _blocks(mesh, list(left_keys) if multi else [left_keys])
    rkb = _blocks(mesh, list(right_keys) if multi else [right_keys])
    if multi and (not lkb or len(lkb) != len(rkb) or any(
            a[0].dtype != b[0].dtype for a, b in zip(lkb, rkb))):
        raise ValueError("left and right key columns must be non-empty and "
                         "match in count and dtypes")
    multi_lv = isinstance(left_values, (list, tuple))
    multi_rv = isinstance(right_values, (list, tuple))
    lvb = _blocks(mesh, list(left_values) if multi_lv else [left_values])
    rvb = _blocks(mesh, list(right_values) if multi_rv else [right_values])
    nl_local, nr_local = lkb[0][0].shape[0], rkb[0][0].shape[0]
    for b in lvb:
        if b[0].shape[0] != nl_local:
            raise ValueError("left keys/values length mismatch")
    for b in rvb:
        if b[0].shape[0] != nr_local:
            raise ValueError("right keys/values length mismatch")
    P = mesh.size
    lv_dt = [b[0].dtype for b in lvb]
    rv_dt = [b[0].dtype for b in rvb]
    cap_l = max(128, -(-int(nl_local * exchange_capacity_factor) // 128) * 128)
    cap_r = max(128, -(-int(nr_local * exchange_capacity_factor) // 128) * 128)
    lw, rw, lv, rv, specs = [], [], [], [], None
    for i in range(len(mesh.local)):
        lk, specs = Q._cols_to_limbs(_per_slot(lkb, i))
        rk, _ = Q._cols_to_limbs(_per_slot(rkb, i))
        if len(lk) > 1:
            # composite keys route on a hash of every limb, prepended as the
            # leading key (dropped from the output)
            lk, rk = [_mix_limbs(lk), *lk], [_mix_limbs(rk), *rk]
        lw.append(lk)
        rw.append(rk)
        lv.append([Q._signed(v) for v in _per_slot(lvb, i)])
        rv.append([Q._signed(v) for v in _per_slot(rvb, i)])
    splitters = dist_sort._key_splitters(
        mesh, [torch.sort(torch.cat([a[0], b[0]])).values for a, b in zip(lw, rw)])
    lws, lvs, lcnt, lovf = dist_sort._local_exchange(mesh, lw, lv, cap_l, _INT32_MAX,
                                                     splitters=splitters)
    rws, rvs, rcnt, rovf = dist_sort._local_exchange(mesh, rw, rv, cap_r, _INT32_MAX,
                                                     splitters=splitters)
    drop = 1 if len(lw[0]) > 1 else 0
    outs, cnts, jovfs = [], [], []
    for j, d in enumerate(mesh.local):
        # merge ranks of the received valid prefixes only. For valid left
        # rows they equal the reference's ranks over the padded buffers cut
        # at the received count; padding rows get empty ranges and are
        # masked. (The padding shares one sentinel key: a run of millions of
        # equal keys that would ride the union sort for nothing.)
        nl, nr = lcnt[d], rcnt[d]
        dev = lws[j][0].device
        lo = torch.zeros((cap_l,), dtype=torch.int32, device=dev)
        hi = torch.zeros((cap_l,), dtype=torch.int32, device=dev)
        if nl and nr:
            lo[:nl], hi[:nl] = Q.merge_rank_pair([w[:nr] for w in rws[j]],
                                                 [w[:nl] for w in lws[j]])
        lvalid = torch.arange(cap_l, device=dev) < nl
        ok, olv, orv, cnt, jovf = Q.join_expand(lws[j], lvs[j], rvs[j], lo, hi,
                                                capacity=capacity_per_shard, how=how,
                                                valid_left=lvalid)
        if how == "full":
            rvalid = torch.arange(cap_r, device=dev) < nr
            ok, olv, orv, cnt, jovf = Q.append_unmatched_right(
                ok, olv, orv, cnt, jovf, rws[j], rvs[j], lo, hi, capacity=capacity_per_shard,
                valid_left=lvalid, valid_right=rvalid)
        outs.append((Q._limbs_to_cols(ok[drop:], specs),
                     [v.view(dt) for v, dt in zip(olv, lv_dt)],
                     [v.view(dt) for v, dt in zip(orv, rv_dt)]))
        cnts.append(cnt.reshape(1))
        jovfs.append(jovf)
    counts = C.all_gather(mesh, cnts)
    overflow = lovf or rovf or C.any_true(mesh, jovfs)

    def sharded(part):
        return [Sharded(mesh, [o[part][t] for o in outs]) for t in range(len(outs[0][part]))]

    k_cols, l_cols, r_cols = sharded(0), sharded(1), sharded(2)
    ovf = torch.tensor(False, device=mesh.home)
    if overflow:
        # the exact replicated join, laid out in the per-slot form
        total_cap = P * capacity_per_shard

        def glob(blocks, is_multi):
            cols = [gather_rows(Sharded(mesh, b)) for b in blocks]
            return cols if is_multi else cols[0]

        fk, flv, frv, ftot, ovf = Q.hash_join(
            glob(lkb, multi), glob(lvb, multi_lv), glob(rkb, multi), glob(rvb, multi_rv),
            capacity=total_cap, how=how)

        def relay(cols, is_multi):
            cols = list(cols) if is_multi else [cols]
            return [Sharded(mesh, [c[s * capacity_per_shard:(s + 1) * capacity_per_shard].to(dev)
                                   for s, dev in zip(mesh.local, mesh.devices)]) for c in cols]

        k_cols, l_cols, r_cols = relay(fk, multi), relay(flv, multi_lv), relay(frv, multi_rv)
        counts = (ftot - torch.arange(P, dtype=torch.int32, device=ftot.device)
                  * capacity_per_shard).clamp(0, capacity_per_shard).to(torch.int32)
    return (k_cols if multi else k_cols[0], l_cols if multi_lv else l_cols[0],
            r_cols if multi_rv else r_cols[0], counts, ovf)


def distributed_repeat(values, counts, mesh, *, total_size_per_shard: int):
    """UNNEST over sharded arrays: row i emits ``counts[i]`` copies of every
    value column, in order, into each slot's ``total_size_per_shard`` rows
    (shard-local: one K2 launch per slot, no exchange beyond the counts).
    ``values`` may be one array or a list. Returns ``(*outs, out_counts,
    overflow)``: slot s's valid expansion is its first ``out_counts[s]``
    rows; ``overflow`` is True if any slot's expansion exceeded its bound
    (that slot then holds its first ``total_size_per_shard`` rows,
    exactly)."""
    multi = isinstance(values, (list, tuple))
    vb = _blocks(mesh, list(values) if multi else [values])
    cb = local_blocks(mesh, counts)
    for b in vb:
        if b[0].shape[0] != cb[0].shape[0]:
            raise ValueError("values and counts must have the same length")
    outs, cnts, ovfs = [], [], []
    for i in range(len(mesh.local)):
        o, cnt, ovf = Q._expand_rows(_per_slot(vb, i), cb[i], total_size_per_shard)
        outs.append(o)
        cnts.append(cnt.reshape(1))
        ovfs.append(ovf)
    cols = [Sharded(mesh, [o[t] for o in outs]) for t in range(len(vb))]
    return (*(cols if multi else cols[:1]), C.all_gather(mesh, cnts),
            torch.tensor(C.any_true(mesh, ovfs), device=mesh.home))


def distributed_quantiles(x, qs, mesh, *, method: str = "lower"):
    """Exact global quantiles of sharded ``x`` (order statistics under the
    dtype's total order): the distributed sort (exact for every input),
    then each quantile's rank resolves to the one slot that holds it; the
    owner contributes its element's rank limbs, the others zeros, and a sum
    over the slots combines. Returns ``len(qs)`` values on ``mesh.home``."""
    xb = local_blocks(mesh, x)
    n = xb[0].shape[0] * mesh.size
    if n == 0:
        raise ValueError("quantiles of an empty array")
    ranks = relational.quantile_ranks(n, qs, method)
    srt, counts, _ = dist_sort.distributed_sort(Sharded(mesh, xb), mesh)
    cts = counts.to(torch.int64).tolist()
    offs = [sum(cts[:d]) for d in range(mesh.size)]
    parts = []
    for blk, d in zip(srt.blocks, mesh.local):
        rs = torch.tensor(ranks, dtype=torch.int64, device=blk.device)
        idx = (rs - offs[d]).clamp(0, blk.shape[0] - 1)
        hit = (rs >= offs[d]) & (rs < offs[d] + cts[d])
        parts.append(torch.stack([torch.where(hit, w, 0)
                                  for w in K.encode_limbs(Q._take(blk, idx))]).reshape(-1))
    g = C.all_gather(mesh, parts).reshape(mesh.size, -1, len(ranks))
    return K.decode_limbs(list(g.sum(0, dtype=torch.int32)), xb[0].dtype)


def _distributed_set_op(a_keys, b_keys, want, mesh, max_unique):
    """Two-phase set operator: a per-slot DISTINCT of each side padded to
    ``max_unique`` rows, an all-gather with validity masks, then one
    replicated tagged-union set op (``relational._set_op``), whose
    validity-aware presence bits make padding inert. Returns replicated
    ``(keys, count, overflow)``; on a local breach of ``max_unique`` the
    exact set op over the global rows runs instead."""
    multi = isinstance(a_keys, (list, tuple))
    if multi != isinstance(b_keys, (list, tuple)):
        raise ValueError("both sides must be single columns or column lists")
    ab = _blocks(mesh, list(a_keys) if multi else [a_keys])
    bb = _blocks(mesh, list(b_keys) if multi else [b_keys])
    if not ab or len(ab) != len(bb):
        raise ValueError("sides must have the same non-zero column count")
    if any(a[0].dtype != b[0].dtype for a, b in zip(ab, bb)):
        raise ValueError("column dtypes must match between sides")

    def distinct(blocks, i):
        cols = _per_slot(blocks, i)
        uk, _, num = Q.unique(cols if len(cols) > 1 else cols[0])
        uks = list(uk) if isinstance(uk, (list, tuple)) else [uk]
        valid = torch.arange(max_unique, device=num.device) < num
        return [_pad(u, max_unique) for u in uks], valid, num > max_unique

    sa, sb, va, vb, ovfs = [], [], [], [], []
    for i in range(len(mesh.local)):
        ua, a_valid, ao = distinct(ab, i)
        ub, b_valid, bo = distinct(bb, i)
        sa.append(ua)
        sb.append(ub)
        va.append(a_valid)
        vb.append(b_valid)
        ovfs += [ao, bo]
    ga, gav = _gather_valid(mesh, sa, va)
    gb, gbv = _gather_valid(mesh, sb, vb)
    keys_out, count = relational._set_op(ga if multi else ga[0], gb if multi else gb[0], want,
                                         a_valid=gav, b_valid=gbv)
    kouts = list(keys_out) if multi else [keys_out]
    total_cap = kouts[0].shape[0]

    def global_op():
        a = [gather_rows(Sharded(mesh, b)) for b in ab]
        b = [gather_rows(Sharded(mesh, x)) for x in bb]
        fk, fcnt = relational._set_op(a if multi else a[0], b if multi else b[0], want)
        return (list(fk) if multi else [fk]), [], fcnt

    k_cols, _, cnt, ovf = _fallback(C.any_true(mesh, ovfs), (kouts, [], count), global_op,
                                    total_cap)
    return (k_cols if multi else k_cols[0]), cnt, ovf


def distributed_set_union(a_keys, b_keys, mesh, *, max_unique: int):
    """SQL ``UNION`` of sharded sides: distinct keys present in either,
    ascending (column lists supported). Returns replicated ``(keys, count,
    overflow)``."""
    return _distributed_set_op(a_keys, b_keys, lambda ha, hb: ha | hb, mesh, max_unique)


def distributed_set_intersect(a_keys, b_keys, mesh, *, max_unique: int):
    """SQL ``INTERSECT``: distinct keys present in both sides. Same
    contract as :func:`distributed_set_union`."""
    return _distributed_set_op(a_keys, b_keys, lambda ha, hb: ha & hb, mesh, max_unique)


def distributed_set_difference(a_keys, b_keys, mesh, *, max_unique: int):
    """SQL ``EXCEPT``: distinct keys of the first side absent from the
    second. Same contract as :func:`distributed_set_union`."""
    return _distributed_set_op(a_keys, b_keys, lambda ha, hb: ha & ~hb, mesh, max_unique)
