"""Distributed window functions over the slots of a mesh.

Counterpart of ``radix_sort_tpu/parallel/dist_window.py``: the distributed
form of :func:`radix_sort_tpu_torch.ops.window.window`. Rows are sharded,
partitions may span slots, and the results come back row-aligned with the
input sharding. The plan is the reference's MPP window strategy:

  1. **Global sort** by (partition limbs, order limbs) through
     ``dist_sort._local_exchange`` with the composite position-tiebroken
     splitters: balanced for any distribution (one giant partition spans
     slots instead of flooding one) and stable (ties keep global input
     order). Each row's global position rides the exchange.
  2. **Local window math per slot** on its received valid prefix, plus a
     per-slot boundary summary (head and tail partition and order keys,
     run counts, sums, min / max rank words, first / last values). The
     summaries are all-gathered (O(P) scalars) and the forward and
     backward carry chains are replayed over them: a partition spanning
     slots t..s accumulates its prefix stats left to right (running ops,
     ranks) and its suffix stats right to left (partition-wide
     aggregates), chaining through slots the partition covers whole.
  3. **Route home** by global position (``dist_sort._route_home``: every
     slot receives exactly its own rows), then a scatter by position
     restores the input layout.

Rolling frames and ``lag`` / ``lead`` take a halo of sorted rows from each
neighbour (:func:`collectives.shift`, the reference's ``ppermute``); a
frame bound or offset beyond a neighbour's row count takes the exact
replicated path. Bounded RANGE frames take a fixed value halo of
``range_halo`` rows each way; a frame that touches a visible edge its
partition may extend past takes the replicated path; UNBOUNDED RANGE
sides always do. ``_last_fallback`` says whether the last call took it.

Differences from the reference: each slot works on its received valid
prefix (the exchange's counts are host integers here), so the exchange
padding never forms a pseudo-partition and the halo carries no padding
(the reference rolls the padding to the far edge of the halo and gives it
sentinel keys, ``dist_window.py:646-712``; here the receiver cuts the
valid rows out of the block by the sender's count); the carry chains run
on the host over the gathered summaries; and the replicated fallback is a
host branch taken as soon as the flag is known (``lax.cond`` in the
reference).
"""

from __future__ import annotations

import torch

from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import query as Q
from radix_sort_tpu_torch.ops import window as W
from radix_sort_tpu_torch.parallel import collectives as C
from radix_sort_tpu_torch.parallel import dist_sort
from radix_sort_tpu_torch.parallel.runtime import Sharded, gather_rows, local_blocks, shard_rows

__all__ = ["distributed_window"]

# whether the last distributed_window call took the replicated path (a
# Python bool; test and debug introspection)
_last_fallback = None

_VALUE_SUMS = ("sum", "mean", "cumsum")
_VALUE_WORDS = ("min", "max", "cummin", "cummax", "nth_value")


def _as_cols(x):
    return [] if x is None else list(x) if isinstance(x, (list, tuple)) else [x]


def _respec(spec, values):
    """(name, values, p1, p2, fill) -> the public spec tuple form, with
    ``values`` in place of the spec's value column."""
    name, _, p1, p2, fill = spec
    if name == "ntile":
        return (name, p1)
    if name in ("rolling_count", "range_count"):
        return (name, p1, p2)
    if values is None:
        return name
    if name in W._ROLLING_OPS or name in W._RANGE_OPS:
        return (name, values, p1, p2)
    if name in ("lag", "lead", "nth_value"):
        return (name, values, p1, 0 if fill is None else fill)
    return (name, values)


def _global(mesh, x):
    """A Sharded column or a global tensor as the global tensor on
    ``mesh.home``."""
    return gather_rows(x) if isinstance(x, Sharded) else x.to(mesh.home)


def _replicated(mesh, specs, p_cols, o_cols, descending, single):
    """The exact replicated path: the single-device window over the
    gathered columns, sharded back."""
    g = {}
    for c in p_cols + o_cols + [s[1] for s in specs if s[1] is not None]:
        if id(c) not in g:
            g[id(c)] = _global(mesh, c)
    res = W.window([_respec(s, None if s[1] is None else g[id(s[1])]) for s in specs],
                   partition_by=[g[id(c)] for c in p_cols] or None,
                   order_by=[g[id(c)] for c in o_cols] or None, descending=descending)
    out = [shard_rows(mesh, r) for r in res]
    return out[0] if single else out


def _sum_space(x):
    """Values as summed: bools count in int64, unsigned ints as their signed
    view (the same bits under wraparound)."""
    return x.to(torch.int64) if x.dtype == torch.bool else Q._signed(x)


def _word_ident(dtype):
    """Identities of min and max over the port's signed rank words."""
    info = torch.iinfo(dtype)
    return info.max, info.min


def _stack(vals, dtype, dev):
    return torch.stack([v.reshape(()).to(dev, dtype) if torch.is_tensor(v)
                        else torch.tensor(v, dtype=dtype, device=dev) for v in vals])


def _gathered(mesh, per_slot, width):
    """All-gather one 1-D summary of ``width`` values per local slot; the
    (P, width) result on the host."""
    return C.all_gather(mesh, per_slot).reshape(mesh.size, width).cpu()


def _word_max_chains(stats, valid, whole, hp, tp, ident):
    """Partition-max carry replay for one derived word column: ``stats``
    (P, 2) host tensor of each slot's [head-partition max, tail-partition
    max]. Returns per-slot ``(cin, cout)``: the max over earlier slots' rows
    of the slot's head partition and over later slots' rows of its tail
    partition."""
    P = len(valid)
    zero = torch.tensor(ident, dtype=stats.dtype)

    def run(order, p_open, p_close, col):
        has, p_st, m_st = False, None, zero
        carried = [zero] * P
        for s in order:
            cont = has and valid[s] and p_st == p_open[s]
            carried[s] = m_st if cont else zero
            if valid[s]:
                acc = cont and whole[s]
                m_st = torch.maximum(stats[s, col], m_st if acc else zero)
                p_st = p_close[s]
            has = has or valid[s]
        return carried

    return run(range(P), hp, tp, 1), run(range(P - 1, -1, -1), tp, hp, 0)


class _Slot:
    """One slot's received valid prefix and its local segment structure."""

    def __init__(self, sp, so, vals, cnt):
        self.sp, self.so, self.vals, self.n = sp, so, vals, cnt
        dev = sp[0].device
        self.dev = dev
        if cnt == 0:
            return
        i = torch.arange(cnt, dtype=torch.int32, device=dev)
        self.i = i
        pf = W._boundary(sp, cnt, dev)
        of = (pf | W._boundary(sp + so, cnt, dev)) if so else pf
        self.pf, self.of = pf, of
        self.start = Q._run_bounds(pf)
        self.pend = Q._run_bounds(pf, end=True)
        self.run_start = Q._run_bounds(of)
        self.run_end = Q._run_bounds(of, end=True)
        self.rn0 = i - self.start
        self.gid = Q._gid(pf)
        self.rid = torch.cumsum(of, 0, dtype=torch.int64) - 1
        self.headm = self.gid == 0
        self.tailm = self.gid == self.gid[-1]

    def summary(self):
        """[h_cnt, t_cnt, t_tie, h_runs, t_runs, whole, tie_span, h_tie,
        htie_span] and the head / tail partition and order limbs."""
        if self.n == 0:
            return [0] * 9 + [0] * (2 * len(self.sp) + 2 * len(self.so))
        cnt, start, pend, rid = self.n, self.start, self.pend, self.rid
        h_cnt = pend[0] + 1
        t_cnt = cnt - start[-1]
        t_tie = cnt - self.run_start[-1]
        h_tie = self.run_end[0] + 1
        return ([h_cnt, t_cnt, t_tie, rid[pend[0]] + 1, rid[-1] - rid[start[-1]] + 1,
                 self.gid[-1] == 0, t_tie == cnt, h_tie, h_tie == cnt]
                + [w[0] for w in self.sp] + [w[-1] for w in self.sp]
                + [w[0] for w in self.so] + [w[-1] for w in self.so])


def distributed_window(ops, *, partition_by=None, order_by=None, descending=None, mesh,
                       capacity: int | None = None, range_halo: int | None = None):
    """Evaluate window functions over row-sharded columns.

    Same specs and semantics as :func:`radix_sort_tpu_torch.window` (rank
    ops with percent_rank / cume_dist / ntile, partition-wide and running
    aggregates, first / last / nth value, lag / lead, rolling and RANGE
    frames), with ``partition_by`` / ``order_by`` and the spec value
    columns as :class:`~.runtime.Sharded` columns on ``mesh`` (or global
    tensors, sharded first) and ``descending`` per order column. Returns
    the result columns sharded like the inputs and row-aligned with them
    (a single Sharded for a single spec). Ties in ``order_by`` break by
    global input position, so integer results match the single-device op
    bit for bit; float sums and means differ at most at the ULP of the sum
    (summation order).

    Rolling frames and ``lag`` / ``lead`` read a halo of sorted rows from
    each neighbour slot; a bound beyond a neighbour's row count takes the
    exact replicated path. Bounded RANGE frames read a fixed halo of
    ``range_halo`` rows each way (default ``n_local // 4``, at least 64); a
    frame that touches a visible halo edge its partition may extend past,
    and any UNBOUNDED RANGE side, takes the replicated path. ``nth_value``
    broadcasts the partition's k-th row by a marked-word partition max
    (one more O(P) carry replay per spec). ``capacity`` overrides the
    per-slot exchange bound (a test knob: an overflow takes the replicated
    path, so the result is always exact)."""
    global _last_fallback
    single = isinstance(ops, (str, tuple))
    specs = [W._normalize_spec(ops)] if single else [W._normalize_spec(s) for s in ops]
    if not specs:
        raise ValueError("ops must contain at least one window op")
    p_cols, o_cols = _as_cols(partition_by), _as_cols(order_by)
    all_cols = p_cols + o_cols + [s[1] for s in specs if s[1] is not None]
    if not all_cols:
        raise ValueError("distributed_window needs at least one column")
    n = None
    for c in all_cols:
        m = c.shape[0]
        if n is None:
            n = m
        elif m != n:
            raise ValueError("all partition/order/value columns must have equal length")
    range_specs = [s for s in specs if s[0] in W._RANGE_OPS]
    desc = W._norm_descending(descending, len(o_cols))
    if range_specs:
        if len(o_cols) != 1:
            raise ValueError("RANGE frames need exactly one order_by column")
        if desc[0]:
            raise ValueError("RANGE frames need an ascending order_by column")
    P = mesh.size
    if n % P:
        raise ValueError(f"n ({n}) must be divisible by the mesh size ({P})")
    if n >= 2**31:
        raise ValueError("distributed_window supports < 2**31 rows")
    if P == 1 or any(s[2] is None or s[3] is None for s in range_specs):
        # one slot, or UNBOUNDED RANGE sides (no halo bounds a whole
        # partition): the replicated path by definition
        _last_fallback = True
        return _replicated(mesh, specs, p_cols, o_cols, descending, single)

    n_local = n // P
    if range_halo is None:
        range_halo = max(64, n_local // 4)
    range_halo = min(range_halo, n_local)
    # distinct value columns ride the exchange once
    val_ids, val_cols = {}, []
    for s in specs:
        if s[1] is not None and id(s[1]) not in val_ids:
            val_ids[id(s[1])] = len(val_cols)
            val_cols.append(s[1])
    if range_specs and id(o_cols[0]) not in val_ids:
        # RANGE bounds are value deltas against the raw order column
        val_ids[id(o_cols[0])] = len(val_cols)
        val_cols.append(o_cols[0])
    order_cid = val_ids[id(o_cols[0])] if range_specs else -1
    pb = [local_blocks(mesh, c) for c in p_cols]
    ob = [local_blocks(mesh, c) for c in o_cols]
    vb = [local_blocks(mesh, c) for c in val_cols]
    v_dt = [b[0].dtype for b in vb]
    key_ops, val_ops, npl = [], [], 1
    for j, r in enumerate(mesh.local):
        dev = mesh.devices[j]
        p_limbs = (Q._cols_to_limbs([b[j] for b in pb])[0] if pb
                   else [torch.zeros((n_local,), dtype=torch.int32, device=dev)])
        o_limbs = W._order_limbs([b[j] for b in ob], desc)
        npl = len(p_limbs)
        gpos = r * n_local + torch.arange(n_local, dtype=torch.int32, device=dev)
        key_ops.append(p_limbs + o_limbs)
        val_ops.append([gpos] + [Q._signed(b[j]) for b in vb])
    cap1 = capacity if capacity is not None else dist_sort.exchange_capacity(n_local, P)

    # ---- exchange: the global stable sort by (partition, order) ----
    ow, ov, counts, overflow = dist_sort._local_exchange(
        mesh, key_ops, val_ops, cap1, torch.iinfo(key_ops[0][0].dtype).max)
    if overflow:
        _last_fallback = True
        return _replicated(mesh, specs, p_cols, o_cols, descending, single)

    # ---- halo needs: rows each way for the row-offset ops; RANGE frames
    # add a fixed halo of range_halo sorted rows ----
    roll = [s for s in specs if s[0] in W._ROLLING_OPS]
    lags = [s for s in specs if s[0] == "lag"]
    leads = [s for s in specs if s[0] == "lead"]
    halo_specs = roll + lags + leads + range_specs
    ph_roll = max([s[2] for s in roll] + [s[2] for s in lags] + [0])
    fh_roll = max([s[3] for s in roll] + [s[2] for s in leads] + [0])
    # a frame or offset beyond a neighbour's valid rows: the replicated path
    # (the counts are host integers, so this is known before any window math)
    for r in range(P):
        if ((r > 0 and counts[r - 1] < ph_roll) or (r < P - 1 and counts[r + 1] < fh_roll)):
            _last_fallback = True
            return _replicated(mesh, specs, p_cols, o_cols, descending, single)

    slots = []
    for j, r in enumerate(mesh.local):
        cnt = counts[r]
        keys = [w[:cnt] for w in ow[j]]
        slots.append(_Slot(keys[:npl], keys[npl:],
                           [ov[j][1 + c][:cnt].view(dt) for c, dt in enumerate(v_dt)], cnt))
    gpos_s = [ov[j][0][:counts[r]] for j, r in enumerate(mesh.local)]
    nol = len(slots[0].so)

    # ---- per-slot boundary summaries, gathered; carry chains on the host ----
    home = mesh.home
    ints = _gathered(mesh, [_stack(s.summary(), torch.int64, home) for s in slots],
                     9 + 2 * npl + 2 * nol).tolist()
    valid = [c > 0 for c in counts]
    h_cnt, t_cnt, t_tie, _, t_runs = ([row[k] for row in ints] for k in range(5))
    whole, tie_span = [bool(row[5]) for row in ints], [bool(row[6]) for row in ints]
    h_tie, htie_span = [row[7] for row in ints], [bool(row[8]) for row in ints]
    off = 9
    hp = [tuple(row[off:off + npl]) for row in ints]
    tp = [tuple(row[off + npl:off + 2 * npl]) for row in ints]
    ho = [tuple(row[off + 2 * npl:off + 2 * npl + nol]) for row in ints]
    to = [tuple(row[off + 2 * npl + nol:]) for row in ints]

    need_sum = {val_ids[id(s[1])] for s in specs if s[0] in _VALUE_SUMS}
    need_word = {val_ids[id(s[1])] for s in specs if s[0] in _VALUE_WORDS}
    need_fl = {val_ids[id(s[1])] for s in specs if s[0] in ("first_value", "last_value")}
    words = {c: [K.encode(s.vals[c]) for s in slots] for c in need_word}
    word_dt = {c: K.encoded_dtype(v_dt[c]) for c in need_word}
    sum_dt = {c: _sum_space(torch.zeros((0,), dtype=v_dt[c])).dtype for c in need_sum}
    fl_dt = {c: Q._signed(torch.zeros((0,), dtype=v_dt[c])).dtype for c in need_fl}
    g_sum, g_word, g_fl = {}, {}, {}
    for c in sorted(need_sum):
        per = []
        for s in slots:
            if s.n == 0:
                per.append(torch.zeros((2,), dtype=sum_dt[c], device=home))
                continue
            x = _sum_space(s.vals[c])
            z = torch.zeros((), dtype=x.dtype, device=x.device)
            per.append(torch.stack([torch.where(s.tailm, x, z).sum(dtype=x.dtype),
                                    torch.where(s.headm, x, z).sum(dtype=x.dtype)]))
        g_sum[c] = _gathered(mesh, per, 2)  # t_sum, h_sum
    for c in sorted(need_word):
        mx, mn = _word_ident(word_dt[c])
        per = []
        for s, wc in zip(slots, words[c]):
            if s.n == 0:
                per.append(torch.tensor([mx, mn, mx, mn], dtype=word_dt[c], device=home))
                continue
            hi = torch.full((), mx, dtype=wc.dtype, device=wc.device)
            lo = torch.full((), mn, dtype=wc.dtype, device=wc.device)
            per.append(torch.stack([torch.where(s.tailm, wc, hi).amin(),
                                    torch.where(s.tailm, wc, lo).amax(),
                                    torch.where(s.headm, wc, hi).amin(),
                                    torch.where(s.headm, wc, lo).amax()]))
        g_word[c] = _gathered(mesh, per, 4)  # t_minw, t_maxw, h_minw, h_maxw
    for c in sorted(need_fl):
        per = []
        for s in slots:
            if s.n == 0:
                per.append(torch.zeros((4,), dtype=fl_dt[c], device=home))
                continue
            x = Q._signed(s.vals[c])
            per.append(torch.stack([x[0], x[s.start[-1]], x[s.pend[0]], x[-1]]))
        g_fl[c] = _gathered(mesh, per, 4)  # h_first, t_first, h_last, t_last

    def zero(c, kind):
        if kind == "sum":
            return torch.zeros((), dtype=sum_dt[c])
        if kind == "fl":
            return torch.zeros((), dtype=fl_dt[c])
        mx, mn = _word_ident(word_dt[c])
        return torch.tensor(mx if kind == "minw" else mn, dtype=word_dt[c])

    # forward chain: each slot's HEAD partition stats over every earlier slot
    st = {"has": False, "p": None, "o": None, "cnt": 0, "tie": 0, "runs": 0,
          "sum": {c: zero(c, "sum") for c in need_sum},
          "minw": {c: zero(c, "minw") for c in need_word},
          "maxw": {c: zero(c, "maxw") for c in need_word},
          "first": {c: zero(c, "fl") for c in need_fl}}
    cin = [None] * P
    for s in range(P):
        sv = valid[s]
        cont = st["has"] and sv and st["p"] == hp[s]
        oeq = cont and st["o"] == ho[s]
        cin[s] = {"cnt": st["cnt"] if cont else 0, "tie": st["tie"] if oeq else 0,
                  "runs": st["runs"] if cont else 0, "ov": 1 if oeq else 0,
                  "sum": {c: st["sum"][c] if cont else zero(c, "sum") for c in need_sum},
                  "minw": {c: st["minw"][c] if cont else zero(c, "minw") for c in need_word},
                  "maxw": {c: st["maxw"][c] if cont else zero(c, "maxw") for c in need_word},
                  "first": {c: st["first"][c] if cont else zero(c, "fl") for c in need_fl}}
        if sv:
            acc = cont and whole[s]
            tie_acc = oeq and whole[s] and tie_span[s]
            st = {"has": True, "p": tp[s], "o": to[s],
                  "cnt": t_cnt[s] + (st["cnt"] if acc else 0),
                  "tie": t_tie[s] + (st["tie"] if tie_acc else 0),
                  "runs": t_runs[s] + ((st["runs"] - (1 if oeq else 0)) if acc else 0),
                  "sum": {c: g_sum[c][s, 0] + (st["sum"][c] if acc else zero(c, "sum"))
                          for c in need_sum},
                  "minw": {c: torch.minimum(g_word[c][s, 0],
                                            st["minw"][c] if acc else zero(c, "minw"))
                           for c in need_word},
                  "maxw": {c: torch.maximum(g_word[c][s, 1],
                                            st["maxw"][c] if acc else zero(c, "maxw"))
                           for c in need_word},
                  "first": {c: st["first"][c] if acc else g_fl[c][s, 1] for c in need_fl}}
    # backward chain: each slot's TAIL partition stats over every later slot
    st = {"has": False, "p": None, "o": None, "cnt": 0, "tie": 0,
          "sum": {c: zero(c, "sum") for c in need_sum},
          "minw": {c: zero(c, "minw") for c in need_word},
          "maxw": {c: zero(c, "maxw") for c in need_word},
          "last": {c: zero(c, "fl") for c in need_fl}}
    cout = [None] * P
    for s in range(P - 1, -1, -1):
        sv = valid[s]
        cont = st["has"] and sv and st["p"] == tp[s]
        oeq = cont and st["o"] == to[s]
        cout[s] = {"cnt": st["cnt"] if cont else 0, "tie": st["tie"] if oeq else 0,
                   "sum": {c: st["sum"][c] if cont else zero(c, "sum") for c in need_sum},
                   "minw": {c: st["minw"][c] if cont else zero(c, "minw") for c in need_word},
                   "maxw": {c: st["maxw"][c] if cont else zero(c, "maxw") for c in need_word},
                   "last": {c: st["last"][c] if cont else zero(c, "fl") for c in need_fl}}
        if sv:
            acc = cont and whole[s]
            st = {"has": True, "p": hp[s], "o": ho[s],
                  "cnt": h_cnt[s] + (st["cnt"] if acc else 0),
                  "tie": h_tie[s] + (st["tie"] if (oeq and htie_span[s]) else 0),
                  "sum": {c: g_sum[c][s, 1] + (st["sum"][c] if acc else zero(c, "sum"))
                          for c in need_sum},
                  "minw": {c: torch.minimum(g_word[c][s, 2],
                                            st["minw"][c] if acc else zero(c, "minw"))
                           for c in need_word},
                  "maxw": {c: torch.maximum(g_word[c][s, 3],
                                            st["maxw"][c] if acc else zero(c, "maxw"))
                           for c in need_word},
                  "last": {c: st["last"][c] if acc else g_fl[c][s, 2] for c in need_fl}}

    # ---- nth_value: the partition's k-th row (global order) marks its word;
    # a partition-wide max (local + one more carry replay) broadcasts it ----
    nth = {}
    for k, (name, vcol, p1, _, _) in enumerate(specs):
        if name != "nth_value":
            continue
        c = val_ids[id(vcol)]
        mx, mn = _word_ident(word_dt[c])
        marked, per = [], []
        for s, wc, r in zip(slots, words[c], mesh.local):
            if s.n == 0:
                marked.append(None)
                per.append(torch.tensor([mn, mn], dtype=word_dt[c], device=home))
                continue
            rn_g0 = s.rn0 + torch.where(s.headm, cin[r]["cnt"], 0)
            lo = torch.full((), mn, dtype=wc.dtype, device=wc.device)
            mk = torch.where(rn_g0 == p1 - 1, wc, lo)
            marked.append(mk)
            per.append(torch.stack([torch.where(s.headm, mk, lo).amax(),
                                    torch.where(s.tailm, mk, lo).amax()]))
        stats = _gathered(mesh, per, 2)
        ncin, ncout = _word_max_chains(stats, valid, whole, hp, tp, mn)
        nth[k] = (marked, ncin, ncout)

    # ---- neighbour halo (rolling frames, lag / lead, RANGE frames) ----
    ext = [None] * len(slots)
    if halo_specs:
        rh = range_halo if range_specs else 0
        ph, fh = max(ph_roll, rh), max(fh_roll, rh)
        ph_eff, fh_eff = min(ph, cap1), min(fh, cap1)
        roll_cids = sorted({val_ids[id(s[1])] for s in halo_specs if s[1] is not None}
                           | ({order_cid} if range_specs else set()))
        cols = [[*s.sp, *(s.so if range_specs else []), *[Q._signed(s.vals[c]) for c in roll_cids]]
                for s in slots]
        ncol = len(cols[0])
        hl = hr = None
        if ph_eff:
            # my last ph_eff valid rows -> the next slot (its left halo),
            # zero-padded in front when I hold fewer
            blk = [[torch.cat([x.new_zeros((max(ph_eff - s.n, 0),)), x[max(s.n - ph_eff, 0):]])
                    for x in cs] for s, cs in zip(slots, cols)]
            hl = [C.shift(mesh, [b[k] for b in blk], 1) for k in range(ncol)]
        if fh_eff:
            # my first fh_eff valid rows -> the previous slot (its right halo)
            blk = [[torch.cat([x[:fh_eff], x.new_zeros((max(fh_eff - s.n, 0),))])
                    for x in cs] for s, cs in zip(slots, cols)]
            hr = [C.shift(mesh, [b[k] for b in blk], -1) for k in range(ncol)]
        for j, (s, r) in enumerate(zip(slots, mesh.local)):
            lv = min(ph_eff, counts[r - 1]) if r > 0 else 0
            rv = min(fh_eff, counts[r + 1]) if r < P - 1 else 0
            xs = [torch.cat(([hl[k][j][ph_eff - lv:]] if lv else []) + [cols[j][k]]
                            + ([hr[k][j][:rv]] if rv else [])) for k in range(ncol)]
            nsp = len(s.sp)
            nso = nol if range_specs else 0
            ext[j] = {"lv": lv, "L": lv + s.n + rv, "sp": xs[:nsp], "so": xs[nsp:nsp + nso],
                      "vals": {c: x.view(v_dt[c])
                               for c, x in zip(roll_cids, xs[nsp + nso:])}}
            if s.n:
                L = ext[j]["L"]
                pfx = W._boundary(ext[j]["sp"], L, s.dev)
                ext[j]["ix"] = torch.arange(L, dtype=torch.int32, device=s.dev)
                ext[j]["start"] = Q._run_bounds(pfx)
                ext[j]["pend"] = Q._run_bounds(pfx, end=True)

    # per local slot: a local row whose RANGE frame may reach unseen slots
    range_ins = [torch.tensor(False, device=s.dev) for s in slots]
    range_cache = [{} for _ in slots]

    def range_bounds(j, r, p1, p2):
        """Frame row bounds on slot j's halo-extended view, and the
        halo-edge check: a local row whose partition run starts (ends) at
        the first (last) visible row and whose frame bound sits on that
        edge may continue in unseen slots: the replicated path."""
        if (p1, p2) in range_cache[j]:
            return range_cache[j][(p1, p2)]
        e = ext[j]
        ov_x = e["vals"][order_cid]
        data = [*e["sp"], *e["so"]]
        lo_v = W._shifted(ov_x, W._range_delta(ov_x.dtype, p1), up=False)
        hi_v = W._shifted(ov_x, W._range_delta(ov_x.dtype, p2), up=True)
        ws = torch.minimum(torch.maximum(
            Q.merge_rank(data, [*e["sp"], *K.encode_limbs(lo_v)], side="left"), e["start"]),
            e["pend"])
        we = torch.minimum(torch.maximum(
            Q.merge_rank(data, [*e["sp"], *K.encode_limbs(hi_v)], side="right") - 1,
            e["start"]), e["pend"])
        L, lv, cnt = e["L"], e["lv"], slots[j].n
        ins = torch.zeros_like(ws, dtype=torch.bool)
        if r > 0:
            ins = ins | ((e["start"] == 0) & (ws == 0))
        if r < P - 1:
            ins = ins | ((e["pend"] == L - 1) & (we == L - 1))
        range_ins[j] = range_ins[j] | ins[lv:lv + cnt].any()
        range_cache[j][(p1, p2)] = (ws, we)
        return ws, we

    # ---- per-spec results on each slot's sorted valid rows ----
    out_dt = None
    if any(c == 0 for c in (counts[r] for r in mesh.local)):
        # result dtypes for empty slots: the single-device op on one row
        one = W.window([_respec(s, None if s[1] is None else vb[val_ids[id(s[1])]][0][:1])
                        for s in specs],
                       partition_by=[b[0][:1] for b in pb] or None,
                       order_by=[b[0][:1] for b in ob] or None, descending=descending)
        out_dt = [x.dtype for x in one]
    results = []
    for j, (s, r) in enumerate(zip(slots, mesh.local)):
        if s.n == 0:
            results.append([torch.zeros((0,), dtype=dt, device=s.dev) for dt in out_dt])
            continue
        ci, co = cin[r], cout[r]
        head_i, tail_i = s.headm.to(torch.int32), s.tailm.to(torch.int32)
        start, pend, i, dev = s.start, s.pend, s.i, s.dev
        cnt_g = pend - start + 1 + head_i * ci["cnt"] + tail_i * co["cnt"]
        res = []
        for k, (name, vcol, p1, p2, fill) in enumerate(specs):
            c = val_ids[id(vcol)] if vcol is not None else None
            if name == "row_number":
                out = s.rn0 + 1 + head_i * ci["cnt"]
            elif name in ("rank", "percent_rank"):
                adj = torch.where(s.rid == 0, ci["cnt"] - ci["tie"], ci["cnt"]).to(torch.int32)
                out = s.run_start - start + 1 + head_i * adj
                if name == "percent_rank":
                    denom = (cnt_g - 1).clamp(min=1).to(torch.float32)
                    out = torch.where(cnt_g > 1, (out - 1).to(torch.float32) / denom, 0.0)
            elif name == "dense_rank":
                out = (s.rid - s.rid[start] + 1).to(torch.int32) + head_i * (ci["runs"] - ci["ov"])
            elif name == "count":
                out = cnt_g
            elif name == "cume_dist":
                last_run = (s.rid == s.rid[-1]).to(torch.int32)
                peers = s.run_end - start + 1 + head_i * ci["cnt"] + last_run * co["tie"]
                out = peers.to(torch.float32) / cnt_g.clamp(min=1).to(torch.float32)
            elif name == "ntile":
                rn_g = s.rn0 + head_i * ci["cnt"]
                base = cnt_g // p1
                extra = cnt_g % p1
                thr = extra * (base + 1)
                out = torch.where(rn_g < thr, rn_g // (base + 1),
                                  extra + (rn_g - thr) // base.clamp(min=1)).to(torch.int32) + 1
            elif name in W._RANGE_OPS or name in W._ROLLING_OPS:
                e = ext[j]
                if name in W._RANGE_OPS:
                    ws, we = range_bounds(j, r, p1, p2)
                    max_len = e["L"]
                else:
                    ws = torch.maximum(e["start"], e["ix"] - p1)
                    we = torch.minimum(e["pend"], e["ix"] + p2)
                    max_len = p1 + p2 + 1
                if name in ("rolling_count", "range_count"):
                    out_x = (we - ws + 1).to(torch.int32)
                else:
                    out_x = W._frame_reduce(name, e["vals"][c], ws, we, max_len)
                out = out_x[e["lv"]:e["lv"] + s.n]
            elif name in ("sum", "mean"):
                sv = s.vals[c]
                x = _sum_space(sv)
                if sv.is_floating_point():
                    local = Q._segsum(sv, s.gid)[s.gid]
                else:
                    local = _sum_space(W._prefix_diff(sv, start, pend))
                z = torch.zeros((), dtype=x.dtype, device=dev)
                total = (local + torch.where(s.headm, ci["sum"][c].to(dev), z)
                         + torch.where(s.tailm, co["sum"][c].to(dev), z))
                if name == "mean":
                    mdt = W._mean_dt(sv.dtype)
                    out = total.to(mdt) / cnt_g.to(mdt)
                else:
                    out = Q._as_sum(total, sv.dtype)
            elif name in ("min", "max"):
                sv, wc = s.vals[c], words[c][j]
                seg = Q._seg_extreme(wc, s.gid, name)[s.gid]
                comb = torch.minimum if name == "min" else torch.maximum
                key = "minw" if name == "min" else "maxw"
                ident = zero(c, key).to(dev)
                wres = comb(comb(seg, torch.where(s.headm, ci[key][c].to(dev), ident)),
                            torch.where(s.tailm, co[key][c].to(dev), ident))
                out = K.decode(wres, sv.dtype)
            elif name == "cumsum":
                sv = s.vals[c]
                if sv.is_floating_point():
                    run = Q._seg_scan([sv], s.rn0, lambda a, b: [a[0] + b[0]])[0]
                else:
                    run = _sum_space(W._prefix_diff(sv, start, i))
                z = torch.zeros((), dtype=run.dtype, device=dev)
                out = Q._as_sum(run + torch.where(s.headm, ci["sum"][c].to(dev), z), sv.dtype)
            elif name in ("cummin", "cummax"):
                sv, wc = s.vals[c], words[c][j]
                comb = torch.minimum if name == "cummin" else torch.maximum
                key = "minw" if name == "cummin" else "maxw"
                run = Q._seg_scan([wc], s.rn0, lambda a, b: [comb(a[0], b[0])])[0]
                out = K.decode(comb(run, torch.where(s.headm, ci[key][c].to(dev),
                                                     zero(c, key).to(dev))), sv.dtype)
            elif name == "first_value":
                sv = s.vals[c]
                first = Q._signed(sv)[start]
                carried = (ci["first"][c].to(dev) if ci["cnt"] > 0 else first)
                out = torch.where(s.headm, carried, first).view(sv.dtype)
            elif name == "last_value":
                sv = s.vals[c]
                last = Q._signed(sv)[pend]
                carried = (co["last"][c].to(dev) if co["cnt"] > 0 else last)
                out = torch.where(s.tailm, carried, last).view(sv.dtype)
            elif name == "nth_value":
                sv = s.vals[c]
                marked, ncin, ncout = nth[k]
                mk = marked[j]
                mn = zero(c, "maxw").to(dev)
                seg = Q._seg_extreme(mk, s.gid, "max")[s.gid]
                word = torch.maximum(torch.maximum(seg, torch.where(s.headm, ncin[r].to(dev), mn)),
                                     torch.where(s.tailm, ncout[r].to(dev), mn))
                fill_v = Q._signed(W._scalar(0 if fill is None else fill, sv.dtype, dev))
                out = torch.where(cnt_g >= p1, Q._signed(K.decode(word, sv.dtype)),
                                  fill_v).view(sv.dtype)
            else:  # lag / lead on the halo-extended view
                e = ext[j]
                svx = e["vals"][c]
                fill_v = Q._signed(W._scalar(0 if fill is None else fill, svx.dtype, dev))
                if name == "lag":
                    idx = e["ix"] - p1
                    ok = idx >= e["start"]
                else:
                    idx = e["ix"] + p1
                    ok = idx <= e["pend"]
                got = Q._signed(svx)[idx.clamp(0, e["L"] - 1).to(torch.int64)]
                out = torch.where(ok, got, fill_v).view(svx.dtype)[e["lv"]:e["lv"] + s.n]
            res.append(out)
        results.append(res)
    if range_specs and C.any_true(mesh, range_ins):
        _last_fallback = True
        return _replicated(mesh, specs, p_cols, o_cols, descending, single)

    # ---- route the results home by global position ----
    home_cols = dist_sort._route_home(mesh, gpos_s, results, n_local)
    _last_fallback = False
    out = [Sharded(mesh, [hc[k] for hc in home_cols]) for k in range(len(specs))]
    return out[0] if single else out
