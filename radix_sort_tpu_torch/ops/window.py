"""SQL window functions (OVER PARTITION BY ... ORDER BY ...).

Counterpart of ``radix_sort_tpu/ops/window.py``, under the same names and
with the same outputs:

  1. one stable sort by (partition limbs, order limbs) with the original
     position and every value column riding along;
  2. vectorized segment math on the sorted rows: partition and peer-run
     bounds from their first-row marks (a lookup of the marked positions by
     run id, where the reference takes a forward ``cummax`` and a reversed
     ``cummin``), exact integer prefix-sum differences, segment reductions
     for partition-wide float sums and min / max, a log-step
     (Hillis-Steele) segmented scan for running float sums and running
     min / max, and power-of-two tables for sliding frames;
  3. the inverse permutation back to input order (the reference's restore
     sort by position: ``out[pos_sorted] = result``).

All requested window columns share the sort. Ties in ``order_by`` (and rows
with no ``order_by``) keep their input order. Integer results, ranks, lags
and counts are bit-identical to the reference's; float sums and means may
differ at the ULP of the sum (summation order).
"""

from __future__ import annotations

import numpy as np
import torch

from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops.query import (
    _as_sum,
    _cols_to_limbs,
    _gid,
    _mark_first,
    _run_bounds,
    _seg_scan,
    _running_sum,
    _seg_extreme,
    _segsum,
    _signed,
    _stable_sort,
    _take,
    merge_rank,
)

__all__ = ["window", "WINDOW_OPS"]

# value-less rank/count ops and value ops (partition-wide vs running)
_RANK_OPS = (
    "row_number", "rank", "dense_rank", "count",
    "percent_rank", "cume_dist",          # SQL relative-rank functions
)
_PARAM_OPS = ("ntile", "rolling_count")   # value-less but parameterized
_VALUE_OPS = (
    "sum", "min", "max", "mean",          # partition-wide, broadcast to rows
    "cumsum", "cummin", "cummax",         # running (rows up to and incl. self)
    "first_value", "last_value",          # partition first/last under order
    "nth_value",                          # partition's k-th row under order
    "lag", "lead",                        # shifted within partition
    "rolling_sum", "rolling_min",         # sliding frame
    "rolling_max", "rolling_mean",        # (ROWS BETWEEN p PRECEDING
)                                         #  AND f FOLLOWING)
_ROLLING_OPS = (
    "rolling_sum", "rolling_min", "rolling_max", "rolling_mean",
    "rolling_count",
)
# value-based sliding frames (SQL RANGE BETWEEN v PRECEDING AND w FOLLOWING
# over one ascending numeric order column; None = UNBOUNDED)
_RANGE_OPS = (
    "range_sum", "range_min", "range_max", "range_mean", "range_count",
)
WINDOW_OPS = _RANK_OPS + _PARAM_OPS + _VALUE_OPS + _RANGE_OPS

_NP_DTYPE = {torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16,
             torch.int32: np.int32, torch.int64: np.int64, torch.uint8: np.uint8,
             torch.uint16: np.uint16, torch.uint32: np.uint32, torch.uint64: np.uint64,
             torch.float32: np.float32, torch.float64: np.float64}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _normalize_spec(spec):
    """spec -> (name, values|None, p1, p2, fill).

    ``p1``/``p2`` carry the op's parameters: lag/lead offset and
    nth_value's k in ``p1``; frames put ``preceding`` in ``p1`` and
    ``following`` in ``p2``; ntile's bucket count in ``p1``.
    """
    if isinstance(spec, str):
        name, rest = spec, ()
    elif isinstance(spec, tuple) and spec and isinstance(spec[0], str):
        name, rest = spec[0], tuple(spec[1:])
    else:
        raise ValueError(f"bad window op spec: {spec!r} (a spec is a name string or a "
                         "(name, values, ...) tuple; pass several specs as a list)")
    if name not in WINDOW_OPS:
        raise ValueError(f"op must be one of {WINDOW_OPS}, got {name!r}")
    if name in _RANK_OPS:
        if rest:
            raise ValueError(f"{name!r} takes no value column")
        return name, None, 1, 0, None
    if name == "ntile":
        if len(rest) != 1:
            raise ValueError("ntile takes a bucket count: ('ntile', n)")
        b = int(rest[0])
        if b < 1:
            raise ValueError(f"ntile bucket count must be >= 1, got {b}")
        return name, None, b, 0, None
    if name in ("rolling_count", "range_count"):
        if not 1 <= len(rest) <= 2:
            raise ValueError(f"{name} takes a frame: ({name!r}, preceding[, following])")
        p, f = rest[0], (rest[1] if len(rest) > 1 else 0)
        if name == "rolling_count":
            p, f = int(p), int(f)
            if p < 0 or f < 0:
                raise ValueError(f"{name!r} frame bounds must be >= 0")
        else:
            _check_range_bounds(name, p, f)
        return name, None, p, f, None
    if not rest:
        raise ValueError(f"{name!r} needs a value column: ({name!r}, values)")
    values, rest = rest[0], rest[1:]
    p1, p2, fill = 1, 0, None
    if name in ("lag", "lead", "nth_value"):
        if rest:
            p1, rest = int(rest[0]), rest[1:]
            if p1 < 1:
                raise ValueError(f"{name!r} offset must be >= 1")
        if rest:
            fill, rest = rest[0], rest[1:]
    elif name in _ROLLING_OPS:
        if not rest:
            raise ValueError(f"{name!r} takes a frame: ({name!r}, values, "
                             "preceding[, following])")
        p1, rest = int(rest[0]), rest[1:]
        if rest:
            p2, rest = int(rest[0]), rest[1:]
        if p1 < 0 or p2 < 0:
            raise ValueError(f"{name!r} frame bounds must be >= 0")
    elif name in _RANGE_OPS:
        if not rest:
            raise ValueError(f"{name!r} takes a frame: ({name!r}, values, "
                             "preceding[, following]) — value deltas, None=UNBOUNDED")
        p1, rest = rest[0], rest[1:]
        if rest:
            p2, rest = rest[0], rest[1:]
        _check_range_bounds(name, p1, p2)
    if rest:
        raise ValueError(f"too many arguments for {name!r}: {spec!r}")
    return name, values, p1, p2, fill


def _check_range_bounds(name, p, f):
    for b in (p, f):
        if b is None:
            continue
        if isinstance(b, tuple) and len(b) == 3 and b[0] == "interval":
            if b[1] >= 0 and b[2] >= 0:
                continue  # dtype-resolved in _range_delta
        elif isinstance(b, (int, float)) and b >= 0:
            continue
        raise ValueError(f"{name!r} frame bounds are numeric value deltas >= 0 "
                         f"(or None for UNBOUNDED), got {b!r}")


def _norm_descending(descending, n_cols, what="order_by"):
    """Normalize a descending spec to one bool per column."""
    if descending is None:
        return [False] * n_cols
    if isinstance(descending, bool):
        return [descending] * n_cols
    desc = [bool(d) for d in descending]
    if len(desc) != n_cols:
        raise ValueError(f"descending must match {what} ({n_cols} columns), "
                         f"got {len(desc)} flags")
    return desc


def _order_limbs(o_cols, descending):
    """Order-key limbs honoring per-column direction: complementing every
    limb of an order-preserving encoding reverses its order and keeps ties
    tied."""
    limbs = []
    for c, d in zip(o_cols, descending):
        enc = K.encode_limbs(c)
        limbs.extend([~w for w in enc] if d else enc)
    return limbs


def _boundary(limbs, n, dev):
    """First-row-of-run marks of consecutive equal rows of a limb list."""
    if not limbs:
        first = torch.zeros((n,), dtype=torch.bool, device=dev)
        first[0] = True
        return first
    return _mark_first(limbs)


def _shift_back(arr, s, fill):
    """``arr`` moved ``s`` rows down, ``fill`` (a 0-dim tensor of its dtype)
    on top."""
    return torch.cat([fill.expand(s), arr[:-s]])


def _scalar(v, dtype, dev):
    """A 0-dim tensor of ``dtype`` holding ``v``'s bits in that dtype (numpy
    conversion rules; unsigned dtypes through their signed view)."""
    a = np.asarray(v).astype(_NP_DTYPE[dtype])
    return _signed(torch.from_numpy(a.reshape(1)).to(dev)).reshape(()).view(dtype)


def _pow2_tables(vals, max_len, combine, identity):
    """Sparse table for sliding frames, as one (levels, n) tensor: row k
    holds ``combine`` over ``vals[i - 2**k + 1 .. i]`` (identity-padded past
    the left edge), for levels up to the smallest power of two >=
    ``max_len``. Each level is written in place, so the table is all the
    memory it takes (levels x n x itemsize)."""
    levels = 1
    while (1 << (levels - 1)) < max_len:
        levels += 1
    n = vals.shape[0]
    st = torch.empty((levels, n), dtype=vals.dtype, device=vals.device)
    st[0] = vals
    for k in range(1, levels):
        s = 1 << (k - 1)
        st[k, :s] = combine(st[k - 1, :s], identity)
        st[k, s:] = combine(st[k - 1, s:], st[k - 1, :-s])
    return st


def _floor_log2(x):
    """Exact floor(log2(x)) of int32 values >= 1 (the reference's
    ``31 - clz(x)``), by a binary search on the bits."""
    k = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        k = k + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return k


def _rolling_two_windows(st, ws, we):
    """The idempotent-reduce trick: a frame [ws, we] is covered by two
    overlapping power-of-two windows of span ``2**floor(log2(len))`` ending
    at ``we`` and starting at ``ws``. Returns the two table entries."""
    k = _floor_log2(we - ws + 1).to(torch.int64)
    span = torch.ones_like(k) << k
    return st[k, we.to(torch.int64)], st[k, ws.to(torch.int64) + span - 1]


def _binary_decomp_sum(st, ws, we):
    """Frame sums from the binary decomposition of the frame length: one
    power-of-two table entry (a balanced tree sum) per set bit, from the
    top. Accuracy ~ULP(frame sum) x log2(max_len), no prefix-difference
    cancellation."""
    n = st.shape[1]
    length = we - ws + 1
    acc = torch.zeros(length.shape, dtype=st.dtype, device=st.device)
    pos = we
    for k in reversed(range(st.shape[0])):
        take = ((length >> k) & 1) == 1
        acc = acc + torch.where(take, st[k][pos.clamp(0, n - 1)], 0)
        pos = pos - torch.where(take, 1 << k, 0)
    return acc


def _range_delta(dtype, d):
    """A frame bound delta as a Python number of the order column's dtype
    (integer columns reject fractional deltas). An ``("interval", days,
    us)`` bound resolves by dtype: int64 epoch-microsecond columns take
    days * 86.4e9 + us, int32 epoch-day columns take days."""
    if isinstance(d, tuple) and len(d) == 3 and d[0] == "interval":
        _, days, us = d
        if dtype == torch.int64:
            d = days * 86_400_000_000 + us
        elif us:
            raise ValueError("a sub-day INTERVAL RANGE bound needs an int64 "
                             "epoch-microseconds order column (a DATE has no time of day)")
        else:
            d = days
    if dtype.is_floating_point:
        return float(d)
    if isinstance(d, float) and not d.is_integer():
        raise ValueError(f"RANGE bound {d!r} is fractional but the order column is {dtype}")
    return int(_NP_DTYPE[dtype](int(d)))


def _shifted(ov, d, up):
    """``ov + d`` (``up``) or ``ov - d``: IEEE for floats, wrapping for
    signed integers, saturating at the range of an unsigned dtype (the
    reference's ``ov - minimum(ov, d)`` and ``ov + minimum(max - ov, d)``).
    Unsigned columns of up to 32 bits compute in int64; uint64 saturates by
    a comparison of rank words and adds on the signed view."""
    if ov.dtype not in _UNSIGNED:
        ds = _scalar(d, ov.dtype, ov.device)
        return ov + ds if up else ov - ds
    bits = K.num_digit_bits(ov.dtype)
    umax = (1 << bits) - 1
    s = _signed(ov)
    if bits < 64:
        x = s.to(torch.int64) & umax
        r = x + (umax - x).clamp(max=d) if up else x - x.clamp(max=d)
        return r.to(s.dtype).view(ov.dtype)
    w = K.encode(ov)  # the rank word of a uint64 v is v - 2**63
    dsig = d - (1 << 64) if d >= (1 << 63) else d
    if up:
        return torch.where(w <= umax - d - (1 << 63), s + dsig, -1).view(ov.dtype)
    return torch.where(w >= d - (1 << 63), s - dsig, 0).view(ov.dtype)


def _mean_dt(dt):
    return torch.float64 if dt == torch.float64 else torch.float32


def _prefix_diff(sv, ws, we):
    """Integer sums over [ws, we] as running-sum differences, in the
    value's own width (exact under wraparound)."""
    csum = _running_sum(sv)
    prev = torch.where(ws > 0, csum[(ws - 1).clamp(min=0)], 0)
    return _as_sum(csum[we] - prev, sv.dtype)


def _minmax_setup(name, sv):
    """Rank words of ``sv`` with the min or max combine and the
    reference's identity (the unsigned word's max for min, 0 for max)."""
    w = K.encode(sv)
    info = torch.iinfo(w.dtype)
    if name.endswith("min"):
        return w, torch.minimum, torch.tensor(info.max, dtype=w.dtype, device=w.device)
    return w, torch.maximum, torch.tensor(info.min, dtype=w.dtype, device=w.device)


def _frame_reduce(name, sv, ws, we, max_len):
    """min / max / sum / mean of ``sv`` over the frames [ws, we] of length
    at most ``max_len``."""
    if name.endswith(("min", "max")):
        w, comb, ident = _minmax_setup(name, sv)
        st = _pow2_tables(w, max_len, comb, ident)
        a, b = _rolling_two_windows(st, ws, we)
        return K.decode(comb(a, b), sv.dtype)
    if sv.is_floating_point():
        zero = torch.zeros((), dtype=sv.dtype, device=sv.device)
        s = _binary_decomp_sum(_pow2_tables(sv, max_len, torch.add, zero), ws, we)
    else:
        s = _prefix_diff(sv, ws, we)
    if name.endswith("mean"):
        mdt = _mean_dt(sv.dtype)
        s = s.to(mdt) / (we - ws + 1).to(mdt)
    return s


def window(ops, *, partition_by=None, order_by=None, descending=None):
    """Evaluate window functions over partitions.

    ``ops`` is one spec or a list of specs, each:

      - ``"row_number"`` -- 1-based position within the partition in
        ``order_by`` order (ties broken by input order);
      - ``"rank"`` / ``"dense_rank"`` -- SQL semantics over ``order_by``
        ties (with no ``order_by`` every row ranks 1);
      - ``"percent_rank"`` / ``"cume_dist"`` -- ``(rank-1)/(count-1)`` (0
        for single-row partitions) and ``peers_through_self / count``,
        both float32;
      - ``"count"`` -- partition size, broadcast to every row;
      - ``("ntile", n)`` -- 1-based bucket of an n-way even split of the
        partition (the first ``count mod n`` buckets one row larger);
      - ``(agg, values)`` with agg in sum/min/max/mean -- partition-wide
        aggregate broadcast to every row;
      - ``("cumsum"|"cummin"|"cummax", values)`` -- running aggregate over
        the partition's rows up to and including the current row;
      - ``("first_value"|"last_value", values)``;
      - ``("nth_value", values, k[, fill])`` -- the partition's k-th row's
        value (fill where the partition has fewer than k rows);
      - ``("lag"|"lead", values[, offset[, fill]])`` -- the value
        ``offset`` rows back/ahead within the partition (default 1, fill 0);
      - ``("rolling_sum"|"rolling_min"|"rolling_max"|"rolling_mean",
        values, preceding[, following])`` and ``("rolling_count",
        preceding[, following])`` -- ``ROWS BETWEEN preceding PRECEDING AND
        following FOLLOWING`` frames clamped to the partition;
      - ``("range_sum"|"range_min"|"range_max"|"range_mean", values,
        preceding[, following])`` and ``("range_count", preceding[,
        following])`` -- ``RANGE`` frames of value deltas over one
        ascending ``order_by`` column (None = UNBOUNDED; an
        ``("interval", days, us)`` delta for date / timestamp columns).

    ``partition_by`` / ``order_by``: None, a column, or a list of columns.
    With ``partition_by=None`` the whole input is one partition.
    ``descending``: None, one bool, or one bool per ``order_by`` column.

    Returns one tensor per spec (a single tensor if ``ops`` was a single
    spec), aligned with the input row order. Integer sums are exact
    (wrapping in the value's width); float partition sums are a
    scatter-add per partition; float running and frame sums are
    log-depth tree sums.
    """
    single = isinstance(ops, (str, tuple))
    specs = [_normalize_spec(ops)] if single else [_normalize_spec(s) for s in ops]
    if not specs:
        raise ValueError("ops must contain at least one window op")

    def _cols(x):
        return [] if x is None else list(x) if isinstance(x, (list, tuple)) else [x]

    p_cols, o_cols = _cols(partition_by), _cols(order_by)
    n, dev = None, None
    for c in p_cols + o_cols + [s[1] for s in specs if s[1] is not None]:
        if n is None:
            n, dev = c.shape[0], c.device
        elif c.shape[0] != n:
            raise ValueError("all partition/order/value columns must have equal length")
    if n is None:
        raise ValueError("window needs at least one column to infer length "
                         "(partition_by, order_by, or a value column)")

    def _out_dt(name, values):
        if name in ("percent_rank", "cume_dist"):
            return torch.float32
        if name in _RANK_OPS or name in _PARAM_OPS or name == "range_count":
            return torch.int32
        if name in ("mean", "rolling_mean", "range_mean"):
            return _mean_dt(values.dtype)
        return values.dtype

    if n == 0:
        outs = [torch.zeros((0,), dtype=_out_dt(nm, v), device=dev)
                for nm, v, _, _, _ in specs]
        return outs[0] if single else outs

    p_limbs = _cols_to_limbs(p_cols)[0]
    o_limbs = _order_limbs(o_cols, _norm_descending(descending, len(o_cols)))
    has_range = any(nm in _RANGE_OPS for nm, *_ in specs)
    if has_range:
        if len(o_cols) != 1:
            raise ValueError("RANGE frames need exactly one order_by column")
        if _norm_descending(descending, 1)[0]:
            raise ValueError("RANGE frames need an ascending order_by column")

    # one stable sort by (partition, order); position + value columns ride
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    val_ids, val_arrays = {}, []
    for _, v, _, _, _ in specs:
        if v is not None and id(v) not in val_ids:
            val_ids[id(v)] = len(val_arrays)
            val_arrays.append(v)
    if has_range and id(o_cols[0]) not in val_ids:
        # the raw order values ride the sort: RANGE bounds are value deltas
        val_ids[id(o_cols[0])] = len(val_arrays)
        val_arrays.append(o_cols[0])
    nk = len(p_limbs) + len(o_limbs)
    if nk:
        out = _stable_sort([*p_limbs, *o_limbs, pos, *val_arrays], num_keys=nk)
        sp, so, pos_s, vals_s = out[:len(p_limbs)], out[len(p_limbs):nk], out[nk], out[nk + 1:]
    else:
        sp, so, pos_s, vals_s = [], [], pos, val_arrays

    i = pos
    part_first = _boundary(sp, n, dev)
    start = _run_bounds(part_first)
    pend = _run_bounds(part_first, end=True)
    rn0 = i - start
    gid = _gid(part_first)
    # (partition, order) peer-run boundaries for rank / dense_rank
    order_first = (part_first | _boundary(so, n, dev)) if so else part_first

    def _sv(spec_v):
        return vals_s[val_ids[id(spec_v)]]

    range_bounds_cache = {}

    def _range_bounds(p1, p2):
        """Row bounds [ws, we] of a RANGE frame: the rows of the current
        partition whose order value lies in [ov - p1, ov + p2] (None =
        unbounded side), by merge rank over the sorted (partition, order)
        keys."""
        key = (p1, p2)
        if key in range_bounds_cache:
            return range_bounds_cache[key]
        ov = _sv(o_cols[0])
        data = [*sp, *so]
        if p1 is None:
            ws = start
        else:
            lo_v = _shifted(ov, _range_delta(ov.dtype, p1), up=False)
            ws = torch.minimum(torch.maximum(
                merge_rank(data, [*sp, *K.encode_limbs(lo_v)], side="left"), start), pend)
        if p2 is None:
            we = pend
        else:
            hi_v = _shifted(ov, _range_delta(ov.dtype, p2), up=True)
            we = torch.minimum(torch.maximum(
                merge_rank(data, [*sp, *K.encode_limbs(hi_v)], side="right") - 1, start), pend)
        range_bounds_cache[key] = (ws, we)
        return ws, we

    def _fill(sv, fill):
        if fill is None:
            return torch.zeros((), dtype=sv.dtype, device=dev)
        return _scalar(fill, sv.dtype, dev)

    results = []
    for name, v, p1, p2, fill in specs:
        offset = p1  # lag/lead shift; nth_value's k; ntile's bucket count
        if name == "row_number":
            results.append(rn0 + 1)
        elif name == "rank":
            results.append(_run_bounds(order_first) - start + 1)
        elif name == "dense_rank":
            rid = torch.cumsum(order_first, 0, dtype=torch.int32)
            results.append(rid - rid[start] + 1)
        elif name == "count":
            results.append(pend - start + 1)
        elif name == "percent_rank":
            rank = _run_bounds(order_first) - start + 1
            cnt = pend - start + 1
            denom = (cnt - 1).clamp(min=1).to(torch.float32)
            results.append(torch.where(cnt > 1, (rank - 1).to(torch.float32) / denom, 0.0))
        elif name == "cume_dist":
            run_end = _run_bounds(order_first, end=True)
            cnt = pend - start + 1
            results.append((run_end - start + 1).to(torch.float32) / cnt.to(torch.float32))
        elif name == "ntile":
            cnt = pend - start + 1
            base = cnt // offset
            extra = cnt % offset
            thr = extra * (base + 1)
            # base == 0 (fewer rows than buckets): thr == cnt, so every row
            # takes the first branch and the clamp stays inert
            tile = torch.where(rn0 < thr, rn0 // (base + 1),
                               extra + (rn0 - thr) // base.clamp(min=1))
            results.append(tile.to(torch.int32) + 1)
        elif name == "rolling_count":
            ws = torch.maximum(start, i - p1)
            we = torch.minimum(pend, i + p2)
            results.append((we - ws + 1).to(torch.int32))
        elif name in _RANGE_OPS:
            ws, we = _range_bounds(p1, p2)
            if name == "range_count":
                results.append((we - ws + 1).to(torch.int32))
            else:
                # frame lengths depend on the data (up to the partition
                # size): the full log2(n)-level table
                results.append(_frame_reduce(name, _sv(v), ws, we, n))
        elif name in _ROLLING_OPS:
            ws = torch.maximum(start, i - p1)
            we = torch.minimum(pend, i + p2)
            results.append(_frame_reduce(name, _sv(v), ws, we, p1 + p2 + 1))
        elif name == "cumsum":
            sv = _sv(v)
            if sv.is_floating_point():
                results.append(_seg_scan([sv], rn0, lambda a, b: [a[0] + b[0]])[0])
            else:
                results.append(_prefix_diff(sv, start, i))
        elif name in ("sum", "mean"):
            sv = _sv(v)
            if sv.is_floating_point():
                total = _segsum(sv, gid)[gid]
            else:
                total = _prefix_diff(sv, start, pend)
            if name == "mean":
                mdt = _mean_dt(sv.dtype)
                total = total.to(mdt) / (pend - start + 1).to(mdt)
            results.append(total)
        elif name in ("min", "max"):
            sv = _sv(v)
            results.append(K.decode(_seg_extreme(K.encode(sv), gid, name)[gid], sv.dtype))
        elif name in ("cummin", "cummax"):
            sv = _sv(v)
            w, comb, _ = _minmax_setup(name, sv)
            results.append(K.decode(_seg_scan([w], rn0, lambda a, b: [comb(a[0], b[0])])[0],
                                    sv.dtype))
        elif name == "first_value":
            results.append(_take(_sv(v), start))
        elif name == "last_value":
            results.append(_take(_sv(v), pend))
        elif name == "nth_value":
            sv = _sv(v)
            fill_v = _signed(_fill(sv, fill))
            idx = start + (offset - 1)
            got = _signed(_take(sv, idx.clamp(0, n - 1)))
            results.append(torch.where(idx <= pend, got, fill_v).view(sv.dtype))
        else:  # lag / lead
            sv = _sv(v)
            fill_v = _signed(_fill(sv, fill))
            s = _signed(sv)
            k = min(offset, n)
            if name == "lag":
                shifted = _shift_back(s, k, fill_v)
                ok = rn0 >= k
            else:
                shifted = torch.cat([s[k:], fill_v.expand(k)])
                ok = i + k <= pend
            results.append(torch.where(ok, shifted, fill_v).view(sv.dtype))

    if nk:
        # back to input order: the sorted positions are a permutation
        inv = pos_s.to(torch.int64)
        restored = []
        for r in results:
            out = torch.empty_like(_signed(r))
            out[inv] = _signed(r)
            restored.append(out.view(r.dtype))
        results = restored
    return results[0] if single else results
