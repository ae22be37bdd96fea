"""Vectorized query operators: filter, searchsorted, unique, hash_join,
band_join, repeat, and the aggregation family (hash_aggregate and its
levels).

Counterpart of ``radix_sort_tpu/ops/query.py``. The names are the JAX
package's, so each function's counterpart is found by name. Outputs are
bit-identical to the reference's:

  - ``filter``: predicate compaction as a stable 1-bit partition; kept rows
    keep their order, the result is the valid prefix plus a count.
  - ``hash_join``: equi-join via sort + merge rank (sort-merge join): the
    build side is sorted once, probes rank their key range, and matches
    expand into a static-capacity output (+ overflow flag) through kernel
    K2 (``ops/expand.py``).
  - ``band_join``: non-equi join (``<``, ``<=``, ``>``, ``>=``, BETWEEN)
    with an optional equality conjunct: one right-side sort, each left
    row's matches one range of sorted positions from merge ranks, then the
    join's expansion.
  - ``repeat``: ``np.repeat`` into a static-size output (UNNEST), on K2.
  - ``hash_aggregate``: GROUP BY as a stable sort by key, group-boundary
    marks, and segment reductions: scatter-adds and scatter min/max per
    group id, or differences of running sums compacted at group ends.
    ``hash_aggregate_levels`` serves every ROLLUP level from one sort.
    Float sums are exact only to ULP(group sum): their summation order is
    the scatter's. Beside the reference's aggregations the port has the
    sample statistics of :data:`SAMPLE_AGGREGATIONS` (CORR over a pair of
    columns among them), which the JAX package lacks.

All outputs are (padded tensors..., count[, overflow]), with count and
overflow as 0-dim tensors on the input's device: slicing the first
``count`` rows gives the exact ragged result.

Key words are the port's signed int32 rank limbs (``keys.encode_limbs``),
the reference's unsigned limbs with the sign bit flipped: where the
reference zeroes a key limb, the port writes :data:`ZERO_LIMB`, so decoded
key columns match bit for bit. Join running sums are taken in int64; the
count and overflow flag come out as the reference's int32 sums with their
wraparound guard give them. Aggregate running sums keep the value's width
and wrap, as the reference's do.
"""

from __future__ import annotations

import contextlib

import torch

from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import expand, run_ends
from radix_sort_tpu_torch.ops._cosort import _groups, cosort
from radix_sort_tpu_torch.ops.expand import expand_offsets

__all__ = [
    "AGGREGATIONS",
    "AGG_CALLS",
    "AGG_KEY_PASSES",
    "AGG_RANGE",
    "COMBINABLE_AGGREGATIONS",
    "LEVEL_AGGREGATIONS",
    "PAIR_AGGREGATIONS",
    "SAMPLE_AGGREGATIONS",
    "append_unmatched_right",
    "band_join",
    "expand_offsets",
    "filter",
    "hash_aggregate",
    "hash_aggregate_levels",
    "hash_join",
    "join_expand",
    "merge_rank",
    "merge_rank_pair",
    "quantile_is_cont",
    "quantile_q",
    "repeat",
    "searchsorted",
    "unique",
    "valid_agg",
    "BAND_OPS",
    "JOIN_HOWS",
]

JOIN_HOWS = ("inner", "left", "right", "full", "semi", "anti")

# the profiler range every top-level aggregate call runs in (hash_aggregate,
# hash_aggregate_levels); AGG_CALLS counts those calls, AGG_KEY_PASSES the
# stable 64-bit sort passes their key sorts issue (one per 64 bits of key
# words: ``_cosort``'s groups). Neither count syncs the host.
AGG_RANGE = "query aggregate"
AGG_CALLS = 0
AGG_KEY_PASSES = 0

ZERO_LIMB = -(1 << 31)  # the port's image of the reference's zero limb
_INT32_MAX = (1 << 31) - 1
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _signed(a):
    """``a`` itself, or for uint16/32/64 its signed view of the same width
    (PyTorch's CPU gather, scatter and index_put have no unsigned kernels)."""
    sdt = _SIGNED_VIEW.get(a.dtype)
    return a if sdt is None else a.view(sdt)


def _i32(x, device):
    return torch.tensor(x, dtype=torch.int32, device=device)


def _mask(valid, a, fill=0):
    """``where(valid, a, fill)`` in ``a``'s own dtype (an int scalar would
    promote a bool tensor)."""
    return torch.where(valid, a, bool(fill) if a.dtype == torch.bool else fill)


def _stable_sort(operands, num_keys):
    """``lax.sort(operands, num_keys, is_stable=True)``: the keys are signed
    rank words; unsigned payloads ride as their signed views."""
    out = cosort([_signed(o) for o in operands], num_keys)
    return [o.view(src.dtype) for o, src in zip(out, operands)]


def _as_limb_list(arr_or_limbs):
    """Canonicalize a key operand: a single word tensor or a list of
    big-endian limb tensors -> list of limb tensors."""
    if isinstance(arr_or_limbs, (list, tuple)):
        return list(arr_or_limbs)
    return [arr_or_limbs]


def _cols_to_limbs(cols):
    """Encode key columns -> (flat int32 limb list, per-column specs)."""
    limbs, specs = [], []
    for c in cols:
        cl = K.encode_limbs(c)
        limbs.extend(cl)
        specs.append((c.dtype, len(cl)))
    return limbs, specs


def _limbs_to_cols(limbs, specs):
    """Inverse of :func:`_cols_to_limbs`."""
    out, i = [], 0
    for dt, nl in specs:
        out.append(K.decode_limbs(limbs[i:i + nl], dt))
        i += nl
    return out


def _limbs_differ(limbs_a, limbs_b):
    """Row-wise 'any limb differs' between two equal-shape limb lists."""
    d = limbs_a[0] != limbs_b[0]
    for a, b in zip(limbs_a[1:], limbs_b[1:]):
        d = d | (a != b)
    return d


def _exclusive_cumsum(x):
    """Exclusive prefix sum (same dtype as ``x``; int32 input sums exactly
    below 2**31 rows)."""
    return torch.cumsum(x, 0, dtype=x.dtype) - x


def merge_rank(sorted_arr, queries, side="left"):
    """``searchsorted(sorted_arr, queries, side)`` by two stable sorts: sort
    the union by (key, origin tag) -- ties put queries before data for
    side="left" and after for side="right" -- so each query's insertion
    index is its union position minus its rank among queries; a second
    sort restores query order. Few queries against much data take a direct
    binary search (:func:`_few_queries`); both give identical indices.

    Both key operands may be lists of big-endian int32 limb tensors
    (composite keys). Returns int32.
    """
    d_limbs = _as_limb_list(sorted_arr)
    q_limbs = _as_limb_list(queries)
    n_d = d_limbs[0].shape[0]
    n_q = q_limbs[0].shape[0]
    dev = q_limbs[0].device
    if len(d_limbs) == 1 and _few_queries(n_d, n_q):
        return torch.searchsorted(d_limbs[0], q_limbs[0], side=side).to(torch.int32)
    # tag and query index share one int32 operand: queries carry their
    # index, data rows a sentinel that ties to the correct side
    sentinel = _INT32_MAX if side == "left" else -1
    key = [torch.cat([d, q]) for d, q in zip(d_limbs, q_limbs)]
    packed = torch.cat([torch.full((n_d,), sentinel, dtype=torch.int32, device=dev),
                        torch.arange(n_q, dtype=torch.int32, device=dev)])
    p2 = _stable_sort([*key, packed], num_keys=len(key) + 1)[-1]
    isq = (p2 != sentinel).to(torch.int32)
    res = torch.arange(n_d + n_q, dtype=torch.int32, device=dev) - _exclusive_cumsum(isq)
    # queries to the front in original index order
    _, res2 = _stable_sort([torch.where(isq == 1, p2, _INT32_MAX), res], num_keys=1)
    return res2[:n_q]


def _few_queries(n_d, n_q):
    """True when a direct binary search is taken instead of the merge-rank
    sorts: the query side is at least 20x smaller than the data side. The
    crossover is the JAX package's (measured on its accelerator); it is to
    be re-measured on the H100 (ROADMAP.md)."""
    return n_q > 0 and n_q * 20 <= n_d


def merge_rank_pair(sorted_arr, queries):
    """Both ``searchsorted`` sides at once: ``(lo, hi)`` ==
    ``(merge_rank(..., "left"), merge_rank(..., "right"))`` with two stable
    sorts instead of four. One union sort with queries tying before equal
    data gives each query its left rank; the right rank adds the query's
    equal-key data run: the data count at the run's end, spread over the
    run (the reference fills it backwards with a reversed running min; the
    port stores each run's value at its last row,
    :func:`run_ends.run_end_values`: one store per run end, so a run of
    millions of equal keys costs its rows and no more). A final sort
    restores query order for both outputs together. Key operands may be
    limb lists.
    """
    d_limbs = _as_limb_list(sorted_arr)
    q_limbs = _as_limb_list(queries)
    n_d = d_limbs[0].shape[0]
    n_q = q_limbs[0].shape[0]
    dev = q_limbs[0].device
    if len(d_limbs) == 1 and _few_queries(n_d, n_q):
        return tuple(torch.searchsorted(d_limbs[0], q_limbs[0], side=s).to(torch.int32)
                     for s in ("left", "right"))
    n = n_d + n_q
    key = [torch.cat([d, q]) for d, q in zip(d_limbs, q_limbs)]
    packed = torch.cat([torch.full((n_d,), _INT32_MAX, dtype=torch.int32, device=dev),
                        torch.arange(n_q, dtype=torch.int32, device=dev)])
    out = _stable_sort([*key, packed], num_keys=len(key) + 1)
    k2, p2 = out[:-1], out[-1]
    isq = (p2 != _INT32_MAX).to(torch.int32)
    lo_pos = torch.arange(n, dtype=torch.int32, device=dev) - _exclusive_cumsum(isq)
    cum_data = torch.cumsum(1 - isq, 0, dtype=torch.int32)
    # the reference's reversed running min over the run ends, as each
    # equal-key run's value at its last row (cum_data never decreases, so
    # that is the run's max): PyTorch's cummin, which also makes indices,
    # scans a long 1-D tensor in one row (83% of a 75M-row union's join time
    # on the H100), and an atomic max per run serialises on a long run
    # (PERF.md)
    run_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                           _limbs_differ([w[1:] for w in k2], [w[:-1] for w in k2])])
    run_id = torch.cumsum(run_start, 0, dtype=torch.int64) - 1
    run_max = run_ends.run_end_values(run_start, run_id, cum_data)
    hi_pos = run_max[run_id]
    _, lo2, hi2 = _stable_sort([torch.where(isq == 1, p2, _INT32_MAX), lo_pos, hi_pos],
                               num_keys=1)
    return lo2[:n_q], hi2[:n_q]


def filter(mask: torch.Tensor, *arrays: torch.Tensor):
    """Compact rows where ``mask`` is True, preserving order.

    Returns ``(*compacted, count)``: each output has the input length; rows
    [0, count) are the kept rows in their original order, the tail is the
    dropped rows (also in order -- the op is a stable partition).
    """
    if not arrays:
        raise ValueError("filter needs at least one array")
    n = mask.shape[0]
    for a in arrays:
        if a.shape[0] != n:
            raise ValueError(f"all arrays must match mask length {n}, got {tuple(a.shape)}")
    discard = (~mask).to(torch.int32)
    out = _stable_sort([discard, *arrays], num_keys=1)
    return (*out[1:], mask.sum(dtype=torch.int32))


# ------------------------------------------------------------ aggregation

AGGREGATIONS = (
    "sum", "count", "min", "max", "mean",
    "any", "all",                 # bool OR / AND over (value != 0)
    "first", "last",              # group's first/last value in input order
    "median",                     # lower order statistic (exact)
    "mode",                       # most frequent value (ties: smallest)
    "var", "std",                 # population variance / stddev (two-pass)
    "count_distinct",             # distinct values per group
    "argmin", "argmax",           # input position of the group min/max
)
# "quantile:<q>" (0 <= q <= 1) is accepted anywhere an aggregation name is:
# the group's lower order statistic at rank floor(q*(len-1)), PERCENTILE_DISC
# ("quantile:0.5" == "median"). "quantile_cont:<q>" interpolates linearly
# between the two bracketing order statistics (PERCENTILE_CONT), in float64.

# the port's sample statistics, which the JAX package lacks: sample variance
# and standard deviation (divisor n - 1) and Pearson's correlation of a pair
# of columns, each in float64 and NaN where undefined (a group of fewer than
# 2 rows; for corr, a column constant over the group). Their value operand
# may end in a bool column: rows where it is False are skipped (SQL NULLs).
SAMPLE_AGGREGATIONS = ("var_samp", "std_samp", "corr")
# aggregations whose value operand is a pair of columns (x, y)
PAIR_AGGREGATIONS = ("corr",)

# aggregations whose per-shard partials combine with a plain reduction
COMBINABLE_AGGREGATIONS = ("sum", "count", "min", "max", "mean", "any", "all")
# aggregations computable per prefix level from one shared full-key sort
LEVEL_AGGREGATIONS = ("sum", "count", "mean", "min", "max", "any", "all", "var", "std")
# the multi-aggregate hands these (and the quantiles) to a single-aggregate
# call, one sort by (key, value) each
_DELEGATED = ("median", "count_distinct", "mode", "argmin", "argmax")
# the single-aggregate call sorts by (key, value) for these; the rest run as
# one column of the multi-aggregate
_BY_VALUE = ("min", "max") + _DELEGATED


def quantile_q(agg):
    """The q of a ``"quantile:<q>"`` / ``"quantile_cont:<q>"`` aggregation
    name, else None."""
    if isinstance(agg, str) and (agg.startswith("quantile:")
                                 or agg.startswith("quantile_cont:")):
        try:
            q = float(agg.split(":", 1)[1])
        except ValueError:
            return None
        if 0.0 <= q <= 1.0:
            return q
    return None


def quantile_is_cont(agg):
    return isinstance(agg, str) and agg.startswith("quantile_cont:")


def valid_agg(agg):
    return agg in AGGREGATIONS or agg in SAMPLE_AGGREGATIONS or quantile_q(agg) is not None


def _check_agg(agg):
    if not valid_agg(agg):
        raise ValueError(f"agg must be one of {AGGREGATIONS + SAMPLE_AGGREGATIONS} or "
                         f"'quantile:<q>', got {agg!r}")


def _operand(agg, value):
    """The columns of an aggregation's value operand: one tensor, or for a
    sample statistic a tuple (x[, y][, keep])."""
    if agg in SAMPLE_AGGREGATIONS and isinstance(value, (list, tuple)):
        width = 2 if agg in PAIR_AGGREGATIONS else 1
        if len(value) not in (width, width + 1):
            raise ValueError(f"{agg} takes {'(x, y)' if width == 2 else 'x'} and an optional "
                             f"bool keep column, got {len(value)} columns")
        return tuple(value)
    if agg in PAIR_AGGREGATIONS:
        raise ValueError(f"{agg} takes a pair of columns (x, y)")
    return (value,)


def _mean_dt(dt):
    return torch.float64 if dt == torch.float64 else torch.float32


def _out_dt(agg, dt):
    """Output dtype of ``agg`` over values of ``dt`` (what an empty input
    returns: the dtype a non-empty one gives, where the reference returns
    the value dtype for ``quantile_cont`` and a bool ``sum``; ROADMAP.md)."""
    if agg in ("count", "count_distinct", "argmin", "argmax"):
        return torch.int32
    if agg in SAMPLE_AGGREGATIONS:
        return torch.float64
    if agg in ("mean", "var", "std"):
        return _mean_dt(dt)
    if agg in ("any", "all"):
        return torch.bool
    if quantile_is_cont(agg):
        return torch.float64
    if agg == "sum" and dt == torch.bool:
        return torch.int64
    return dt


def _key_cols(keys):
    """(columns, is_list, n) of a GROUP BY key operand, validated."""
    multi = isinstance(keys, (list, tuple))
    cols = list(keys) if multi else [keys]
    if not cols:
        raise ValueError("keys must have at least one column")
    n = cols[0].shape[0]
    if any(c.shape[0] != n for c in cols):
        raise ValueError("all key columns must have equal length")
    return cols, multi, n


def _mark_first(limbs):
    """True at each row whose limbs differ from the previous row's."""
    return torch.cat([torch.ones((1,), dtype=torch.bool, device=limbs[0].device),
                      _limbs_differ([w[1:] for w in limbs], [w[:-1] for w in limbs])])


def _mark_last(first):
    return torch.cat([first[1:], first.new_ones((1,))])


def _shift1(c, fill):
    """``c`` moved one row down with ``fill`` on top (the reference's
    ``jnp.roll(c, 1).at[0].set(fill)``)."""
    return torch.cat([torch.full((1,), fill, dtype=c.dtype, device=c.device), c[:-1]])


def _diff(c):
    """Consecutive differences, the first row against 0 (exact under the
    dtype's wraparound)."""
    return c - _shift1(c, 0)


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, bounds scalar or tensor
    (a negative tensor bound ``hi`` wins, as in the reference)."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp(min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp(max=hi)


def _take(a, idx):
    """``a[idx]`` for any dtype (unsigned ones gather as their signed view)."""
    return _signed(a)[idx].view(a.dtype)


def _fit(a, capacity):
    """``a`` cut or zero-padded to ``capacity`` rows."""
    if a.shape[0] >= capacity:
        return a[:capacity]
    return torch.cat([a, a.new_zeros((capacity - a.shape[0],))])


def _gid(first):
    """Segment id of every row: the count of run starts up to it, minus 1."""
    return torch.cumsum(first, 0, dtype=torch.int64) - 1


def _run_bounds(first, end=False):
    """Each row's int32 run start (or end) position, runs starting where
    ``first`` is True: the reference's forward running max (or reversed
    running min) of the marked positions, as a lookup of the marked
    positions by run id. PyTorch's cummin/cummax scan a long 1-D tensor in
    one row, and a scatter min/max per run contends on one address when the
    runs are few (PERF.md); ``nonzero`` costs one host sync."""
    marks = _mark_last(first) if end else first
    return torch.nonzero(marks).squeeze(1).to(torch.int32)[_gid(first)]


def _segsum(x, gid):
    """``jax.ops.segment_sum(x, gid, num_segments=len(x))``: untouched
    segments hold 0. A float scatter-add on the card is atomic, so its
    summation order varies between runs."""
    return torch.zeros_like(x).index_add_(0, gid, x)


def _seg_extreme(w, gid, op):
    """Segment min or max of rank words; untouched segments hold the
    reference's identity (its unsigned word's max for min, 0 for max: the
    signed word's max and min)."""
    info = torch.iinfo(w.dtype)
    fill = info.max if op == "min" else info.min
    return torch.full_like(w, fill).scatter_reduce_(0, gid, w, "a" + op)


def _running_sum(x):
    """``jnp.cumsum`` of integer values: the value's own width, wrapping
    (bool counts in int64, as the reference under x64). Unsigned values sum
    as their signed view, the same bits. The returned tensor is that view;
    :func:`_as_sum` turns a difference of it back."""
    if x.dtype == torch.bool:
        return torch.cumsum(x, 0, dtype=torch.int64)
    s = _signed(x)
    return torch.cumsum(s, 0, dtype=s.dtype)


def _as_sum(d, dt):
    return d if dt == torch.bool else d.view(dt)


def _nonzero(x):
    return _signed(x) != 0


@contextlib.contextmanager
def _aggregate_call():
    """One top-level aggregate call: counted in :data:`AGG_CALLS` and run
    inside the :data:`AGG_RANGE` profiler range."""
    global AGG_CALLS
    AGG_CALLS += 1
    with torch.profiler.record_function(AGG_RANGE):
        yield


def _agg_sort(operands, num_keys):
    """An aggregate's key sort (:func:`_stable_sort`), its 64-bit passes
    counted in :data:`AGG_KEY_PASSES`."""
    global AGG_KEY_PASSES
    AGG_KEY_PASSES += len(_groups(operands[:num_keys]))
    return _stable_sort(operands, num_keys)


def hash_aggregate(keys, values, agg: str = "sum", *, _positions=None):
    """Group ``values`` by ``keys`` and reduce with ``agg``.

    Returns ``(unique_keys, aggregates, count)``: rows [0, count) hold one
    group each, keys ascending under the key dtype's total order; the tails
    are the reference's, bit for bit.

    ``keys`` may be a list of equal-length columns (composite GROUP BY key,
    any supported dtype mix); ``unique_keys`` is then a list and groups
    order lexicographically (first column primary). ``values`` and ``agg``
    may be parallel lists (``SELECT sum(a), min(b), count(*) ... GROUP BY
    k``) sharing one key sort (:func:`_hash_aggregate_multi`);
    ``aggregates`` is then a list.

    sum/count accumulate in the value dtype (wrapping for integers, IEEE
    for floats; a float sum is a scatter-add per group); min/max are exact
    for any supported dtype; mean is group sum / group count in float32
    (float64 values keep float64). The holistic aggregations: ``first`` /
    ``last`` (input order; the key sort is stable), ``median`` (the lower
    order statistic, dtype kept), ``quantile:<q>`` and ``quantile_cont:<q>``
    (above :data:`AGGREGATIONS`), ``var`` / ``std`` (population, two-pass),
    ``count_distinct`` (int32), ``mode`` (most frequent value, ties to the
    smallest under the total order), ``argmin`` / ``argmax`` (int32 input
    position of the group's min / max, first occurrence). ``any`` / ``all``
    reduce ``value != 0`` to a bool per group.

    The sample statistics (:data:`SAMPLE_AGGREGATIONS`) are float64:
    ``var_samp`` / ``std_samp`` (divisor n - 1) and ``corr`` (Pearson's r),
    whose value is the pair ``(x, y)``. Each is two-pass, every column first
    shifted by its group's first value, so a constant column reads variance
    0 exactly. They are NaN where undefined: fewer than 2 rows, or for
    ``corr`` a constant column. A trailing bool column in the value operand
    (``(x, keep)``, ``(x, y, keep)``) skips the rows where it is False.

    ``_positions`` (internal): the position column ``argmin`` / ``argmax``
    report instead of the row index.
    """
    with _aggregate_call():
        return _hash_aggregate(keys, values, agg, _positions=_positions)


def _hash_aggregate(keys, values, agg, *, _positions=None):
    """:func:`hash_aggregate` outside its profiler range and count."""
    if isinstance(agg, (list, tuple)) or (isinstance(values, (list, tuple))
                                          and agg not in SAMPLE_AGGREGATIONS):
        if not (isinstance(agg, (list, tuple)) and isinstance(values, (list, tuple))):
            raise ValueError("multi-aggregate needs BOTH values and agg as lists")
        if len(values) != len(agg) or not values:
            raise ValueError("values and agg lists must be non-empty and equal-length")
        return _hash_aggregate_multi(keys, list(values), list(agg), _positions=_positions)
    _check_agg(agg)
    if agg in SAMPLE_AGGREGATIONS:
        uk, (out,), count = _hash_aggregate_multi(keys, [values], [agg])
        return uk, out, count
    cols, multi, n = _key_cols(keys)
    if values.shape[0] != n:
        raise ValueError("keys and values must have the same length")
    dev = values.device
    if n == 0:
        return keys, torch.zeros((0,), dtype=_out_dt(agg, values.dtype), device=dev), _i32(0, dev)
    q = 0.5 if agg == "median" else quantile_q(agg)
    if agg not in _BY_VALUE and q is None:
        # one column of the multi-aggregate: the same sort, reductions and tails
        uk, (out,), count = _hash_aggregate_multi(keys, [values], [agg])
        return uk, out, count
    # sort by (key, value): the group's order statistics sit at known
    # offsets and (key, value) runs mark distinct values
    limbs, specs = _cols_to_limbs(cols)
    nk = len(limbs)
    vw = K.encode(values)
    if agg in ("argmin", "argmax"):
        posr = (_positions if _positions is not None
                else torch.arange(n, dtype=torch.int32, device=dev))
        *sk, svw, sposr = _agg_sort([*limbs, vw, posr], num_keys=nk + 1)
    else:
        *sk, svw = _agg_sort([*limbs, vw], num_keys=nk + 1)
    sv = K.decode(svw, values.dtype)
    first = _mark_first(sk)
    last = _mark_last(first)
    uk_cols = _limbs_to_cols(sk, specs)
    pos = torch.arange(n, dtype=torch.int32, device=dev)

    def _pack(keys_out):
        return keys_out if multi else keys_out[0]

    if agg in ("min", "max"):
        *out_keys, out_vals, count = filter(first if agg == "min" else last, *uk_cols, sv)
        return _pack(out_keys), out_vals, count
    if agg == "count_distinct":
        # (key, value) run starts, counted per group by a prefix difference
        csum = torch.cumsum(_mark_first([*sk, svw]), 0, dtype=torch.int32)
        *out_keys, csum_c, count = filter(last, *uk_cols, csum)
        return _pack(out_keys), _diff(csum_c), count
    *out_keys, ends_c, count = filter(last, *uk_cols, pos)
    starts_c = _shift1(ends_c, -1) + 1  # group starts
    if q is not None:
        # the group's order statistic at floor(q*(len-1)): exact integer
        # halving for the median, float32 rank math for a general q
        span = ends_c - starts_c
        if quantile_is_cont(agg):
            # PERCENTILE_CONT in float64 (the reference's type under x64)
            r = span.to(torch.float64) * q
            lo = _clip(torch.floor(r + 1e-6).to(torch.int32), 0, span)
            hi = torch.minimum(lo + 1, span)
            frac = (r - lo.to(torch.float64)).clamp(0.0, 1.0)
            vlo = _take(sv, _clip(starts_c + lo, 0, n - 1)).to(torch.float64)
            vhi = _take(sv, _clip(starts_c + hi, 0, n - 1)).to(torch.float64)
            return _pack(out_keys), vlo + frac * (vhi - vlo), count
        if agg == "median":
            off = span // 2
        else:
            off = torch.floor(span.to(torch.float32) * q + 1e-6).to(torch.int32)
        q_idx = starts_c + _clip(off, 0, span)
        return _pack(out_keys), _take(sv, _clip(q_idx, 0, n - 1)), count
    if agg in ("argmin", "argmax"):
        # positions ride the (key, value) sort: the group's first row holds
        # argmin, the first row of its last value run argmax (the first
        # occurrence among ties, both)
        idx = starts_c
        if agg == "argmax":
            idx = _run_bounds(_mark_first([*sk, svw]))[_clip(ends_c, 0, n - 1)]
        return _pack(out_keys), sposr[_clip(idx, 0, n - 1)].to(torch.int32), count
    # mode: the group's longest (key, value) run, ties to the first (the
    # smallest value). The reference's reversed segmented doubling scan over
    # (run length, value word), every row carrying its run's pair; group
    # start rows end up holding the whole group's best
    kv_first = _mark_first([*sk, svw])
    run_len = _run_bounds(kv_first, end=True) - _run_bounds(kv_first) + 1
    pend = _run_bounds(first, end=True)
    best_l, best_w = run_len, svw
    s = 1
    while s < n:
        nl = torch.cat([best_l[s:], best_l.new_zeros((s,))])
        nw = torch.cat([best_w[s:], best_w.new_zeros((s,))])
        better = (pos + s <= pend) & ((nl > best_l) | ((nl == best_l) & (nw < best_w)))
        best_l = torch.where(better, nl, best_l)
        best_w = torch.where(better, nw, best_w)
        s *= 2
    return _pack(out_keys), K.decode(best_w[_clip(starts_c, 0, n - 1)], values.dtype), count


def _reduce(agg, sv, gid, group_n, int_sum=None, ntrue=None, words=None):
    """One aggregate per group from a sort by key, row g for group g:
    ``group_n`` holds the group sizes, ``int_sum`` / ``ntrue`` the
    prefix-difference sum / true-row count of an integer sum or any/all,
    ``words`` the rank words of a min/max column (encoded here if None).
    Float sums are a scatter-add per group: each group accumulates on its
    own, at ULP(group sum), where a difference of running sums would carry
    the rounding of the whole prefix before the group. Untouched segments
    (the tail) hold the reference's values."""
    if agg == "count":
        return group_n
    if agg in ("any", "all"):
        return ntrue != 0 if agg == "any" else ntrue == group_n  # ntrue unsigned there
    mdt = _mean_dt(sv.dtype)
    if agg in ("sum", "mean"):
        s = _segsum(sv, gid) if sv.is_floating_point() else int_sum
        return s if agg == "sum" else s.to(mdt) / group_n.clamp(min=1).to(mdt)
    if agg in ("var", "std"):
        # two-pass moments
        x = sv.to(mdt)
        cnt_g = group_n.clamp(min=1).to(mdt)
        d = x - (_segsum(x, gid) / cnt_g)[gid]
        v = _segsum(d * d, gid) / cnt_g
        return torch.sqrt(v) if agg == "std" else v
    # min / max: a segment reduction on rank words, decoded
    words = K.encode(sv) if words is None else words
    return K.decode(_seg_extreme(words, gid, agg), sv.dtype)


def _prefix_sums(int_cols, truth_cols):
    """The running sums a group-end filter differences: each integer
    column's, in its own width (wrapping), then each any/all column's count
    of true rows."""
    return ([_running_sum(x) for x in int_cols]
            + [torch.cumsum(_nonzero(x), 0, dtype=torch.int32) for x in truth_cols])


def _group_ends(first, key_cols, runs, carried=()):
    """One filter at group ends (the rows before each group start marked in
    ``first``) of the key columns, the row positions, the running sums
    ``runs`` and the ``carried`` columns. Returns ``(keys, group_n, diffs,
    carried_c, count)``: the group sizes, each running sum differenced into
    per-group values (exact under wraparound), and the carried columns'
    last rows."""
    pos = torch.arange(first.shape[0], dtype=torch.int32, device=first.device)
    *c, count = filter(_mark_last(first), *key_cols, pos, *runs, *carried)
    nk, nr = len(key_cols), len(runs)
    pos_c = c[nk]
    return (c[:nk], pos_c - _shift1(pos_c, -1), [_diff(r) for r in c[nk + 1:nk + 1 + nr]],
            c[nk + 1 + nr:], count)


def _hash_aggregate_multi(keys, val_cols, aggs, _positions=None):
    """Several aggregations over one GROUP BY, sharing a single key sort.

    The value columns ride one stable sort by the key limbs; per-group
    reductions (:func:`_reduce`) come from segment ops over the group ids
    (float sums, min, max, var/std) or running-sum differences (integer
    sums, counts, any/all), and everything compacted at group ends
    (``last`` values included) goes through one :func:`filter` (``first``
    values share a second). The (key, value)-sorted aggregations (median,
    quantiles, count_distinct, mode, argmin, argmax) each delegate to a
    single-aggregate call, one extra sort each; both order groups by key,
    so rows align. The sample statistics' columns ride the key sort too
    (:func:`_sample_stat`). Returns ``(unique_keys, [aggregates...],
    count)``.
    """
    for a in aggs:
        _check_agg(a)
    cols, multi, n = _key_cols(keys)
    operands = [_operand(a, v) for a, v in zip(aggs, val_cols)]
    if any(c.shape[0] != n for op in operands for c in op):
        raise ValueError("all key/value columns must have equal length")
    dev = cols[0].device
    if n == 0:
        return keys, [torch.zeros((0,), dtype=_out_dt(a, op[0].dtype), device=dev)
                      for a, op in zip(aggs, operands)], _i32(0, dev)
    delegated = {
        i: _hash_aggregate(keys, val_cols[i], a, _positions=_positions)[1]
        for i, a in enumerate(aggs) if a in _DELEGATED or quantile_q(a) is not None
    }
    own = [i for i in range(len(aggs)) if i not in delegated]
    limbs, specs = _cols_to_limbs(cols)
    nk = len(limbs)
    out = iter(_agg_sort([*limbs, *[c for i in own for c in operands[i]]], num_keys=nk))
    sk = [next(out) for _ in range(nk)]
    sorted_ops = {i: tuple(next(out) for _ in operands[i]) for i in own}
    svs = {i: op[0] for i, op in sorted_ops.items()}
    first = _mark_first(sk)

    def _of(*names):
        return [i for i in own if aggs[i] in names]

    int_idx = [i for i in _of("sum", "mean") if not svs[i].is_floating_point()]
    truth_idx, last_idx, first_idx = _of("any", "all"), _of("last"), _of("first")
    out_keys, group_n, diffs, lasts, count = _group_ends(
        first, _limbs_to_cols(sk, specs),
        _prefix_sums([svs[i] for i in int_idx], [svs[i] for i in truth_idx]),
        [svs[i] for i in last_idx])
    int_sums = {i: _as_sum(d, svs[i].dtype) for i, d in zip(int_idx, diffs)}
    ntrues = dict(zip(truth_idx, diffs[len(int_idx):]))
    picked = dict(zip(last_idx, lasts))
    if first_idx:
        picked.update(zip(first_idx, filter(first, *[svs[i] for i in first_idx])[:-1]))
    gid = _gid(first)
    sample_idx = _of(*SAMPLE_AGGREGATIONS)
    if sample_idx:
        # each row's group start: the groups' sizes summed before it
        start = (torch.cumsum(group_n, 0, dtype=torch.int64) - group_n)[gid]
        picked.update((i, _sample_stat(aggs[i], sorted_ops[i], gid, start, group_n))
                      for i in sample_idx)
    results = [delegated[i] if i in delegated else picked[i] if i in picked else
               _reduce(a, svs[i], gid, group_n, int_sums.get(i), ntrues.get(i))
               for i, a in enumerate(aggs)]
    return (out_keys if multi else out_keys[0]), results, count


def _sample_stat(agg, cols, gid, start, group_n):
    """``var_samp`` / ``std_samp`` of x, or ``corr`` of (x, y), per group,
    from columns sorted by key: row g for group g. ``start`` is each row's
    group start, ``group_n`` the group sizes; a trailing bool column keeps
    rows. Two passes in float64, each column first shifted by its group's
    first kept value: a constant column's rows shift to exact zeros, so its
    variance reads 0 and not its mean's rounding."""
    width = 2 if agg in PAIR_AGGREGATIONS else 1
    xs, keep = cols[:width], (cols[width] if len(cols) > width else None)
    f64 = torch.float64
    if keep is None:
        n_g = group_n.to(f64)
        ref = start
    else:
        n_g = _segsum(keep.to(f64), gid)
        # the first kept row of each row's group: the next kept row at or
        # after the group start (searched in the running count of kept rows)
        kept = torch.cumsum(keep, 0, dtype=torch.int64)
        before = kept[start] - keep[start].to(torch.int64)
        ref = torch.searchsorted(kept, before + 1).clamp(max=gid.shape[0] - 1)
    centred = []
    for x in xs:
        x = x.to(f64)
        d = x - x[ref]
        if keep is not None:
            d = torch.where(keep, d, 0.0)
        e = d - (_segsum(d, gid) / n_g.clamp(min=1))[gid]
        if keep is not None:
            e = torch.where(keep, e, 0.0)
        centred.append(e)
    ex = centred[0]
    sxx = _segsum(ex * ex, gid)
    undefined = n_g < 2
    if agg == "corr":
        ey = centred[1]
        syy = _segsum(ey * ey, gid)
        out = _segsum(ex * ey, gid) / (torch.sqrt(sxx) * torch.sqrt(syy))
        undefined |= (sxx == 0) | (syy == 0)
    else:
        out = sxx / (n_g - 1).clamp(min=1)
        if agg == "std_samp":
            out = torch.sqrt(out)
    return torch.where(undefined, torch.nan, out)


def hash_aggregate_levels(keys, val_cols, aggs, level_cols):
    """Prefix-sharing multi-aggregate for GROUPING SETS chains (ROLLUP): one
    stable sort by all key columns serves every leading-prefix level (data
    sorted by the full key list is sorted by any prefix of it), so an
    L-level ROLLUP costs one multi-key sort plus L boundary and compaction
    sweeps.

    ``keys``: list of key columns. ``level_cols``: one leading-column count
    per level (0 = one global group, the grand total). ``aggs`` must all be
    in :data:`LEVEL_AGGREGATIONS`; integer sums and any/all share
    level-independent running sums, float sums and min/max/var/std take one
    segment reduction per level.

    Returns ``[(unique_key_cols, [aggregates...], count), ...]`` aligned
    with ``level_cols``, each shaped like :func:`hash_aggregate`'s output
    (padded to n; group j of a level = the j-th distinct key prefix in
    ascending order).
    """
    with _aggregate_call():
        return _hash_aggregate_levels(keys, val_cols, aggs, level_cols)


def _hash_aggregate_levels(keys, val_cols, aggs, level_cols):
    """:func:`hash_aggregate_levels` outside its profiler range and count."""
    for a in aggs:
        if a not in LEVEL_AGGREGATIONS:
            raise ValueError(f"hash_aggregate_levels supports {LEVEL_AGGREGATIONS}, got {a!r}")
    cols = list(keys)
    if not cols:
        raise ValueError("keys must have at least one column")
    n = cols[0].shape[0]
    if any(x.shape[0] != n for x in list(cols[1:]) + list(val_cols)):
        raise ValueError("all key/value columns must have equal length")
    level_cols = [int(c) for c in level_cols]
    for c in level_cols:
        if not 0 <= c <= len(cols):
            raise ValueError(f"level column count {c} out of range 0..{len(cols)}")
    dev = cols[0].device
    if n == 0:
        return [([torch.zeros((0,), dtype=k.dtype, device=dev) for k in cols[:c]],
                 [torch.zeros((0,), dtype=_out_dt(a, v.dtype), device=dev)
                  for a, v in zip(aggs, val_cols)], _i32(0, dev)) for c in level_cols]

    limbs, specs = _cols_to_limbs(cols)
    limb_at = [0]  # limb count of each leading-column prefix
    for _, nl in specs:
        limb_at.append(limb_at[-1] + nl)
    nk = len(limbs)
    out = _agg_sort([*limbs, *val_cols], num_keys=nk)
    sk, svs = out[:nk], out[nk:]
    uk_all = _limbs_to_cols(sk, specs)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    int_idx = [i for i, (a, sv) in enumerate(zip(aggs, svs))
               if a in ("sum", "mean") and not sv.is_floating_point()]
    truth_idx = [i for i, a in enumerate(aggs) if a in ("any", "all")]
    # level-independent: the running sums (each level only re-compacts
    # them) and the min/max rank words
    runs = _prefix_sums([svs[i] for i in int_idx], [svs[i] for i in truth_idx])
    words = {i: K.encode(svs[i]) for i, a in enumerate(aggs) if a in ("min", "max")}

    results = []
    for c in level_cols:
        nl = limb_at[c]
        firstk = pos == 0 if nl == 0 else _mark_first(sk[:nl])
        out_keys, group_n, diffs, _, count = _group_ends(firstk, uk_all[:c], runs)
        int_sums = {i: _as_sum(d, svs[i].dtype) for i, d in zip(int_idx, diffs)}
        ntrues = dict(zip(truth_idx, diffs[len(int_idx):]))
        gid = _gid(firstk)
        results.append((list(out_keys), [
            _reduce(a, sv, gid, group_n, int_sums.get(i), ntrues.get(i), words.get(i))
            for i, (a, sv) in enumerate(zip(aggs, svs))], count))
    return results


# ------------------------------------------------------------ expansion on K2


def _run_sums(emit, capacity):
    """The prefix-sum bookkeeping of an expansion, summed in int64:
    ``(ends, count, overflow)``, with ``ends`` the inclusive prefix sum of
    the emits clamped at ``capacity`` (int32), which cuts each run so the
    cumulative output stays within it. A true total of 2**31 rows or more
    is where the reference's int32 running sum wraps and its guard forces
    the overflow flag and a count of ``capacity``; in int64 such a total is
    simply above the capacity, so both agree."""
    ends = torch.cumsum(emit, 0, dtype=torch.int64)
    total = ends[-1] if ends.shape[0] else torch.zeros((), dtype=torch.int64,
                                                       device=emit.device)
    return (ends.clamp(max=capacity).to(torch.int32), total.clamp(max=capacity).to(torch.int32),
            total > capacity)


def _expand_rows(cols, counts, total_size):
    """Shared UNNEST core: emit row i of every column ``counts[i]`` times,
    in order, into static ``total_size`` rows, through K2 (every column
    broadcast, tail 0). Returns ``(outs, count, overflow)`` with
    :func:`repeat`'s contract."""
    dev = counts.device
    if counts.shape[0] == 0:
        return ([torch.zeros((total_size,), dtype=c.dtype, device=c.device) for c in cols],
                _i32(0, dev), torch.tensor(False, device=dev))
    # the reference's astype(int32): wide counts wrap, then negatives clamp
    counts = counts.to(torch.int32).clamp(min=0)
    ends, count, overflow = _run_sums(counts, total_size)
    outs, _ = expand.expand_rows(ends, None, None, [expand.Column(c) for c in cols],
                                 capacity=total_size)
    return outs, count, overflow


def repeat(values: torch.Tensor, counts: torch.Tensor, *, total_size: int):
    """``np.repeat(values, counts)`` into a static-size output (the unnest
    primitive): element i is emitted ``counts[i]`` times, in order.

    Returns ``(out, count, overflow)``: rows [0, count) hold the expansion,
    the tail is 0. ``overflow`` is True if the true expansion exceeds
    ``total_size`` (the result then holds the first ``total_size`` rows,
    exactly). Every call goes through kernel K2 (on the CPU, its plain
    version).
    """
    if counts.shape[0] != values.shape[0]:
        raise ValueError("values and counts must have the same length")
    (out,), count, overflow = _expand_rows([values], counts, total_size)
    return out, count, overflow


def join_expand(lkw, left_values, rvs, lo, hi, *, capacity, how="inner", valid_left=None):
    """The match-expansion phase of the join: given each left row's
    sorted-right match range [lo, hi), emit the join result for ``how``
    into static-``capacity`` outputs.

    Operates on encoded key limbs (``lkw``, a single limb tensor or a list
    of big-endian limbs; the returned key words match its shape); callers
    decode. ``valid_left`` (bool, one per left row) masks out padding rows
    of a distributed shard: they emit nothing and never count as matched.
    Returns ``(key_words, left_vals, right_vals, count, overflow)``.
    ``how="full"`` emits the left-join rows only (callers append the
    unmatched right rows with :func:`append_unmatched_right`);
    ``how="right"`` is a side swap resolved by the callers. Inner and left
    joins expand through K2.
    """
    if how not in JOIN_HOWS or how == "right":
        raise ValueError(
            f"join_expand handles {tuple(h for h in JOIN_HOWS if h != 'right')},"
            f" got {how!r} (right joins swap sides before expansion)")
    if how == "full":
        how = "left"
    multi = isinstance(lkw, (list, tuple))
    lkws = _as_limb_list(lkw)
    multi_lv = isinstance(left_values, (list, tuple))
    lvs = list(left_values) if multi_lv else [left_values]
    multi_rv = isinstance(rvs, (list, tuple))
    rvs_l = list(rvs) if multi_rv else [rvs]
    dev = lo.device

    def _pack(outs_k, outs_lv, outs_rv, count, overflow):
        return (outs_k if multi else outs_k[0], outs_lv if multi_lv else outs_lv[0],
                outs_rv if multi_rv else outs_rv[0], count, overflow)

    matches = hi - lo
    if valid_left is not None:
        matches = torch.where(valid_left, matches, 0)

    if how in ("semi", "anti"):
        # one output row per qualifying left row, in left order: a stable
        # filter, no expansion
        sel = (matches > 0) if how == "semi" else (matches == 0)
        if valid_left is not None:
            sel = sel & valid_left
        *c_all, cnt = filter(sel, *lkws, *lvs)
        valid = torch.arange(capacity, device=dev) < cnt.clamp(max=capacity)
        return _pack([_mask(valid, _fit(k, capacity), ZERO_LIMB) for k in c_all[:len(lkws)]],
                     [_mask(valid, _fit(v, capacity)) for v in c_all[len(lkws):]],
                     [torch.zeros((capacity,), dtype=rv.dtype, device=dev) for rv in rvs_l],
                     cnt.clamp(max=capacity), cnt > capacity)

    # inner/left: prefix-sum output addressing. A left join emits exactly
    # one row (with right value 0) for each unmatched left row.
    emit = matches
    if how == "left":
        emit = torch.where(matches == 0, 1, matches)
        if valid_left is not None:
            emit = torch.where(valid_left, emit, 0)
    return _pack(*_join_expand_kernel(lkws, lvs, rvs_l, lo, matches, emit, capacity))


def _join_expand_kernel(lkws, lvs, rvs_l, lo, matches, emit, capacity):
    """Run-append expansion through K2 (``ops/expand.py``), the whole row
    in one call: key limbs and left values broadcast per left row, right
    values copied from its match range ``[lo, lo + matches)``; tails
    :data:`ZERO_LIMB` for the keys and 0 for the values. The clamped run
    ends cut emission so the cumulative output never exceeds ``capacity``:
    the first ``capacity`` rows are exact even on overflow (a run cut
    short copies fewer rows, so ``matches`` needs no clamp). Returns
    ``(key_word_list, lv_list, rv_list, count, overflow)``."""
    ends, count, overflow = _run_sums(emit, capacity)
    cols = ([expand.Column(k, tail=ZERO_LIMB) for k in lkws]
            + [expand.Column(v) for v in lvs] + [expand.Column(v, copied=True) for v in rvs_l])
    outs, _ = expand.expand_rows(ends, lo, matches, cols, capacity=capacity)
    nk, nl = len(lkws), len(lvs)
    return outs[:nk], outs[nk:nk + nl], outs[nk + nl:], count, overflow


def append_unmatched_right(out_ks, out_lv, out_rv, count, overflow, rks, rvs, lo, hi,
                           *, capacity, valid_left=None, valid_right=None):
    """Complete a full outer join: append the unmatched sorted-right rows
    (left value 0) after the left-join block already in ``out_*``.

    A sorted-right row is matched iff it lies inside some left row's match
    range [lo_i, hi_i): range-marked with +1/-1 at the range ends and a
    cumsum. Unmatched rows compact stably (right sorted order) and land at
    output slots [count, count + n_unmatched); rows past ``capacity`` are
    dropped and flagged, so the first ``capacity`` rows stay exact.
    ``out_ks`` / ``rks`` are parallel limb lists; ``rvs`` / ``out_rv`` may
    be value-column lists; ``valid_left`` / ``valid_right`` mask the
    padding rows of a distributed shard (a padding left row covers no
    right row, a padding right row is never appended). Returns
    ``(out_ks, out_lv, out_rv, count, overflow)`` with the same contract.
    """
    multi_rv = isinstance(rvs, (list, tuple))
    rvs_l = list(rvs) if multi_rv else [rvs]
    orv_l = list(out_rv) if multi_rv else [out_rv]
    n_r = rvs_l[0].shape[0]
    dev = lo.device
    has = hi > lo
    if valid_left is not None:
        has = has & valid_left
    one = has.to(torch.int32)
    delta = torch.zeros((n_r + 1,), dtype=torch.int32, device=dev)
    delta.index_add_(0, lo.clamp(0, n_r).to(torch.int64), one)
    delta.index_add_(0, hi.clamp(0, n_r).to(torch.int64), -one)
    unmatched = ~(torch.cumsum(delta[:n_r], 0) > 0)
    if valid_right is not None:
        unmatched = unmatched & valid_right
    *cu, cnt_u = filter(unmatched, *rks, *rvs_l)
    cks, crvs = cu[:len(rks)], cu[len(rks):]
    # a slot per appended row; rows past cnt_u or capacity go to a dump
    # slot at index capacity, cut off below (the reference's mode="drop")
    r = torch.arange(n_r, device=dev)
    slot = count.to(torch.int64) + r
    slot = torch.where((r < cnt_u) & (slot < capacity), slot, capacity)

    def _put(o, c):
        buf = torch.cat([_signed(o), _signed(o).new_zeros((1,))])
        buf[slot] = _signed(c)
        return buf[:capacity].view(o.dtype)

    out_ks = [_put(ok, ck) for ok, ck in zip(out_ks, cks)]
    # left values of appended rows are 0: the expansion's tail
    orv_l = [_put(o, c) for o, c in zip(orv_l, crvs)]
    total = count + cnt_u
    return (out_ks, out_lv, orv_l if multi_rv else orv_l[0],
            total.clamp(max=capacity), overflow | (total > capacity))


def hash_join(left_keys, left_values, right_keys, right_values, *, capacity: int,
              how: str = "inner"):
    """Equi-join. Returns ``(keys, left_vals, right_vals, count, overflow)``:
    rows [0, count) are the result, ordered by left row then right sorted
    position. ``overflow`` is True if the result exceeds ``capacity`` (the
    tensors then hold the first ``capacity`` rows).

    ``how``:
      - ``"inner"``: all (left, right) matching pairs;
      - ``"left"``: matching pairs plus one row per unmatched left row with
        ``right_vals`` 0;
      - ``"right"``: the mirror, rows ordered by right row then left sorted
        position (evaluated with the sides swapped);
      - ``"full"``: the left-join rows followed by one row per unmatched
        right row (``left_vals`` 0) in right sorted order;
      - ``"semi"`` / ``"anti"``: each left row with at least one / with no
        match, once, in left order (``right_vals`` all 0);
      - ``"lookup"``: each matched left row once, paired with its first
        match in right sorted order -- the inner join of a key-unique right
        side without the expansion. With duplicate right keys it runs the
        exact inner join instead; ``overflow`` reports only a capacity
        excess.

    Composite keys: lists of equal-length columns for both sides (matching
    dtypes per column); the returned ``keys`` is then a list. Payloads may
    independently be lists of columns; the matching output is then a list.
    """
    if how not in JOIN_HOWS and how != "lookup":
        raise ValueError(f"how must be one of {JOIN_HOWS} or 'lookup', got {how!r}")
    if how == "right":
        jk, j_rv, j_lv, cnt, ovf = hash_join(right_keys, right_values, left_keys,
                                             left_values, capacity=capacity, how="left")
        return jk, j_lv, j_rv, cnt, ovf
    multi = isinstance(left_keys, (list, tuple))
    if multi != isinstance(right_keys, (list, tuple)):
        raise ValueError("left and right keys must both be single columns "
                         "or both be column lists")
    l_cols = list(left_keys) if multi else [left_keys]
    r_cols = list(right_keys) if multi else [right_keys]
    if multi and (not l_cols or len(l_cols) != len(r_cols) or any(
            a.dtype != b.dtype for a, b in zip(l_cols, r_cols))):
        raise ValueError("left and right key columns must be non-empty and "
                         "match in count and dtypes")
    n_l = l_cols[0].shape[0]
    n_r = r_cols[0].shape[0]
    multi_lv = isinstance(left_values, (list, tuple))
    lv_cols = list(left_values) if multi_lv else [left_values]
    multi_rv = isinstance(right_values, (list, tuple))
    rv_cols = list(right_values) if multi_rv else [right_values]
    for cols, n, what in ((l_cols, n_l, "left key columns must have equal length"),
                          (r_cols, n_r, "right key columns must have equal length"),
                          (lv_cols, n_l, "left keys/values length mismatch"),
                          (rv_cols, n_r, "right keys/values length mismatch")):
        if any(c.shape[0] != n for c in cols):
            raise ValueError(what)
    dev = l_cols[0].device
    lv_dt = [c.dtype for c in lv_cols]
    rv_dt = [c.dtype for c in rv_cols]
    lv_cols = [_signed(c) for c in lv_cols]
    rv_cols = [_signed(c) for c in rv_cols]

    def _result(key_cols, lvs, rvs, count, overflow):
        lvs = [v.view(dt) for v, dt in zip(lvs, lv_dt)]
        rvs = [v.view(dt) for v, dt in zip(rvs, rv_dt)]
        return (key_cols if multi else key_cols[0], lvs if multi_lv else lvs[0],
                rvs if multi_rv else rvs[0], count, overflow)

    def _zeros(cols, fill=0):
        return [torch.full((capacity,), fill, dtype=c.dtype, device=c.device) for c in cols]

    if n_l == 0 or (n_r == 0 and how == "inner"):
        if how == "full" and n_r > 0:
            # degenerate full outer join: every right row is unmatched
            rk_limbs, rspecs = _cols_to_limbs(r_cols)
            out = _stable_sort([*rk_limbs, *rv_cols], num_keys=len(rk_limbs))
            rks, rvs = out[:len(rk_limbs)], out[len(rk_limbs):]
            e = torch.zeros((0,), dtype=torch.int32, device=dev)
            out_ks, out_lv, out_rv, count, overflow = append_unmatched_right(
                _zeros(rks, ZERO_LIMB), _zeros(lv_cols), _zeros(rv_cols),
                _i32(0, dev), torch.tensor(False, device=dev), rks, rvs, e, e,
                capacity=capacity)
            return _result(_limbs_to_cols(out_ks, rspecs), out_lv, out_rv, count, overflow)
        # an empty side is a normal inner-join input: zero matching pairs
        return _result(_zeros(l_cols), _zeros(lv_cols), _zeros(rv_cols), _i32(0, dev),
                       torch.tensor(False, device=dev))
    lk_limbs, specs = _cols_to_limbs(l_cols)
    if n_r == 0:
        # left/semi/anti against an empty right side: no row matches
        lo = hi = torch.zeros((n_l,), dtype=torch.int32, device=dev)
        rvs = [torch.zeros((1,), dtype=c.dtype, device=dev) for c in rv_cols]
    else:
        rk_limbs, _ = _cols_to_limbs(r_cols)
        out = _stable_sort([*rk_limbs, *rv_cols], num_keys=len(rk_limbs))
        rks, rvs = out[:len(rk_limbs)], out[len(rk_limbs):]
        lo, hi = merge_rank_pair(rks, lk_limbs)

    if how == "lookup":
        # Key-unique right side: each left row pairs with its first match,
        # a membership filter plus a gather, no expansion. Duplicate right
        # keys run the exact inner join instead. The reference decides on
        # the device (lax.cond); here the host reads the flag -- the one
        # host sync of the join.
        if bool(((hi - lo) > 1).any()):
            kw, olv, orv, cnt, ovf = join_expand(lk_limbs, lv_cols, rvs, lo, hi,
                                                 capacity=capacity, how="inner")
            return _result(_limbs_to_cols(kw, specs), olv, orv, cnt, ovf)
        safe = lo.clamp(0, max(n_r, 1) - 1)
        *comp, cnt = filter(hi > lo, *lk_limbs, *lv_cols, *[rv[safe] for rv in rvs])
        valid = torch.arange(capacity, device=dev) < cnt.clamp(max=capacity)
        nk, nlv = len(lk_limbs), len(lv_cols)
        ks = [_mask(valid, _fit(a, capacity), ZERO_LIMB) for a in comp[:nk]]
        vals = [_mask(valid, _fit(a, capacity)) for a in comp[nk:]]
        return _result(_limbs_to_cols(ks, specs), vals[:nlv], vals[nlv:],
                       cnt.clamp(max=capacity), cnt > capacity)

    out_kw, out_lv, out_rv, count, overflow = join_expand(
        lk_limbs, lv_cols, rvs, lo, hi, capacity=capacity, how=how)
    if how == "full" and n_r > 0:
        out_kw, out_lv, out_rv, count, overflow = append_unmatched_right(
            out_kw, out_lv, out_rv, count, overflow, rks, rvs, lo, hi, capacity=capacity)
    return _result(_limbs_to_cols(out_kw, specs), out_lv, out_rv, count, overflow)


BAND_OPS = ("lt", "le", "gt", "ge", "between")


def _limbs_le(a, b):
    """Row-wise lexicographic ``a <= b`` over parallel big-endian limb lists
    (rank space, so the comparison is the source dtype's total order)."""
    le = a[-1] <= b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        le = (x < y) | ((x == y) & le)
    return le


def _seg_scan(ws, rn0, combine):
    """Inclusive segmented scan of a limb list (Hillis-Steele doubling:
    log2(n) elementwise sweeps): row i gets ``combine`` over its segment's
    rows [start, i]. ``combine(cur, prev)`` maps two limb lists to one.
    ``rn0`` is each row's 0-based offset in its segment; an element ``s``
    back is in the segment iff ``rn0 >= s``, so the zero padding of the
    shifted lists is never kept."""
    n = ws[0].shape[0]
    s = 1
    while s < n:
        prevs = [torch.cat([w.new_zeros((s,)), w[:-s]]) for w in ws]
        inseg = rn0 >= s
        ws = [torch.where(inseg, c, w) for c, w in zip(combine(ws, prevs), ws)]
        s *= 2
    return ws


def _limbs_max(a, b):
    """Row-wise lexicographic max of two limb lists (``b`` on ties)."""
    le = _limbs_le(a, b)
    return [torch.where(le, y, x) for x, y in zip(a, b)]


def band_join(left_band, left_values, right_band, right_values, *, op: str, capacity: int,
              left_equi=None, right_equi=None, how: str = "inner"):
    """Non-equi (band / theta / interval) join.

    Emits the (left, right) row pairs where the optional equality conjunct
    matches and the band predicate holds::

      op="lt":      l.x <  r.y         op="gt":  l.x >  r.y
      op="le":      l.x <= r.y         op="ge":  l.x >= r.y
      op="between": r.lo <= l.x <= r.hi

    ``left_band`` is the left column x; ``right_band`` the right column y
    (for "between" the ``(lo, hi)`` pair). Band columns share one dtype and
    compare in its rank space (floats by total order). ``left_equi`` /
    ``right_equi`` (parallel column lists) add an equality conjunct.

    The right side sorts once by (equi..., band); each left row's matches
    are one range of sorted positions from merge ranks, expanded by
    :func:`join_expand` (kernel K2). "between" bounds the candidate range
    below by a segmented running max of ``hi`` and above by the last
    ``lo <= x`` row, then keeps the rows with ``x <= hi``; ``capacity``
    must cover those candidates (equal to the matches when each equi
    group's intervals do not interleave). When every left row has at most
    one candidate, the candidate is gathered directly, without the
    expansion; the reference chooses between the two on the device
    (``lax.cond``), the port on the host, one sync each.

    ``how``: "inner" / "left" / "semi" / "anti" for the inequality ops;
    "between" is inner only. Returns ``(left_vals, right_vals, count,
    overflow)``; rows [0, count) order by left row then right sorted
    position.
    """
    if op not in BAND_OPS:
        raise ValueError(f"op must be one of {BAND_OPS}, got {op!r}")
    if op == "between":
        if how != "inner":
            raise ValueError(f'op="between" supports how="inner" only, got {how!r} '
                             "(candidate post-filtering makes match counts inexact "
                             "before expansion)")
        if not (isinstance(right_band, (list, tuple)) and len(right_band) == 2):
            raise ValueError('op="between" needs right_band=(lo, hi)')
        band_cols_r = list(right_band)
    else:
        if how not in ("inner", "left", "semi", "anti"):
            raise ValueError(f'band joins support how="inner"/"left"/"semi"/"anti", got {how!r}')
        if isinstance(right_band, (list, tuple)):
            raise ValueError(f'op={op!r} takes a single right band column '
                             '(only "between" takes a (lo, hi) pair)')
        band_cols_r = [right_band]
    for c in band_cols_r:
        if c.dtype != left_band.dtype:
            raise TypeError(f"band columns must share one dtype, got {left_band.dtype} "
                            f"vs {c.dtype}")
    multi_lv = isinstance(left_values, (list, tuple))
    lvs = list(left_values) if multi_lv else [left_values]
    multi_rv = isinstance(right_values, (list, tuple))
    rvs = list(right_values) if multi_rv else [right_values]
    le_cols = list(left_equi) if left_equi is not None else []
    re_cols = list(right_equi) if right_equi is not None else []
    if len(le_cols) != len(re_cols) or any(a.dtype != b.dtype for a, b in zip(le_cols, re_cols)):
        raise ValueError("left_equi and right_equi must match in count and dtypes")
    n_l = left_band.shape[0]
    n_r = band_cols_r[0].shape[0]
    if any(c.shape[0] != n_l for c in (*le_cols, *lvs)):
        raise ValueError("left columns must have equal length")
    if any(c.shape[0] != n_r for c in (*re_cols, *rvs, *band_cols_r)):
        raise ValueError("right columns must have equal length")
    dev = left_band.device
    lv_dt = [c.dtype for c in lvs]
    rv_dt = [c.dtype for c in rvs]
    lvs = [_signed(c) for c in lvs]
    rvs = [_signed(c) for c in rvs]

    def _result(lv_out, rv_out, count, overflow):
        lv_out = [v.view(dt) for v, dt in zip(lv_out, lv_dt)]
        rv_out = [v.view(dt) for v, dt in zip(rv_out, rv_dt)]
        return (lv_out if multi_lv else lv_out[0], rv_out if multi_rv else rv_out[0],
                count, overflow)

    if n_l == 0:
        return _result([torch.zeros((capacity,), dtype=c.dtype, device=dev) for c in lvs],
                       [torch.zeros((capacity,), dtype=c.dtype, device=dev) for c in rvs],
                       _i32(0, dev), torch.tensor(False, device=dev))

    lx = K.encode_limbs(left_band)
    le_limbs = _cols_to_limbs(le_cols)[0]
    if n_r == 0:
        # no right rows: nothing matches (left/anti still emit left rows)
        lo = hi = torch.zeros((n_l,), dtype=torch.int32, device=dev)
        rvs_s, rhi_s = [torch.zeros((1,), dtype=c.dtype, device=dev) for c in rvs], []
    else:
        ry = K.encode_limbs(band_cols_r[0])
        re_limbs = _cols_to_limbs(re_cols)[0]
        nk = len(re_limbs) + len(ry)
        ride = list(rvs)
        if op == "between":
            ride += K.encode_limbs(band_cols_r[1])
        srt = _stable_sort([*re_limbs, *ry, *ride], num_keys=nk)
        rk_s = srt[:nk]
        rvs_s = srt[nk:nk + len(rvs)]
        rhi_s = srt[nk + len(rvs):]
        # each left row's matches are one range of sorted-right positions:
        #   lt: [rank_right(E, x), group_end)   le: [rank_left(E, x), group_end)
        #   gt: [group_start, rank_left(E, x))  ge: [group_start, rank_right(E, x))
        #   between: [rank_left(E, segcummax(hi)), rank_right(E, lo=x))
        side = "left" if op in ("le", "gt") else "right"
        v = merge_rank(rk_s, [*le_limbs, *lx], side=side)
        if op == "between":
            # rows before the group's first running max(hi) >= x cannot
            # match; the running max does not decrease within a group, so
            # (E, segcummax(hi)) is sorted and one merge rank bounds the
            # candidates from below
            pos = torch.arange(n_r, dtype=torch.int32, device=dev)
            rn0 = pos - _run_bounds(_mark_first(rk_s[:len(re_limbs)])) if le_limbs else pos
            cmh = _seg_scan(rhi_s, rn0, _limbs_max)
            g = merge_rank([*rk_s[:len(re_limbs)], *cmh], [*le_limbs, *lx], side="left")
        elif le_limbs:
            g = merge_rank(rk_s[:len(re_limbs)], le_limbs,
                           side="right" if op in ("lt", "le") else "left")
        else:
            g = (torch.full((n_l,), n_r, dtype=torch.int32, device=dev) if op in ("lt", "le")
                 else torch.zeros((n_l,), dtype=torch.int32, device=dev))
        lo, hi = (v, g) if op in ("lt", "le") else (g, v)
        if op == "between":
            # inverted intervals (hi < lo) match nothing but can push the
            # running-max bound past the lo <= x bound: clamp the crossed
            # ranges to empty, so no emit count goes negative
            hi = torch.maximum(hi, lo)

    if op == "between" and rhi_s:
        if bool(((hi - lo) <= 1).all()):
            # at most one candidate per left row: gather it, no expansion
            cand = hi > lo
            safe = lo.clamp(0, n_r - 1)
            rv_g = [rv[safe] for rv in rvs_s]
            keep = cand & _limbs_le(lx, [w[safe] for w in rhi_s])
            *comp, cnt = filter(keep, *lvs, *rv_g)
            valid = torch.arange(capacity, device=dev) < cnt.clamp(max=capacity)
            comp = [_mask(valid, _fit(a, capacity)) for a in comp]
            return _result(comp[:len(lvs)], comp[len(lvs):], cnt.clamp(max=capacity),
                           cnt > capacity)
        kout, lv_out, rv_out, count, overflow = join_expand(
            lx, lvs, rvs_s + rhi_s, lo, hi, capacity=capacity, how=how)
        rv_real, rhi_out = rv_out[:len(rvs)], rv_out[len(rvs):]
        if bool(_limbs_differ(cmh, rhi_s).any()):
            # some candidate may end before x: keep the rows with x <= hi
            valid = torch.arange(capacity, dtype=torch.int32, device=dev) < count
            *comp, count = filter(valid & _limbs_le(kout, rhi_out), *lv_out, *rv_real)
            lv_out, rv_real = comp[:len(lvs)], comp[len(lvs):]
        return _result(lv_out, rv_real, count, overflow)

    _, lv_out, rv_out, count, overflow = join_expand(
        lx, lvs, rvs_s + rhi_s, lo, hi, capacity=capacity, how=how)
    return _result(lv_out, rv_out[:len(rvs)], count, overflow)


def searchsorted(sorted_keys: torch.Tensor, queries: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """``searchsorted`` under the dtype's total order (int32 indices).

    ``sorted_keys`` must be ascending under the total order (the output of
    :func:`radix_sort_tpu_torch.sort`); NaNs and mixed-sign zeros rank
    exactly as the sort places them (IEEE total_cmp).
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if sorted_keys.dtype != queries.dtype:
        raise ValueError("sorted_keys and queries must share a dtype")
    if queries.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=queries.device)
    return merge_rank(K.encode(sorted_keys), K.encode(queries), side=side)


def unique(keys):
    """Distinct keys with multiplicities (DISTINCT / GROUP BY COUNT(*)).

    Returns ``(unique_keys, counts, num_unique)``: rows [0, num_unique) hold
    each distinct key once, ascending under the dtype's total order, with
    its occurrence count; the tail holds the remaining rows (the repeated
    keys, in order) with count 0. ``keys`` may be a list of equal-length
    columns (composite DISTINCT); ``unique_keys`` is then a list.
    """
    multi = isinstance(keys, (list, tuple))
    cols = list(keys) if multi else [keys]
    if not cols:
        raise ValueError("keys must have at least one column")
    n = cols[0].shape[0]
    dev = cols[0].device
    if any(c.shape[0] != n for c in cols):
        raise ValueError("all key columns must have equal length")
    if n == 0:
        return keys, torch.zeros((0,), dtype=torch.int32, device=dev), _i32(0, dev)
    limbs, specs = _cols_to_limbs(cols)
    sk = _stable_sort(limbs, num_keys=len(limbs))
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       _limbs_differ([w[1:] for w in sk], [w[:-1] for w in sk])])
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    *out_keys, start, num = filter(first, *_limbs_to_cols(sk, specs), pos)
    # counts[i] = next group's start - this group's start (the last ends at n)
    nxt = torch.where(pos == num - 1, n, torch.cat([start[1:], start[:1]]))
    counts = torch.where(pos < num, nxt - start, 0)
    return (out_keys if multi else out_keys[0]), counts, num
