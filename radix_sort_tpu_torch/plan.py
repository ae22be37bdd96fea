"""Lazy logical plans over Table / DistTable: build, optimize, execute.

Counterpart of ``radix_sort_tpu/plan.py``: the same plan nodes, optimizer
passes, ``explain()`` text and execution, over the port's ``Table``.

``table.lazy()`` returns a :class:`LazyTable` exposing the same relational
verbs as :class:`~radix_sort_tpu_torch.table.Table`, but recording a logical
plan instead of executing. ``collect()`` optimizes the plan and runs it
against the underlying facade (eager ``Table`` or sharded ``DistTable`` —
the plan is backend-agnostic; per-backend capacity knobs ride each verb's
``**kwargs`` untouched).

The optimizer targets THIS engine's cost model, which is not the
row-count model classical planners assume. Shapes are static: a filter
compacts rows but never shrinks an array, so "filter early" buys nothing
by itself. What costs is (a) the NUMBER of variadic-sort passes (every
relational verb is one or more stable sorts — filter, sort_by, group-by,
join, window all sort) and (b) the WIDTH each sort carries (every live
column rides every sort as an operand; measured sort cost grows with
operand words). The passes therefore:

  - **fuse filters** — adjacent predicates AND into one compaction sort;
  - **fuse sorts** — ``sort_by(a).sort_by(b)`` is one stable composite
    sort by ``(b, a)`` (two full passes become one);
  - **fuse windows** — same ``(partition_by, order_by)`` specs share one
    window plan (= two stable sorts however many specs ride it);
  - **sort+limit → top_k** — ``ORDER BY k LIMIT n`` becomes one
    ``top_k`` selection + k-row gathers instead of a full variadic
    sort carrying every column (ops/sort.py:top_k);
  - **push filters down** through select/drop/rename/with_columns/sort
    (legal because filtering is an order-preserving compaction and sorts
    are stable) so filters meet and fuse;
  - **prune columns** — the width lever: only columns the result needs
    flow through each sort/exchange, dead ``with_columns`` and window
    specs disappear, and join sides carry only referenced payloads.

Predicates and derived columns use the :mod:`radix_sort_tpu_torch.expr` AST
(``col``/``lit``) so the optimizer can see their column reads; raw arrays
and callables are accepted too and degrade conservatively (no pushdown /
no pruning through them).

The reference crate is sort-only (src/radix_sort/mod.rs); a logical
planner belongs to the north-star query-engine surface (BASELINE.json).
"""

from __future__ import annotations

import dataclasses
import inspect
from dataclasses import dataclass
from typing import Any

import torch

from radix_sort_tpu_torch.expr import Expr, _binop

__all__ = ["LazyTable"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _refs(x):
    """Column names read by a predicate / value spec.

    Returns ``(names, known)``: ``known=False`` means the reads cannot be
    determined (a raw callable) — treat as "reads everything"."""
    if isinstance(x, Expr):
        return set(x.columns), True
    if isinstance(x, str):
        return {x}, True
    if callable(x):
        return set(), False
    return set(), True  # a positional array reads no columns


def _spec_value_refs(spec):
    """Refs of a window/aggregate spec's value operand."""
    if isinstance(spec, str):
        return set(), True
    spec = list(spec)
    if spec[0] in ("ntile", "rolling_count"):
        return set(), True
    return _refs(spec[1])


# --------------------------------------------------------------------------
# plan nodes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _Node:
    def children(self):
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, _Node):
                out.append((f.name, v))
        return out

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Source(_Node):
    table: Any  # Table or DistTable

    label = "source"


@dataclass(frozen=True)
class Select(_Node):
    child: _Node
    names: tuple

    label = "select"


@dataclass(frozen=True)
class Drop(_Node):
    child: _Node
    names: tuple

    label = "drop"


@dataclass(frozen=True)
class Rename(_Node):
    child: _Node
    mapping: tuple  # ((old, new), ...)

    label = "rename"


@dataclass(frozen=True)
class WithColumns(_Node):
    child: _Node
    exprs: tuple  # ((name, Expr|array|callable), ...)

    label = "with_columns"


@dataclass(frozen=True)
class Filter(_Node):
    child: _Node
    pred: Any  # Expr | bool array | callable

    label = "filter"


@dataclass(frozen=True)
class SortBy(_Node):
    child: _Node
    by: tuple  # str | Expr | array entries
    descending: tuple  # bools, same length
    nulls_last: tuple = ()  # bool | None per key; () = all default

    label = "sort_by"


@dataclass(frozen=True)
class Distinct(_Node):
    child: _Node
    subset: tuple | None
    kwargs: tuple = ()

    label = "distinct"


@dataclass(frozen=True)
class Aggregate(_Node):
    child: _Node
    by: tuple  # column names
    aggs: tuple  # ((out_name, (agg, value|None, *params)), ...)
    kwargs: tuple = ()

    label = "aggregate"


@dataclass(frozen=True)
class AggregateSets(_Node):
    """SQL GROUPING SETS / ROLLUP / CUBE: one aggregate per grouping
    set, concatenated with rolled-up keys as typed NULLs (see
    ``Table.aggregate_sets``)."""

    child: _Node
    sets: tuple  # tuple of tuples of key names
    aggs: tuple  # ((out_name, (agg, value|None, *params)), ...)
    grouping: tuple = ()  # ((out_name, key_name), ...)
    kwargs: tuple = ()

    label = "aggregate_sets"


@dataclass(frozen=True)
class Window(_Node):
    child: _Node
    ops: tuple  # ((out_name, spec), ...)
    partition_by: tuple
    order_by: tuple
    kwargs: tuple = ()

    label = "window"


@dataclass(frozen=True)
class Join(_Node):
    left: _Node
    right: _Node
    on: tuple
    how: str
    suffix: str
    kwargs: tuple = ()

    label = "join"


@dataclass(frozen=True)
class JoinBand(_Node):
    """Non-equi join: optional equality keys ``on`` plus one band
    predicate ``left[left_on] op right[right_on]`` (op in lt/le/gt/ge,
    or "between" with right_on = (lo, hi)). See ``Table.join_band``."""

    left: _Node
    right: _Node
    left_on: str
    op: str
    right_on: tuple  # (col,) or (lo, hi) for between
    on: tuple = ()
    how: str = "inner"
    suffix: str = "_r"
    kwargs: tuple = ()

    label = "join_band"


@dataclass(frozen=True)
class CrossJoin(_Node):
    left: _Node
    right: _Node
    suffix: str = "_r"
    kwargs: tuple = ()

    label = "cross_join"


@dataclass(frozen=True)
class JoinAsof(_Node):
    left: _Node
    right: _Node
    on: str
    direction: str
    tolerance: Any
    suffix: str
    matched_col: str | None
    kwargs: tuple = ()

    label = "join_asof"


@dataclass(frozen=True)
class SetOp(_Node):
    left: _Node
    right: _Node
    which: str  # union | intersect | difference
    subset: tuple | None
    kwargs: tuple = ()

    @property
    def label(self):
        return self.which


@dataclass(frozen=True)
class TopK(_Node):
    child: _Node
    k: int
    by: tuple
    largest: bool

    label = "top_k"


@dataclass(frozen=True)
class Limit(_Node):
    child: _Node
    k: int
    offset: int = 0

    label = "limit"


@dataclass(frozen=True)
class Concat(_Node):
    left: _Node
    right: _Node

    label = "concat"


@dataclass(frozen=True)
class Unnest(_Node):
    child: _Node
    counts: Any  # column name | Expr | array
    kwargs: tuple = ()

    label = "unnest"


# --------------------------------------------------------------------------
# schema propagation
# --------------------------------------------------------------------------


def _schema(node, memo=None):
    """Ordered output column names of a plan node."""
    if memo is None:
        memo = {}
    got = memo.get(id(node))
    if got is not None:
        return got
    out = _schema_of(node, memo)
    memo[id(node)] = out
    return out


def _right_out_names(left_schema, on, right_schema, suffix):
    """Output name of each right non-key column under Table.join's
    collision rule (left columns are all present when naming happens)."""
    taken = set(left_schema)
    return {
        rn: (rn + suffix if rn in taken else rn)
        for rn in right_schema
        if rn not in on
    }


def _schema_of(node, memo):
    if isinstance(node, Source):
        return list(node.table.column_names)
    if isinstance(node, Select):
        return list(node.names)
    if isinstance(node, Drop):
        return [n for n in _schema(node.child, memo) if n not in node.names]
    if isinstance(node, Rename):
        m = dict(node.mapping)
        return [m.get(n, n) for n in _schema(node.child, memo)]
    if isinstance(node, WithColumns):
        out = list(_schema(node.child, memo))
        for n, _ in node.exprs:
            if n not in out:
                out.append(n)
        return out
    if isinstance(node, (Filter, SortBy, Limit, Unnest)):
        return list(_schema(node.child, memo))
    if isinstance(node, TopK):
        return list(_schema(node.child, memo))
    if isinstance(node, Distinct):
        return (list(node.subset) if node.subset
                else list(_schema(node.child, memo)))
    if isinstance(node, Aggregate):
        return list(node.by) + [n for n, _ in node.aggs]
    if isinstance(node, AggregateSets):
        all_keys = list(dict.fromkeys(k for s in node.sets for k in s))
        return (all_keys + [n for n, _ in node.aggs]
                + [n for n, _ in node.grouping])
    if isinstance(node, Window):
        out = list(_schema(node.child, memo))
        for n, _ in node.ops:
            if n not in out:
                out.append(n)
        return out
    if isinstance(node, Join):
        ls = _schema(node.left, memo)
        out = list(node.on) + [n for n in ls if n not in node.on]
        if node.how in ("inner", "left", "right", "full"):
            rmap = _right_out_names(
                out, set(node.on), _schema(node.right, memo), node.suffix
            )
            out += list(rmap.values())
        return out
    if isinstance(node, JoinBand):
        ls = _schema(node.left, memo)
        on = set(node.on)
        out = list(node.on) + [n for n in ls if n not in on]
        if node.how in ("inner", "left"):
            rmap = _right_out_names(
                out, on, _schema(node.right, memo), node.suffix
            )
            out += list(rmap.values())
        return out
    if isinstance(node, CrossJoin):
        ls = _schema(node.left, memo)
        out = list(ls)
        rmap = _right_out_names(
            ls, set(), _schema(node.right, memo), node.suffix
        )
        return out + list(rmap.values())
    if isinstance(node, JoinAsof):
        ls = _schema(node.left, memo)
        out = list(ls)
        rmap = _right_out_names(
            ls, {node.on}, _schema(node.right, memo), node.suffix
        )
        out += list(rmap.values())
        if node.matched_col is not None:
            out.append(node.matched_col)
        return out
    if isinstance(node, SetOp):
        return (list(node.subset) if node.subset
                else list(_schema(node.left, memo)))
    if isinstance(node, Concat):
        return list(_schema(node.left, memo))
    raise AssertionError(f"unknown node {type(node).__name__}")


# --------------------------------------------------------------------------
# optimizer passes
# --------------------------------------------------------------------------


def _map_children(node, fn):
    kw = {name: fn(child) for name, child in node.children()}
    return node.replace(**kw) if kw else node


def _push_filters(node):
    """Sink Filter nodes through width/order-preserving verbs so they can
    meet (and fuse) and sit as low as possible."""
    node = _map_children(node, _push_filters)
    if not isinstance(node, Filter):
        return node
    child, pred = node.child, node.pred
    refs, known = _refs(pred)
    is_expr = isinstance(pred, Expr)
    is_array = not is_expr and not callable(pred)
    if isinstance(child, Select) and (is_expr or is_array):
        return child.replace(
            child=_push_filters(Filter(child.child, pred))
        )
    if isinstance(child, Drop) and (is_expr or is_array):
        return child.replace(
            child=_push_filters(Filter(child.child, pred))
        )
    if isinstance(child, Rename) and (is_expr or is_array):
        if is_expr:
            inv = {new: old for old, new in child.mapping}
            pred = pred.rename(inv)
        return child.replace(
            child=_push_filters(Filter(child.child, pred))
        )
    if isinstance(child, SortBy) and is_expr:
        # stable sort + order-preserving compaction commute
        return child.replace(
            child=_push_filters(Filter(child.child, pred))
        )
    if isinstance(child, WithColumns) and (is_expr or is_array):
        new_names = {n for n, _ in child.exprs}
        if known and not (refs & new_names):
            return child.replace(
                child=_push_filters(Filter(child.child, pred))
            )
    if isinstance(child, Concat) and is_expr and known:
        # filtering a concatenation == concatenating the filtered sides
        return child.replace(
            left=_push_filters(Filter(child.left, pred)),
            right=_push_filters(Filter(child.right, pred)),
        )
    if isinstance(child, Window) and is_expr and known and refs:
        # a predicate over partition keys only keeps or drops WHOLE
        # partitions, and every window op is partition-scoped — filtering
        # first computes the same values over fewer rows (sort operands
        # shrink). Must not touch window outputs or order columns.
        out_names = {n for n, _ in child.ops}
        if refs <= set(child.partition_by) and not (refs & out_names):
            return child.replace(
                child=_push_filters(Filter(child.child, pred))
            )
    if isinstance(child, Join) and is_expr and known and refs:
        # a predicate reading only one side's columns commutes with the
        # join and filters that side's INPUT — fewer rows reach the
        # capacity-bounded join (strictly less overflow pressure, same
        # result). Left-side pushes are sound when left rows survive
        # unconditionally or by match only (inner/left/semi/anti — never
        # right/full, whose unmatched right rows zero-fill left columns);
        # right-side pushes mirror (inner/right). Join keys carry both
        # sides' values on matched rows, so for inner joins a keys-only
        # predicate pushes into BOTH inputs.
        on = set(child.on)
        ls = _schema(child.left)
        left_names = set(ls) | on
        lout = list(child.on) + [n for n in ls if n not in on]
        rmap = _right_out_names(
            lout, on, _schema(child.right), child.suffix
        )  # right-column name -> output name
        right_out = {out: rn for rn, out in rmap.items()}
        if child.how == "inner" and refs <= on:
            return child.replace(
                left=_push_filters(Filter(child.left, pred)),
                right=_push_filters(Filter(child.right, pred)),
            )
        if (refs <= left_names
                and child.how in ("inner", "left", "semi", "anti")):
            return child.replace(
                left=_push_filters(Filter(child.left, pred))
            )
        if (refs <= (set(right_out) | on)
                and child.how in ("inner", "right")):
            ren = dict(right_out)
            return child.replace(
                right=_push_filters(Filter(child.right, pred.rename(ren)))
            )
    return node


# aggregations that survive the eager-aggregation rewrite. The group's
# right-match multiplicity m is CONSTANT within a group (the group keys
# contain the join keys), so replacing the expanded join rows by one row
# per left match scales sum/count by m and leaves the rest unchanged —
# including median: the lower order statistic of each value repeated m
# times, rank (n*m-1)//2, is element ((n-1)//2) for every m >= 1.
_EAGER_SCALED = ("sum", "count")
_EAGER_INVARIANT = ("mean", "min", "max", "any", "all", "var", "std",
                    "median", "mode", "count_distinct", "first", "last")


def _scale_by(out_name, m_name):
    def scale(t, _o=out_name, _m=m_name):
        from radix_sort_tpu_torch.nulls import MaskedColumn

        o = t[_o]
        v = _binop("mul", o, False, t[_m].to(o.dtype), False, o.device)[0]
        mk = t.null_mask(_o)
        return v if mk is None else MaskedColumn(v, mk)

    return scale


def _eager_join_aggregate(node):
    """``aggregate(join(L, R, on, inner), by ⊇ on, L-only aggs)`` →
    ``aggregate(lookup_join(L, aggregate(R, by=on, count)), by, aggs)``
    with sum/count post-scaled by the right-match multiplicity — eager
    aggregation (Yan & Larson). The pre-aggregated right side is
    key-unique by construction, so the join runs as a ``lookup`` (a
    membership test + one rank gather — semi-join cost) and the whole
    expansion machinery with its capacity-sized output gathers
    disappears, yet the result is exact for ANY right-side fanout. On
    DistTable plans the pre-aggregated right side is a REPLICATED
    Table, so the lookup runs as a broadcast join — this relation is
    never exchanged at all (one distributed aggregate of the right side
    replaces the co-partitioned shuffle of both)."""
    node = _map_children(node, _eager_join_aggregate)
    if not isinstance(node, Aggregate):
        return node
    if any(k == "where" for k, _ in node.kwargs):
        # a fused WHERE evaluates against the join output and may read
        # right-side columns — leave the plan as is
        return node
    mid, j = None, node.child
    if isinstance(j, WithColumns):
        mid, j = j, j.child
    if not isinstance(j, Join) or j.how != "inner":
        return node
    on = set(j.on)
    if not on or not all(isinstance(b, str) for b in node.by) \
            or not on <= set(node.by):
        return node
    ls = _schema(j.left)
    lout = list(j.on) + [n for n in ls if n not in on]
    rmap = _right_out_names(lout, on, _schema(j.right), j.suffix)
    right_outs = set(rmap.values())
    m_in, m_out = "__eja_m", "__eja_mg"
    taken = set(lout) | right_outs | {n for n, _ in node.aggs}
    if mid is not None:
        for _, e in mid.exprs:
            refs, known = _refs(e)
            if not known or refs & right_outs:
                return node
        right_outs = right_outs - {n for n, _ in mid.exprs}  # shadowed
        taken |= {n for n, _ in mid.exprs}
    if {m_in, m_out} & taken:
        return node
    if set(node.by) & right_outs:
        return node
    for _, spec in node.aggs:
        agg = spec[0]
        val = spec[1] if len(spec) > 1 else None
        if agg not in _EAGER_SCALED and agg not in _EAGER_INVARIANT:
            return node
        if val is None:
            continue
        if isinstance(val, str):
            if val in right_outs:
                return node
        elif isinstance(val, Expr):
            refs, known = _refs(val)
            if not known or refs & right_outs:
                return node
        else:
            # positional arrays / callables are row-aligned to the
            # ORIGINAL expanded join output — cannot re-align
            return node
    # the right-side count aggregate inherits the aggregate's capacity
    # knobs (a DistTable right child needs max_groups; if the bound is
    # too small for the right side's distinct keys, the distributed
    # aggregate's exact fallback covers it; Table.aggregate drops them)
    r_agg = Aggregate(
        j.right, tuple(j.on), ((m_in, ("count", None)),),
        tuple((k, v) for k, v in node.kwargs
              if k in ("max_groups", "exchange_capacity_factor")),
    )
    new_join = Join(
        j.left, r_agg, j.on, "lookup", j.suffix,
        # the pre-aggregated right side is key-unique by construction:
        # assume_unique lets the DistTable broadcast lookup skip its
        # eager duplicate-key check (which costs a host sync)
        tuple((k, v) for k, v in j.kwargs if k != "capacity")
        + (("assume_unique", True),),
    )
    child = new_join if mid is None else mid.replace(child=new_join)
    agg2 = node.replace(
        child=child, aggs=tuple(node.aggs) + ((m_out, ("max", m_in)),)
    )
    scale = tuple(
        (out_name, _scale_by(out_name, m_out))
        for out_name, spec in node.aggs if spec[0] in _EAGER_SCALED
    )
    out = WithColumns(agg2, scale) if scale else agg2
    return Select(out, tuple([*node.by, *(n for n, _ in node.aggs)]))


def _fuse_filter_aggregate(node):
    """WHERE + GROUP BY fusion: the aggregate's key sort already demotes
    excluded rows through its leading validity flag word, so a Filter
    sitting under an Aggregate/AggregateSets (possibly through the
    with_columns that hoist computed group keys / expression aggregate
    arguments) becomes the aggregate's ``where=`` — one sort instead of
    a separate n-row compaction pass."""
    node = _map_children(node, _fuse_filter_aggregate)
    if not isinstance(node, (Aggregate, AggregateSets)):
        return node
    if any(k == "where" for k, _ in node.kwargs):
        return node
    mids, cur = [], node.child
    while isinstance(cur, WithColumns):
        mids.append(cur)
        cur = cur.child
    if not isinstance(cur, Filter):
        return node
    pred = cur.pred
    if callable(pred) and not isinstance(pred, Expr):
        # an opaque callable must see exactly the table it was written
        # against — only safe with nothing interposed
        if mids:
            return node
    elif isinstance(pred, Expr):
        # the predicate re-evaluates above the with_columns: its reads
        # must not be shadowed by (or depend on) the hoisted columns
        new_names = {n for m in mids for n, _ in m.exprs}
        refs, known = _refs(pred)
        if not known or refs & new_names:
            return node
    # positional array predicates are row-aligned either way
    child = cur.child
    for m in reversed(mids):
        child = m.replace(child=child)
    return node.replace(
        child=child, kwargs=tuple(node.kwargs) + (("where", pred),)
    )


def _fuse_filters(node):
    node = _map_children(node, _fuse_filters)
    if (isinstance(node, Filter) and isinstance(node.child, Filter)
            and isinstance(node.pred, Expr)):
        inner = node.child
        if isinstance(inner.pred, Expr):
            return _fuse_filters(
                Filter(inner.child, inner.pred & node.pred)
            )
    return node


def _fuse_sorts(node):
    node = _map_children(node, _fuse_sorts)
    if isinstance(node, SortBy) and isinstance(node.child, SortBy):
        outer, inner = node, node.child
        # outer keys must be row-wise (name/Expr) to move below the inner
        # sort; positional arrays are pinned to the inner sort's order
        if all(isinstance(b, (str, Expr)) for b in outer.by):
            onl = list(outer.nulls_last) or [None] * len(outer.by)
            inl = list(inner.nulls_last) or [None] * len(inner.by)
            by, desc, nlast, seen = [], [], [], set()
            for b, d, nl in zip(
                list(outer.by) + list(inner.by),
                list(outer.descending) + list(inner.descending),
                onl + inl,
            ):
                if isinstance(b, str):
                    if b in seen:
                        continue  # already tied on this column
                    seen.add(b)
                by.append(b)
                desc.append(d)
                nlast.append(nl)
            return _fuse_sorts(SortBy(
                inner.child, tuple(by), tuple(desc),
                tuple(nlast) if any(x is not None for x in nlast)
                else (),
            ))
    return node


def _fuse_windows(node):
    node = _map_children(node, _fuse_windows)
    if isinstance(node, Window) and isinstance(node.child, Window):
        outer, inner = node, node.child
        same_keys = (
            outer.partition_by == inner.partition_by
            and outer.order_by == inner.order_by
            and outer.kwargs == inner.kwargs
        )
        inner_outs = {n for n, _ in inner.ops}
        outer_outs = {n for n, _ in outer.ops}
        indep = not (inner_outs & outer_outs)
        keys_clear = not (
            (set(outer.partition_by) | set(outer.order_by)) & inner_outs
        )
        for _, spec in outer.ops:
            r, known = _spec_value_refs(spec)
            if not known or (r & inner_outs):
                indep = False
                break
        if same_keys and indep and keys_clear:
            return _fuse_windows(
                inner.replace(ops=inner.ops + outer.ops)
            )
    return node


def _sort_limit_to_topk(node):
    node = _map_children(node, _sort_limit_to_topk)
    if isinstance(node, Limit) and isinstance(node.child, SortBy):
        s = node.child
        descs = set(s.descending)
        if len(descs) == 1 and all(
            isinstance(b, str) for b in s.by
        ) and not any(x is not None for x in s.nulls_last):
            top = TopK(s.child, node.k + node.offset, s.by,
                       largest=descs.pop())
            # top_k emits rows in key order, so OFFSET is a head slice of it
            return top if node.offset == 0 else node.replace(child=top)
    return node


def _prune(node, required, memo):
    """Rewrite the subtree so it produces (at least) ``required`` columns,
    dropping dead columns / specs below. ``required`` ⊆ schema(node)."""
    schema = _schema(node, memo)
    req = [n for n in schema if n in required]  # keep schema order

    if isinstance(node, Source):
        if list(node.table.column_names) != req:
            return Select(node, tuple(req))
        return node

    if isinstance(node, Select):
        child_req = set(req)
        return Select(
            _prune(node.child, child_req, memo), tuple(req)
        )

    if isinstance(node, Drop):
        # express as a Select of what survives — narrower below
        return Select(
            _prune(node.child, set(req), memo), tuple(req)
        )

    if isinstance(node, Rename):
        inv = {new: old for old, new in node.mapping}
        child_req = {inv.get(n, n) for n in req}
        keep_map = tuple(
            (old, new) for old, new in node.mapping if old in child_req
        )
        return Rename(
            _prune(node.child, child_req, memo), keep_map
        )

    if isinstance(node, WithColumns):
        keep, child_req, opaque = [], set(req), False
        for n, e in node.exprs:
            if n in required:
                keep.append((n, e))
                r, known = _refs(e)
                if not known:
                    opaque = True
                child_req |= r
        child_req -= {n for n, _ in keep}
        # a kept column may also pass through from below (overwrite):
        # only ask the child for names it actually has
        cs = set(_schema(node.child, memo))
        child_req = (child_req & cs) if not opaque else cs
        child = _prune(node.child, child_req, memo)
        if not keep:
            return child
        return WithColumns(child, tuple(keep))

    if isinstance(node, Filter):
        r, known = _refs(node.pred)
        cs = _schema(node.child, memo)
        child_req = set(cs) if not known else (set(req) | (r & set(cs)))
        return Filter(_prune(node.child, child_req, memo), node.pred)

    if isinstance(node, SortBy):
        child_req = set(req)
        for b in node.by:
            r, known = _refs(b)
            if not known:
                child_req = set(_schema(node.child, memo))
                break
            child_req |= r
        return node.replace(child=_prune(node.child, child_req, memo))

    if isinstance(node, Distinct):
        subset = (node.subset if node.subset
                  else tuple(_schema(node.child, memo)))
        return node.replace(
            child=_prune(node.child, set(subset), memo), subset=subset
        )

    if isinstance(node, Aggregate):
        keep = [(n, s) for n, s in node.aggs if n in required]
        if not keep and node.aggs:
            keep = [node.aggs[0]]  # a group-by needs >= 1 aggregate
        child_req, opaque = set(node.by), False
        for _, spec in keep:
            agg = spec[0]
            val = spec[1] if len(spec) > 1 else None
            if val is not None:
                r, known = _refs(val)
                child_req |= r
                opaque |= not known
        wpred = dict(node.kwargs).get("where")
        if wpred is not None:
            r, known = _refs(wpred)
            child_req |= r
            opaque |= not known
        if opaque:
            child_req = set(_schema(node.child, memo))
        return node.replace(
            child=_prune(node.child, child_req, memo), aggs=tuple(keep)
        )

    if isinstance(node, AggregateSets):
        # conservative: every grouping-set key and aggregate input stays
        # (the sets jointly reference them; per-set pruning isn't worth
        # the asymmetry)
        child_req = set(k for s in node.sets for k in s)
        opaque = False
        for _, spec in node.aggs:
            val = spec[1] if len(spec) > 1 else None
            if val is not None:
                r, known = _refs(val)
                child_req |= r
                opaque |= not known
        wpred = dict(node.kwargs).get("where")
        if wpred is not None:
            r, known = _refs(wpred)
            child_req |= r
            opaque |= not known
        if opaque:
            child_req = set(_schema(node.child, memo))
        return node.replace(child=_prune(node.child, child_req, memo))

    if isinstance(node, Window):
        keep = [(n, s) for n, s in node.ops if n in required]
        child_req = set(req) - {n for n, _ in keep}
        opaque = False
        for names in (node.partition_by, node.order_by):
            for b in names:
                r, known = _refs(b)
                child_req |= r
                opaque |= not known
        for _, spec in keep:
            r, known = _spec_value_refs(spec)
            child_req |= r
            opaque |= not known
        cs = set(_schema(node.child, memo))
        child_req = cs if opaque else (child_req & cs)
        child = _prune(node.child, child_req, memo)
        if not keep:
            return child
        return node.replace(child=child, ops=tuple(keep))

    if isinstance(node, Join):
        on = set(node.on)
        ls = _schema(node.left, memo)
        rs = _schema(node.right, memo)
        left_others = [n for n in ls if n not in on]
        left_req = on | {n for n in left_others if n in required}
        if node.how in ("inner", "left", "right", "full"):
            lout = list(node.on) + left_others
            rmap = _right_out_names(lout, on, rs, node.suffix)
            kept_right = {rn for rn, out in rmap.items() if out in required}
            # keep any left column whose presence decides a kept right
            # column's output name (suffix collision must not change)
            left_req |= {rn for rn in kept_right if rn in left_others}
            right_req = on | kept_right
        else:
            right_req = on
        return node.replace(
            left=_prune(node.left, left_req, memo),
            right=_prune(node.right, right_req, memo),
        )

    if isinstance(node, (JoinBand, CrossJoin)):
        # band/cross joins: every band/equi column is load-bearing; the
        # right side additionally keeps required outputs (no pushdowns)
        band = isinstance(node, JoinBand)
        on = set(node.on) if band else set()
        ls = _schema(node.left, memo)
        rs = _schema(node.right, memo)
        left_others = [n for n in ls if n not in on]
        left_req = on | {n for n in left_others if n in required}
        if band:
            left_req.add(node.left_on)
        right_req = on | (set(node.right_on) if band else set())
        if (not band) or node.how in ("inner", "left"):
            lout = list(on) + left_others
            rmap = _right_out_names(lout, on, rs, node.suffix)
            kept_right = {rn for rn, out in rmap.items() if out in required}
            left_req |= {rn for rn in kept_right if rn in left_others}
            right_req |= kept_right
        # a cross join with one-sided projections can prune a side to
        # nothing — keep one column (a relation needs at least one)
        if not left_req:
            left_req = {ls[0]}
        if not right_req:
            right_req = {rs[0]}
        return node.replace(
            left=_prune(node.left, left_req, memo),
            right=_prune(node.right, right_req, memo),
        )

    if isinstance(node, JoinAsof):
        ls = _schema(node.left, memo)
        rs = _schema(node.right, memo)
        left_req = {node.on} | (set(ls) & required)
        rmap = _right_out_names(ls, {node.on}, rs, node.suffix)
        kept_right = {rn for rn, out in rmap.items() if out in required}
        left_req |= {rn for rn in kept_right if rn in ls}
        right_req = {node.on} | kept_right
        return node.replace(
            left=_prune(node.left, left_req, memo),
            right=_prune(node.right, right_req, memo),
        )

    if isinstance(node, SetOp):
        subset = (node.subset if node.subset
                  else tuple(_schema(node.left, memo)))
        return node.replace(
            left=_prune(node.left, set(subset), memo),
            right=_prune(node.right, set(subset), memo),
            subset=subset,
        )

    if isinstance(node, TopK):
        child_req = set(req) | {b for b in node.by if isinstance(b, str)}
        return node.replace(child=_prune(node.child, child_req, memo))

    if isinstance(node, Limit):
        return node.replace(child=_prune(node.child, set(req), memo))

    if isinstance(node, Concat):
        return node.replace(
            left=_prune(node.left, set(req), memo),
            right=_prune(node.right, set(req), memo),
        )

    if isinstance(node, Unnest):
        r, known = _refs(node.counts)
        cs = _schema(node.child, memo)
        child_req = set(cs) if not known else (set(req) | (r & set(cs)))
        return node.replace(child=_prune(node.child, child_req, memo))

    raise AssertionError(f"unknown node {type(node).__name__}")


def optimize(node):
    """All passes, in dependency order."""
    node = _push_filters(node)
    node = _fuse_filters(node)
    node = _eager_join_aggregate(node)
    node = _fuse_filter_aggregate(node)
    node = _fuse_sorts(node)
    node = _fuse_windows(node)
    node = _sort_limit_to_topk(node)
    memo = {}
    node = _prune(node, set(_schema(node, memo)), memo)
    return node


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------


def _value(x, table, dicts=False):
    """Materialize a value spec against the current table. A nullable
    expression comes back as a ``nulls.MaskedColumn`` so the facade can
    keep its mask (with_columns / aggregate values / window values).
    With ``dicts=True`` (the with_columns path) a string-valued
    expression comes back as a ``strings.DictColumn`` so the facade can
    attach its output dictionary."""
    if (isinstance(x, Expr) or callable(x)) and hasattr(table, "per_slot"):
        # a DistTable evaluates expressions and callables slot by slot
        return table.per_slot(lambda view: _value(x, view, dicts))
    if isinstance(x, Expr):
        if dicts:
            sr = x.string_result(table)
            if sr is not None:
                from radix_sort_tpu_torch import strings as S

                return S.DictColumn(*sr)
        v, m = x.evaluate_masked(table)
        if m is not None:
            from radix_sort_tpu_torch.nulls import MaskedColumn

            return MaskedColumn(v, m)
        return v
    if callable(x):
        return x(table)
    return x


def _sort_key(b, table):
    return b if isinstance(b, str) else _value(b, table)


def _fit_kwargs(method, kwargs):
    """Keep only the kwargs ``method`` accepts.

    Capacity knobs ride plan nodes backend-agnostically (``max_groups``,
    ``capacity_per_shard``, ...), but the executing facade differs —
    single-chip ``Table.aggregate`` has no ``max_groups`` while
    ``DistTable.aggregate`` requires it. Filtering against the bound
    method's signature lets one plan (e.g. from ``sql()``) run on either
    backend without a TypeError at collect()."""
    if not kwargs:
        return kwargs
    try:
        params = inspect.signature(method).parameters
    except (TypeError, ValueError):  # builtins / C callables: pass through
        return kwargs
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in params.values()):
        return kwargs
    return {k: v for k, v in kwargs.items() if k in params}


def _exec(node, flags):
    if isinstance(node, Source):
        return node.table
    if isinstance(node, Select):
        return _exec(node.child, flags).select(*node.names)
    if isinstance(node, Drop):
        return _exec(node.child, flags).drop(*node.names)
    if isinstance(node, Rename):
        return _exec(node.child, flags).rename(dict(node.mapping))
    if isinstance(node, WithColumns):
        t = _exec(node.child, flags)
        return t.with_columns(
            **{n: _value(e, t, dicts=True) for n, e in node.exprs}
        )
    if isinstance(node, Filter):
        t = _exec(node.child, flags)
        p = node.pred
        if isinstance(p, Expr):
            def pred(tb, _p=p):
                # SQL WHERE: keep rows where the predicate is known TRUE
                v, m = _p.evaluate_masked(tb)
                return v if m is None else (v & ~m)
            return t.filter(pred)
        return t.filter(p)
    if isinstance(node, SortBy):
        t = _exec(node.child, flags)
        kw = {}
        if any(x is not None for x in node.nulls_last):
            kw["nulls_last"] = list(node.nulls_last)
        return t.sort_by(
            [_sort_key(b, t) for b in node.by],
            descending=list(node.descending), **kw,
        )
    if isinstance(node, Distinct):
        t = _exec(node.child, flags)
        return t.distinct(list(node.subset) if node.subset else None,
                          **_fit_kwargs(t.distinct, dict(node.kwargs)))
    if isinstance(node, Aggregate):
        t = _exec(node.child, flags)
        aggs = {}
        for name, spec in node.aggs:
            agg, val, rest = spec[0], (spec[1] if len(spec) > 1 else None), \
                spec[2:]
            if val is None:
                aggs[name] = agg
            else:
                aggs[name] = (agg, _materialize_col(val, t), *rest)
        return t.aggregate(list(node.by), aggs,
                           **_fit_kwargs(t.aggregate, dict(node.kwargs)))
    if isinstance(node, AggregateSets):
        t = _exec(node.child, flags)
        aggs = {}
        for name, spec in node.aggs:
            agg, val, rest = spec[0], (spec[1] if len(spec) > 1 else None), \
                spec[2:]
            if val is None:
                aggs[name] = agg
            else:
                aggs[name] = (agg, _materialize_col(val, t), *rest)
        return t.aggregate_sets(
            [list(s) for s in node.sets], aggs,
            grouping=dict(node.grouping) or None,
            **_fit_kwargs(t.aggregate_sets, dict(node.kwargs)),
        )
    if isinstance(node, Window):
        t = _exec(node.child, flags)
        ops = {}
        for name, spec in node.ops:
            if isinstance(spec, str):
                ops[name] = spec
            else:
                spec = list(spec)
                if spec[0] not in ("ntile", "rolling_count"):
                    spec[1] = _materialize_col(spec[1], t)
                ops[name] = tuple(spec)
        return t.window(
            ops,
            partition_by=list(node.partition_by) or None,
            order_by=list(node.order_by) or None,
            **_fit_kwargs(t.window, dict(node.kwargs)),
        )
    if isinstance(node, Join):
        lt = _exec(node.left, flags)
        rt = _exec(node.right, flags)
        out, ovf = lt.join(rt, list(node.on), how=node.how,
                           suffix=node.suffix,
                           **_fit_kwargs(lt.join, dict(node.kwargs)))
        flags.append(ovf)
        return out
    if isinstance(node, JoinBand):
        lt = _exec(node.left, flags)
        rt = _exec(node.right, flags)
        if not hasattr(lt, "join_band"):
            raise TypeError(
                "band joins are single-chip in this release — execute on "
                "Table inputs (DistTable: .to_table() first)"
            )
        ro = (tuple(node.right_on) if node.op == "between"
              else node.right_on[0])
        out, ovf = lt.join_band(
            rt, node.left_on, node.op, ro, on=list(node.on),
            how=node.how, suffix=node.suffix,
            **_fit_kwargs(lt.join_band, dict(node.kwargs)))
        flags.append(ovf)
        return out
    if isinstance(node, CrossJoin):
        lt = _exec(node.left, flags)
        rt = _exec(node.right, flags)
        if not hasattr(lt, "cross_join"):
            raise TypeError(
                "cross joins are single-chip in this release — execute on "
                "Table inputs (DistTable: .to_table() first)"
            )
        out, ovf = lt.cross_join(
            rt, suffix=node.suffix,
            **_fit_kwargs(lt.cross_join, dict(node.kwargs)))
        flags.append(ovf)
        return out
    if isinstance(node, JoinAsof):
        lt = _exec(node.left, flags)
        rt = _exec(node.right, flags)
        return lt.join_asof(
            rt, node.on, direction=node.direction,
            tolerance=node.tolerance, suffix=node.suffix,
            matched_col=node.matched_col,
            **_fit_kwargs(lt.join_asof, dict(node.kwargs)),
        )
    if isinstance(node, SetOp):
        lt = _exec(node.left, flags)
        rt = _exec(node.right, flags)
        fn = getattr(lt, node.which)
        return fn(rt, list(node.subset) if node.subset else None,
                  **_fit_kwargs(fn, dict(node.kwargs)))
    if isinstance(node, TopK):
        t = _exec(node.child, flags)
        return t.top_k(node.k, [_sort_key(b, t) for b in node.by],
                       largest=node.largest)
    if isinstance(node, Limit):
        return _exec(node.child, flags).limit(node.k, node.offset)
    if isinstance(node, Concat):
        lt = _exec(node.left, flags)
        return lt.concat(_exec(node.right, flags))
    if isinstance(node, Unnest):
        t = _exec(node.child, flags)
        out, ovf = t.unnest(_materialize_col(node.counts, t),
                            **_fit_kwargs(t.unnest, dict(node.kwargs)))
        flags.append(ovf)
        return out
    raise AssertionError(f"unknown node {type(node).__name__}")


def _materialize_col(x, table):
    """Column-name specs pass through (the facade resolves them); Expr
    and callables evaluate to arrays."""
    if isinstance(x, str):
        return x
    return _value(x, table)


# --------------------------------------------------------------------------
# display
# --------------------------------------------------------------------------


def _fmt_by(by, desc=None):
    parts = []
    for i, b in enumerate(by):
        s = (b if isinstance(b, str)
             else (repr(b) if isinstance(b, Expr) else "<array>"))
        if desc is not None and desc[i]:
            s += " desc"
        parts.append(s)
    return ", ".join(parts)


def _describe(node):
    if isinstance(node, Source):
        t = node.table
        return f"source[{type(t).__name__}: {', '.join(t.column_names)}]"
    if isinstance(node, Select):
        return f"select[{', '.join(node.names)}]"
    if isinstance(node, Drop):
        return f"drop[{', '.join(node.names)}]"
    if isinstance(node, Rename):
        return ("rename["
                + ", ".join(f"{o}->{n}" for o, n in node.mapping) + "]")
    if isinstance(node, WithColumns):
        parts = []
        for n, e in node.exprs:
            v = repr(e) if isinstance(e, Expr) else (
                "<fn>" if callable(e) else "<array>")
            parts.append(f"{n}={v}")
        return f"with_columns[{', '.join(parts)}]"
    if isinstance(node, Filter):
        p = node.pred
        v = repr(p) if isinstance(p, Expr) else (
            "<fn>" if callable(p) else "<array>")
        return f"filter[{v}]"
    if isinstance(node, SortBy):
        return f"sort_by[{_fmt_by(node.by, node.descending)}]"
    if isinstance(node, Distinct):
        return f"distinct[{', '.join(node.subset or ())}]"
    def _fused_where(n):
        return ("; where" if any(k == "where" for k, _ in n.kwargs)
                else "")

    if isinstance(node, Aggregate):
        parts = [f"{n}={s[0]}" for n, s in node.aggs]
        return (f"aggregate[by={', '.join(node.by)}; "
                + ", ".join(parts) + _fused_where(node) + "]")
    if isinstance(node, AggregateSets):
        parts = [f"{n}={s[0]}" for n, s in node.aggs]
        sets = ", ".join("(" + ", ".join(s) + ")" for s in node.sets)
        return (f"aggregate_sets[{sets}; " + ", ".join(parts)
                + _fused_where(node) + "]")
    if isinstance(node, Window):
        parts = [
            f"{n}={s if isinstance(s, str) else s[0]}" for n, s in node.ops
        ]
        return (f"window[{', '.join(parts)}; "
                f"partition={_fmt_by(node.partition_by)}; "
                f"order={_fmt_by(node.order_by)}]")
    if isinstance(node, Join):
        return f"join[{node.how} on {', '.join(node.on)}]"
    if isinstance(node, JoinBand):
        sym = {"lt": "<", "le": "<=", "gt": ">", "ge": ">="}.get(node.op)
        pred = (f"{node.left_on} between {node.right_on[0]} and "
                f"{node.right_on[1]}" if node.op == "between"
                else f"{node.left_on} {sym} {node.right_on[0]}")
        eq = f"{', '.join(node.on)}; " if node.on else ""
        return f"join_band[{node.how} on {eq}{pred}]"
    if isinstance(node, CrossJoin):
        return "cross_join"
    if isinstance(node, JoinAsof):
        return f"join_asof[{node.direction} on {node.on}]"
    if isinstance(node, SetOp):
        return f"{node.which}[{', '.join(node.subset or ())}]"
    if isinstance(node, TopK):
        d = "desc" if node.largest else "asc"
        return f"top_k[{node.k} by {_fmt_by(node.by)} {d}]"
    if isinstance(node, Limit):
        return (f"limit[{node.k}]" if not node.offset
                else f"limit[{node.k} offset {node.offset}]")
    if isinstance(node, Concat):
        return "concat"
    if isinstance(node, Unnest):
        c = node.counts if isinstance(node.counts, str) else "<expr>"
        return f"unnest[{c}]"
    return type(node).__name__


def _render(node, indent=0):
    lines = ["  " * indent + _describe(node)]
    for _, child in node.children():
        lines.extend(_render(child, indent + 1))
    return lines


# --------------------------------------------------------------------------
# the user-facing facade
# --------------------------------------------------------------------------


class LazyTable:
    """A deferred relational pipeline: records a logical plan; optimizes
    and executes on :meth:`collect`. Obtain one with ``Table.lazy()`` /
    ``DistTable.lazy()``. All verbs mirror the eager facades; predicates
    and derived columns may be :class:`~radix_sort_tpu_torch.expr.Expr` trees
    (``rst.col``/``rst.lit``) — preferred, the optimizer can analyze them
    — or raw bool arrays / callables (accepted; optimized around)."""

    def __init__(self, plan: _Node):
        self._plan = plan

    # -- building ----------------------------------------------------------

    @property
    def plan(self) -> _Node:
        return self._plan

    @property
    def column_names(self):
        return _schema(self._plan)

    def _wrap(self, plan):
        return LazyTable(plan)

    @staticmethod
    def _plan_of(other):
        if isinstance(other, LazyTable):
            return other._plan
        return Source(other)  # an eager Table/DistTable side

    def select(self, *names) -> "LazyTable":
        return self._wrap(Select(self._plan, tuple(names)))

    def drop(self, *names) -> "LazyTable":
        return self._wrap(Drop(self._plan, tuple(names)))

    def rename(self, mapping) -> "LazyTable":
        return self._wrap(Rename(self._plan, tuple(mapping.items())))

    def with_columns(self, **named) -> "LazyTable":
        return self._wrap(WithColumns(self._plan, tuple(named.items())))

    def filter(self, pred) -> "LazyTable":
        return self._wrap(Filter(self._plan, pred))

    def sort_by(self, by, descending=False,
                nulls_last=None) -> "LazyTable":
        by = _as_list(by)
        desc = ([descending] * len(by)
                if isinstance(descending, bool) else list(descending))
        if len(desc) != len(by):
            raise ValueError("descending list must match the by list")
        nlast = ()
        if isinstance(nulls_last, bool):
            nlast = (nulls_last,) * len(by)
        elif nulls_last is not None:
            nlast = tuple(nulls_last)
            if len(nlast) != len(by):
                raise ValueError(
                    "nulls_last list must match the by list")
            if all(x is None for x in nlast):
                nlast = ()
        return self._wrap(SortBy(
            self._plan, tuple(by), tuple(bool(d) for d in desc), nlast
        ))

    def distinct(self, subset=None, **kwargs) -> "LazyTable":
        s = tuple(_as_list(subset)) or None
        return self._wrap(
            Distinct(self._plan, s, tuple(kwargs.items()))
        )

    def aggregate(self, by, aggs, **kwargs) -> "LazyTable":
        specs = []
        for name, spec in aggs.items():
            if isinstance(spec, str):
                specs.append((name, (spec, None)))
            else:
                specs.append((name, tuple(spec)))
        return self._wrap(Aggregate(
            self._plan, tuple(_as_list(by)), tuple(specs),
            tuple(kwargs.items()),
        ))

    def aggregate_sets(self, sets, aggs, grouping=None,
                       **kwargs) -> "LazyTable":
        specs = []
        for name, spec in aggs.items():
            if isinstance(spec, str):
                specs.append((name, (spec, None)))
            else:
                specs.append((name, tuple(spec)))
        return self._wrap(AggregateSets(
            self._plan,
            tuple(tuple(_as_list(s)) if s else () for s in sets),
            tuple(specs), tuple((grouping or {}).items()),
            tuple(kwargs.items()),
        ))

    def window(self, ops, *, partition_by=None, order_by=None,
               **kwargs) -> "LazyTable":
        specs = tuple(
            (n, s if isinstance(s, str) else tuple(s))
            for n, s in ops.items()
        )
        return self._wrap(Window(
            self._plan, specs, tuple(_as_list(partition_by)),
            tuple(_as_list(order_by)), tuple(kwargs.items()),
        ))

    def join(self, other, on, *, how="inner", suffix="_r",
             **kwargs) -> "LazyTable":
        return self._wrap(Join(
            self._plan, self._plan_of(other), tuple(_as_list(on)),
            how, suffix, tuple(kwargs.items()),
        ))

    def join_band(self, other, left_on, op, right_on, *, on=None,
                  how="inner", suffix="_r", **kwargs) -> "LazyTable":
        opn = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge"}.get(op, op)
        ro = (tuple(right_on) if isinstance(right_on, (list, tuple))
              else (right_on,))
        return self._wrap(JoinBand(
            self._plan, self._plan_of(other), left_on, opn, ro,
            tuple(_as_list(on)), how, suffix, tuple(kwargs.items()),
        ))

    def cross_join(self, other, *, suffix="_r", **kwargs) -> "LazyTable":
        return self._wrap(CrossJoin(
            self._plan, self._plan_of(other), suffix,
            tuple(kwargs.items()),
        ))

    def join_asof(self, other, on, *, direction="backward",
                  tolerance=None, suffix="_r", matched_col=None,
                  **kwargs) -> "LazyTable":
        return self._wrap(JoinAsof(
            self._plan, self._plan_of(other), on, direction, tolerance,
            suffix, matched_col, tuple(kwargs.items()),
        ))

    def union(self, other, subset=None, **kwargs) -> "LazyTable":
        return self._set_op(other, "union", subset, kwargs)

    def intersect(self, other, subset=None, **kwargs) -> "LazyTable":
        return self._set_op(other, "intersect", subset, kwargs)

    def difference(self, other, subset=None, **kwargs) -> "LazyTable":
        return self._set_op(other, "difference", subset, kwargs)

    def _set_op(self, other, which, subset, kwargs):
        s = tuple(_as_list(subset)) or None
        return self._wrap(SetOp(
            self._plan, self._plan_of(other), which, s,
            tuple(kwargs.items()),
        ))

    def top_k(self, k: int, by, largest: bool = True) -> "LazyTable":
        return self._wrap(
            TopK(self._plan, int(k), tuple(_as_list(by)), bool(largest))
        )

    def limit(self, k: int, offset: int = 0) -> "LazyTable":
        return self._wrap(Limit(self._plan, int(k), int(offset)))

    def concat(self, other) -> "LazyTable":
        return self._wrap(Concat(self._plan, self._plan_of(other)))

    def unnest(self, counts, **kwargs) -> "LazyTable":
        return self._wrap(
            Unnest(self._plan, counts, tuple(kwargs.items()))
        )

    # -- running -------------------------------------------------------------

    def optimized(self) -> "LazyTable":
        """The same pipeline with the optimized plan (for inspection)."""
        return LazyTable(optimize(self._plan))

    def explain(self, optimize_plan: bool = True) -> str:
        """The plan as an indented tree (optimized by default)."""
        plan = optimize(self._plan) if optimize_plan else self._plan
        return "\n".join(_render(plan))

    def collect(self, *, optimize_plan: bool = True,
                return_overflow: bool = False):
        """Optimize + execute. Returns the resulting Table/DistTable; with
        ``return_overflow=True``, returns ``(result, overflow)`` where
        ``overflow`` ORs every capacity-bounded step's flag (joins,
        unnests) — False when the plan has none."""
        plan = optimize(self._plan) if optimize_plan else self._plan
        flags = []
        out = _exec(plan, flags)
        if not return_overflow:
            return out
        ovf = torch.zeros((), dtype=torch.bool,
                          device=getattr(out, "device", None))
        for f in flags:
            ovf = ovf | f
        return out, ovf
