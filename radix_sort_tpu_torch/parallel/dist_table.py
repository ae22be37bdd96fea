"""DistTable: the distributed (MPP) relation facade over the parallel
operators.

Counterpart of ``radix_sort_tpu/parallel/dist_table.py``: the sharded form
of :class:`radix_sort_tpu_torch.Table`. Named columns are
:class:`~.runtime.Sharded` over a mesh's slots, every relational verb
routes to the matching ``parallel/`` operator (splitter-sampled exchanges,
two-phase and shuffle aggregation, carry-chain windows), and the
static-shape convention carries over: each slot owns a valid prefix of its
rows, described by one ``(P,)`` int32 counts tensor on the mesh's home
device. The concatenation of the slots' valid prefixes is the relation, in
a deterministic global order.

Validity enters as a leading key word, as in ``Table``:

  - sorts order by (invalid flag, keys...), so the valid rows form a
    global prefix and each slot's count is read from the sorted flags;
  - GROUP BY, DISTINCT and the set operators key on (invalid flag,
    keys...): padding groups sort after the valid ones and leave the
    count;
  - joins key on per-side flags (left padding 1, right padding 2, right
    NULL keys 4), so padding never matches, and drop the padding rows the
    outer variants emit;
  - windows partition on (invalid flag, partition keys...).

Reduction-shaped verbs (aggregate, distinct, top_k, the set operators,
limit) return a single-device :class:`~radix_sort_tpu_torch.Table` on the
home device: their results are group-sized, the gathered combine's result.
Row-shaped verbs (filter, sort_by, the joins, window, unnest, concat)
return a DistTable.

String columns keep ``uint32`` codes in the sharded blocks and one sorted
host vocabulary per column, replicated in every process; date columns are
int32 days or int64 microseconds. NULLs are hidden bool mask columns, as in
``Table``: outer joins mark the cells of unmatched rows NULL, masks ride
every row-moving verb, expressions see them, and aggregates skip them as
``Table.aggregate`` does. Nullable columns cannot be join, grouping, set,
DISTINCT or window keys here. Expressions and callables (``with_columns``, ``filter``, ``where=``, sort
keys and value columns) are evaluated slot by slot against a view of each
slot's block.
"""

from __future__ import annotations

import numpy as np
import torch

from radix_sort_tpu_torch import dates as DT
from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch import nulls as NL
from radix_sort_tpu_torch import strings as S
from radix_sort_tpu_torch.ops import query as Q
from radix_sort_tpu_torch.ops import relational as R
from radix_sort_tpu_torch.parallel import collectives as C
from radix_sort_tpu_torch.parallel import dist_asof, dist_query, dist_sort
from radix_sort_tpu_torch.parallel import dist_window as DW
from radix_sort_tpu_torch.parallel.runtime import Sharded, gather_rows, shard_rows, valid_rows
from radix_sort_tpu_torch.table import (
    Table,
    _NUMERIC_ONLY_AGGS,
    _VALUE_PRESERVING_WINDOW,
    _as_list,
    _np,
    _remap,
    _tensor,
)

__all__ = ["DistTable"]


class _SlotView:
    """One slot's block of every column, for expressions and callables:
    ``view[name]`` is the slot's block (a tensor on its device)."""

    def __init__(self, table, j):
        self._t, self._j = table, j

    def __getitem__(self, name):
        return self._t._cols[name].blocks[self._j]

    @property
    def device(self):
        return self._t._mesh.devices[self._j]

    def null_mask(self, name):
        m = self._t.null_mask(name)
        return None if m is None else m.blocks[self._j]

    def is_string(self, name):
        return name in self._t._dicts

    def dictionary(self, name):
        return self._t._dicts[name]


def _smap(fn, *cols):
    """A Sharded column from ``fn`` applied to each local slot's blocks."""
    mesh = cols[0].mesh
    return Sharded(mesh, [fn(*bs) for bs in zip(*(c.blocks for c in cols))])


def _remap_sharded(table_np, codes):
    return _smap(lambda b: _remap(table_np, b), codes)


def _payload(cols, dicts, src, names, arrays, present=None, suffix=None):
    """Name one side's joined payload columns (``names`` of table ``src``,
    mask columns among them) into ``cols``, with ``suffix`` on a collision
    with a column already there. ``present`` (an int8 Sharded column, 0 on
    the rows where this side had no match) makes those cells NULL."""
    out_of = {}
    for name in names:
        if not NL.is_mask_name(name):
            out_of[name] = (name + suffix if suffix is not None and name in cols else name)
    got = dict(zip(names, arrays))
    for name, out in out_of.items():
        cols[out] = got[name]
        if name in src._dicts:
            dicts[out] = src._dicts[name]
        m = got.get(NL.mask_name(name))
        if present is not None:
            absent = _smap(lambda p: p == 0, present)
            m = absent if m is None else _smap(torch.logical_or, m, absent)
        if m is not None:
            cols[NL.mask_name(out)] = m


class DistTable:
    """An immutable row-sharded relation over ``mesh``: equal-length named
    columns (a global length divisible by the slot count) plus per-slot
    valid-row counts (``None`` = every row valid). Slot d holds the rows
    ``[d * rows_per_shard, (d + 1) * rows_per_shard)`` and its valid rows
    are that block's first ``counts[d]``.

    Columns may be :class:`~.runtime.Sharded` columns on ``mesh``, global
    tensors, numpy arrays (strings become dictionary codes, ``datetime64``
    int32 days / int64 microseconds, ``np.ma`` a NULL mask) or lists;
    every process passes the same global data."""

    def __init__(self, columns, mesh, counts=None, dictionaries=None):
        cols = dict(columns)
        if not cols:
            raise ValueError("a DistTable needs at least one column")
        dicts = dict(dictionaries) if dictionaries else {}
        P = mesh.size
        n = None
        masks = {}
        for name, c in list(cols.items()):
            if isinstance(c, S.DictColumn):
                dicts[name], masks[name], c = c.vocab, c.mask, c.codes
            elif isinstance(c, NL.MaskedColumn):
                masks[name], c = c.mask, c.values
            elif not isinstance(c, Sharded) and NL.detect(c) is not None:
                c, masks[name] = NL.detect(c)  # np.ma / None-bearing host data
            if not isinstance(c, Sharded):
                if name not in dicts and S.is_string_data(c):
                    c, dicts[name] = S.encode(c)
                elif DT.is_datetime_data(c):
                    c, _ = DT.encode_datetime64(c)
                c = _tensor(c, mesh.home)
                if c.ndim != 1:
                    raise ValueError(f"column {name!r} must be 1-D, got {tuple(c.shape)}")
                if c.shape[0] % P:
                    raise ValueError(f"row count {c.shape[0]} must divide the mesh size ({P})")
                c = shard_rows(mesh, c)
            elif c.mesh.owners != mesh.owners or c.mesh.rank != mesh.rank:
                raise ValueError(f"column {name!r} lies on another mesh")
            if n is None:
                n = c.shape[0]
            elif c.shape[0] != n:
                raise ValueError(f"column {name!r} has length {c.shape[0]}, expected {n}")
            cols[name] = c
        for name, m in masks.items():
            if m is None:
                continue
            if not isinstance(m, Sharded):
                m = shard_rows(mesh, _tensor(m, mesh.home).to(torch.bool))
            cols[NL.mask_name(name)] = m
            # the engine invariant: values are 0 wherever the mask is True
            cols[name] = _smap(lambda v, mb: Q._mask(~mb, Q._signed(v)).view(v.dtype),
                               cols[name], m)
        self._cols = cols
        self._n = n
        self._mesh = mesh
        self._P = P
        self._nl = n // P
        if counts is not None:
            counts = torch.as_tensor(counts).to(mesh.home, torch.int32)
            if tuple(counts.shape) != (P,):
                raise ValueError(f"counts must have shape ({P},), got {tuple(counts.shape)}")
        self._counts = counts
        self._dicts = {k: v for k, v in dicts.items() if k in cols}

    def _new(self, cols, counts, dicts):
        return DistTable(cols, self._mesh, counts, dictionaries=dicts)

    def _as_dist(self, other):
        """A single-device Table operand (an aggregate's result, say) as a
        DistTable on this mesh, its rows zero-padded to a multiple of the
        slot count."""
        if isinstance(other, DistTable):
            return other
        n = other.num_rows
        pad = -n % self._P
        if pad:
            cols = {c: C.cat([x, torch.zeros((pad,), dtype=x.dtype, device=other.device)])
                    for c, x in other._cols.items()}  # NULL masks included
            other = Table(cols, n if other.count is None else other.count,
                          dictionaries=other._dicts, device=other.device)
        return DistTable.from_table(other, self._mesh)

    # ---- construction ---------------------------------------------------

    @classmethod
    def from_table(cls, table: Table, mesh) -> "DistTable":
        """Shard a single-device :class:`Table` row-wise over ``mesh`` (the
        table's rows keep their global positions; its valid prefix becomes
        per-slot prefix counts)."""
        n = table.num_rows
        P = mesh.size
        if n % P:
            raise ValueError(f"row count {n} must divide the mesh size ({P})")
        cols = {name: shard_rows(mesh, Q._signed(c).to(mesh.home).view(c.dtype))
                for name, c in table._cols.items()}
        counts = None
        if table.count is not None:
            nl = n // P
            starts = torch.arange(P, dtype=torch.int32, device=mesh.home) * nl
            counts = (table.count.to(mesh.home) - starts).clamp(0, nl)
        return cls(cols, mesh, counts, dictionaries=table._dicts)

    # ---- introspection --------------------------------------------------

    @property
    def num_rows(self) -> int:
        """Row capacity over every slot (valid rows and padding)."""
        return self._n

    @property
    def rows_per_shard(self) -> int:
        return self._nl

    @property
    def mesh(self):
        return self._mesh

    @property
    def counts(self):
        """Per-slot valid-row counts: a (P,) int32 tensor on the home
        device, or None when every row is valid."""
        return self._counts

    @property
    def column_names(self):
        return [n for n in self._cols if not NL.is_mask_name(n)]

    def null_mask(self, name):
        """The column's Sharded bool null mask (True = NULL), or None."""
        return self._cols.get(NL.mask_name(name))

    @property
    def nullable_columns(self):
        return [n for n in self.column_names if self.null_mask(n) is not None]

    def _no_nulls(self, names, what):
        for n in _as_list(names):
            if isinstance(n, str) and self.null_mask(n) is not None:
                raise TypeError(f"{what} over the nullable column {n!r} is not supported on a "
                                "DistTable; fill or filter its NULLs first")

    def __getitem__(self, name: str) -> Sharded:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __repr__(self):
        cnt = "all" if self._counts is None else "counted"
        return (f"DistTable({self._P} slots x {self._nl} rows [{cnt} valid], "
                f"columns={self.column_names})")

    def total_count(self):
        """Total valid rows: a 0-dim int32 tensor on the home device."""
        if self._counts is None:
            return torch.tensor(self._n, dtype=torch.int32, device=self._mesh.home)
        return self._counts.sum(dtype=torch.int32)

    def _slot_counts(self):
        """Each local slot's valid count as a 0-dim tensor on its device."""
        return [self._counts[s].to(dev) for s, dev in zip(self._mesh.local, self._mesh.devices)]

    def valid_mask(self) -> Sharded:
        """Bool mask of each slot's valid prefix."""
        mesh = self._mesh
        if self._counts is None:
            return Sharded(mesh, [torch.ones((self._nl,), dtype=torch.bool, device=dev)
                                  for dev in mesh.devices])
        return Sharded(mesh, [torch.arange(self._nl, dtype=torch.int32, device=dev) < c
                              for c, dev in zip(self._slot_counts(), mesh.devices)])

    def _flag(self):
        """Leading validity key word (int32: 0 valid, 1 invalid), or None
        when the whole table is valid."""
        if self._counts is None:
            return None
        return _smap(lambda m: (~m).to(torch.int32), self.valid_mask())

    def _zeros(self, dtype=torch.int32):
        return Sharded(self._mesh, [torch.zeros((self._nl,), dtype=dtype, device=dev)
                                    for dev in self._mesh.devices])

    def _positions(self):
        """Each row's global position (int64), sharded."""
        return Sharded(self._mesh, [s * self._nl + torch.arange(self._nl, device=dev)
                                    for s, dev in zip(self._mesh.local, self._mesh.devices)])

    def _compacted(self):
        """The valid rows dealt evenly over the slots in their global order
        (one exchange of the valid rows by their global rank): padding is
        then at most P-1 rows, on the last slots. The relation is the
        same."""
        if self._counts is None:
            return self
        cnts = self._counts.tolist()
        total, P = sum(cnts), self._P
        nl = max(1, -(-total // P))
        offs = [sum(cnts[:s]) for s in range(P)]
        names = list(self._cols)
        pos, cols = [], []
        for j, (s, dev) in enumerate(zip(self._mesh.local, self._mesh.devices)):
            pos.append(offs[s] + torch.arange(cnts[s], device=dev))
            cols.append([self._cols[n].blocks[j][:cnts[s]] for n in names])
        home = dist_sort._route_home(self._mesh, pos, cols, nl)
        counts = [min(nl, max(0, total - d * nl)) for d in range(P)]
        return self._new({n: Sharded(self._mesh, [h[k] for h in home])
                          for k, n in enumerate(names)}, counts, self._dicts)

    def _spread(self, keys):
        """Key columns with each padding row's key replaced by its global
        position."""
        if self._counts is None:
            return keys
        valid, pos = self.valid_mask(), self._positions()
        return [_smap(lambda k, v, p: torch.where(v, Q._signed(k), p.to(Q._signed(k).dtype))
                      .view(k.dtype), k, valid, pos) for k in keys]

    def _ones(self):
        return Sharded(self._mesh, [torch.ones((self._nl,), dtype=torch.int8, device=dev)
                                    for dev in self._mesh.devices])

    # ---- values ---------------------------------------------------------

    def per_slot(self, fn):
        """Evaluate ``fn(view)`` on each local slot's view (``view[name]`` is
        the slot's block) and assemble the results into one column: a
        Sharded column, or a :class:`~radix_sort_tpu_torch.strings.DictColumn`
        of Sharded codes for a string-valued result. Scalars broadcast."""
        outs = [fn(_SlotView(self, j)) for j in range(len(self._mesh.local))]
        vocab, masks = None, None
        if isinstance(outs[0], S.DictColumn):
            vocab = outs[0].vocab
            masks = [o.mask for o in outs]
            outs = [o.codes for o in outs]
        elif isinstance(outs[0], NL.MaskedColumn):
            masks = [o.mask for o in outs]
            outs = [o.values for o in outs]

        def assemble(xs):
            blocks = []
            for o, dev in zip(xs, self._mesh.devices):
                o = _tensor(o, dev)
                if o.ndim == 0:
                    o = Q._signed(o).expand(self._nl).clone().view(o.dtype)
                if o.shape[0] != self._nl:
                    raise ValueError(f"a per-slot value has {o.shape[0]} rows, "
                                     f"expected {self._nl}")
                blocks.append(o)
            return Sharded(self._mesh, blocks)

        col = assemble(outs)
        mask = None if masks is None or masks[0] is None else _smap(
            lambda b: b.to(torch.bool), assemble(masks))
        if vocab is not None:
            return S.DictColumn(col, vocab, mask)
        return col if mask is None else NL.MaskedColumn(col, mask)

    def _value(self, x, dicts=False):
        """A column reference as a Sharded column: a name, a Sharded column,
        an :class:`~radix_sort_tpu_torch.expr.Expr` or callable (evaluated
        per slot), or global data (sharded). ``dicts=True`` keeps a
        string-valued result as a DictColumn of Sharded codes."""
        from radix_sort_tpu_torch.expr import Expr

        if isinstance(x, str):
            return self._cols[x]
        if isinstance(x, Sharded):
            return x
        if isinstance(x, Expr):
            def ev(view):
                if dicts:
                    sr = x.string_result(view)
                    if sr is not None:
                        return S.DictColumn(*sr)
                v, m = x.evaluate_masked(view)
                return v if m is None else NL.MaskedColumn(v, m)
            out = self.per_slot(ev)
        elif callable(x) and not torch.is_tensor(x):
            out = self.per_slot(x)
        elif isinstance(x, (S.DictColumn, NL.MaskedColumn)):
            return x if dicts else self._value(x.codes if isinstance(x, S.DictColumn)
                                               else x.values)
        else:
            if S.is_string_data(x):
                codes, vocab = S.encode(x)
                col = shard_rows(self._mesh, _tensor(codes, self._mesh.home))
                return S.DictColumn(col, vocab) if dicts else col
            t = _tensor(x, self._mesh.home)
            if t.ndim == 0:
                return self.per_slot(lambda view: t)
            return shard_rows(self._mesh, t)
        if not dicts and isinstance(out, S.DictColumn):
            return out.codes
        if not dicts and isinstance(out, NL.MaskedColumn):
            return out.values
        return out

    def _resolve(self, cols):
        return [self._value(c) for c in _as_list(cols)]

    # ---- string columns (uint32 codes sharded, one host vocabulary) ------

    def is_string(self, name: str) -> bool:
        return name in self._dicts

    def dictionary(self, name: str) -> np.ndarray:
        return self._dicts[name]

    def code(self, name: str, value):
        """The uint32 code(s) of string value(s) under ``name``'s dictionary
        (absent values get a code equal to no real code), on the home
        device."""
        codes = np.atleast_1d(np.asarray(S.lookup(self._dicts[name], value), np.uint32))
        t = _tensor(codes, self._mesh.home)
        return t[0] if isinstance(value, (str, bytes)) else t

    def decode(self, name: str, codes=None) -> np.ndarray:
        if codes is None:
            codes = gather_rows(self._cols[name])
        return S.decode(_np(codes) if torch.is_tensor(codes) else np.asarray(codes),
                        self._dicts[name])

    def _subdicts(self, names):
        return {n: self._dicts[n] for n in names if n in self._dicts}

    def _no_string(self, col, what: str):
        if isinstance(col, str) and col in self._dicts:
            raise TypeError(f"{what} is arithmetic over values and is undefined on string "
                            f"column {col!r} (dictionary codes)")

    def _unify_key(self, other, name, lc, rc, key_dicts):
        """Remap one string key pair into the unified code space (``rc`` a
        Sharded column or, for a replicated right side, a tensor); records
        the union vocabulary in ``key_dicts``."""
        if isinstance(name, str) and ((name in self._dicts) != (name in other._dicts)):
            raise TypeError(f"key {name!r} is a string column on one side only")
        if isinstance(name, str) and name in self._dicts:
            union, ra, rb = S.unify(self._dicts[name], other._dicts[name])
            lc = _remap_sharded(ra, lc)
            rc = _remap_sharded(rb, rc) if isinstance(rc, Sharded) else _remap(rb, rc)
            key_dicts[name] = union
        return lc, rc

    def _counts_from_flags(self, flag_col):
        """Per-slot valid counts after a (flag, ...) sort: the rows whose
        flag is 0 (the exchange padding carries the sentinel flag)."""
        return C.all_gather(self._mesh, [(b == 0).sum(dtype=torch.int32).reshape(1)
                                         for b in flag_col.blocks])

    # ---- projection -----------------------------------------------------

    def select(self, *names) -> "DistTable":
        cols = {}
        for n in names:
            cols[n] = self._cols[n]
            if NL.mask_name(n) in self._cols:
                cols[NL.mask_name(n)] = self._cols[NL.mask_name(n)]
        return self._new(cols, self._counts, self._subdicts(names))

    def drop(self, *names) -> "DistTable":
        gone = set(names)
        keep = {n: c for n, c in self._cols.items()
                if (NL.base_name(n) if NL.is_mask_name(n) else n) not in gone}
        return self._new(keep, self._counts, self._subdicts(keep))

    def rename(self, mapping) -> "DistTable":
        def new(n):
            if NL.is_mask_name(n):
                return NL.mask_name(mapping.get(NL.base_name(n), NL.base_name(n)))
            return mapping.get(n, n)

        return self._new({new(n): c for n, c in self._cols.items()}, self._counts,
                         {mapping.get(n, n): d for n, d in self._dicts.items()})

    def with_columns(self, **named) -> "DistTable":
        """Add or replace columns: Sharded columns, global tensors or numpy
        arrays (host strings encode), scalars (broadcast), callables taking
        a slot view, or :class:`~radix_sort_tpu_torch.expr.Expr` trees
        (evaluated per slot; string-valued ones keep their dictionary). A
        nullable result raises: a DistTable holds no null masks."""
        cols, dicts = dict(self._cols), dict(self._dicts)
        for n, c in named.items():
            c = self._value(c, dicts=True)
            m = None
            if isinstance(c, S.DictColumn):
                dicts[n], c, m = c.vocab, c.codes, c.mask
            else:
                dicts.pop(n, None)
                if isinstance(c, NL.MaskedColumn):
                    c, m = c.values, c.mask
            if c.shape[0] != self._n:
                raise ValueError(f"column {n!r} has length {c.shape[0]}, expected {self._n}")
            cols.pop(NL.mask_name(n), None)
            cols[n] = c if m is None else NL.MaskedColumn(c, m)
        return self._new(cols, self._counts, dicts)

    # ---- row-shaped verbs (stay sharded) -------------------------------------

    def _eval_pred(self, mask):
        """A WHERE predicate (bool column, Expr, or callable taking a slot
        view) -> a Sharded bool mask; a nullable predicate keeps only the
        rows where it is known TRUE."""
        from radix_sort_tpu_torch.expr import Expr

        if isinstance(mask, Expr):
            def ev(view):
                v, m = mask.evaluate_masked(view)
                return v if m is None else (v & ~m)
            return self.per_slot(ev)
        return _smap(lambda b: b.to(torch.bool), self._value(mask))

    def _merged_flag(self, where=None):
        """The leading validity flag word with an optional WHERE predicate
        folded in (nonzero = excluded row), or None."""
        flag = self._flag()
        if where is None:
            return flag
        w = _smap(lambda b: (~b).to(torch.int32), self._eval_pred(where))
        return w if flag is None else _smap(torch.bitwise_or, flag, w)

    def filter(self, mask) -> "DistTable":
        """Rows where ``mask`` holds (a bool column, an Expr, or a callable
        taking a slot view), compacted to each slot's front in slot order:
        the filtered relation in its original order."""
        mask = self._eval_pred(mask)
        if self._counts is not None:
            mask = _smap(torch.logical_and, mask, self.valid_mask())
        *out, counts = dist_query.distributed_filter(mask, *self._cols.values(),
                                                     mesh=self._mesh)
        return self._new(dict(zip(self._cols, out)), counts.to(torch.int32), self._dicts)

    def _flag_sorted(self, limbs):
        """One distributed stable sort of every column by the signed limb
        columns ``limbs``, the validity flag leading when present."""
        flag = self._flag()
        key_limbs = ([flag] if flag is not None else []) + list(limbs)
        if not key_limbs:
            key_limbs = [self._zeros()]
        ows, ovs, fill_counts, _ = dist_sort.distributed_sort_limbs(
            key_limbs, list(self._cols.values()), mesh=self._mesh)
        counts = self._counts_from_flags(ows[0]) if flag is not None else fill_counts
        return self._new(dict(zip(self._cols, ovs)), counts, self._dicts)

    def sort_by(self, by, descending=False, nulls_last=None) -> "DistTable":
        """Globally stable sort of the valid rows by one or more columns over
        the composite-splitter exchange (balanced for any distribution);
        every other column rides the one sort. The row capacity grows to
        the exchange bound; the valid rows form a global prefix.
        ``descending`` is a bool or a per-column list; NULL keys sort as
        +infinity unless ``nulls_last`` says otherwise, as in
        :meth:`Table.sort_by`."""
        by = _as_list(by)
        desc = [descending] * len(by) if isinstance(descending, bool) else list(descending)
        if len(desc) != len(by):
            raise ValueError("descending list must match the by list")
        nlast = ([nulls_last] * len(by) if nulls_last is None or isinstance(nulls_last, bool)
                 else list(nulls_last))
        limbs = []
        for ref, c, d, nl_ in zip(by, self._resolve(by), desc, nlast):
            m = self.null_mask(ref) if isinstance(ref, str) else None
            if m is not None:
                last = (not d) if nl_ is None else bool(nl_)
                limbs.append(_smap(lambda b, _l=last: b.to(torch.int32) if _l
                                   else ~b.to(torch.int32), m))
            per = [K.encode_limbs(b) for b in c.blocks]
            for k in range(len(per[0])):
                limbs.append(Sharded(self._mesh, [~p[k] if d else p[k] for p in per]))
        return self._flag_sorted(limbs)

    def join(self, other: "DistTable", on, *, capacity_per_shard: int | None = None,
             how: str = "inner", suffix: str = "_r", exchange_capacity_factor: float = 2.0,
             assume_unique: bool = False):
        """Equi-join with ``other`` on the shared ``on`` column(s): the
        co-partitioned MPP join (both sides routed on one shared splitter
        sketch, a local join per slot whose expansion is kernel K2).
        Returns ``(DistTable, overflow)`` with :meth:`Table.join`'s column
        conventions (suffix on collision; the other side's cells of an
        unmatched row are 0 and NULL; semi/anti emit left columns only).

        ``how="lookup"`` is the broadcast lookup join: ``other`` is a
        single-device :class:`Table` with key-unique rows (an aggregate
        keyed by the join key, say); each slot probes it in place, and this
        relation is never exchanged. A right side that is not key-unique
        raises TypeError, unless ``assume_unique`` (the planner's
        eager-aggregation rewrite builds a key-unique side) skips that
        check and its host sync; the returned flag then reports it."""
        if how == "lookup":
            return self._join_lookup(other, on, suffix=suffix, assume_unique=assume_unique)
        if how not in Q.JOIN_HOWS:
            raise ValueError(f"how must be one of {Q.JOIN_HOWS}, got {how!r}")
        if capacity_per_shard is None:
            if how in ("semi", "anti"):
                # at most one row per exchanged left row
                capacity_per_shard = int(exchange_capacity_factor * self.rows_per_shard)
            else:
                raise TypeError(f"join(how={how!r}) needs an explicit capacity_per_shard= (the "
                                "static per-slot result bound); only semi/anti joins have a "
                                "natural default")
        on = _as_list(on)
        other = self._as_dist(other)
        self._no_nulls(on, "a join key")
        other._no_nulls(on, "a join key")
        # a side that is mostly padding (a join's or a filter's output) is
        # compacted first, so the exchange moves its valid rows only
        self, other = (t._compacted() if t._counts is not None
                       and 2 * int(t._counts.sum()) < t._n else t for t in (self, other))
        lk, rk, key_dicts = [], [], {}
        for name, lc, rc in zip(on, self._resolve(on), other._resolve(on)):
            lc, rc = self._unify_key(other, name, lc, rc, key_dicts)
            lk.append(lc)
            rk.append(rc)
        lflag, rflag = self._flag(), other._flag()
        flagged = lflag is not None or rflag is not None
        if flagged:
            lf = lflag if lflag is not None else self._zeros()
            rf = _smap(lambda b: b * 2, rflag) if rflag is not None else other._zeros()
            # padding rows never match, so their keys are free: each takes its
            # position, and the routing hash spreads them over the slots
            # (equal keys would all route to one slot and overflow it)
            lk, rk = [lf, *self._spread(lk)], [rf, *other._spread(rk)]
        l_other = [n for n in self._cols if n not in on]
        r_other = [n for n in other._cols if n not in on]
        # unmatched sides are zero-filled, so the data columns ride the
        # exchange directly; a column of ones on each side marks the rows
        # that had a match there (its cells of unmatched rows are NULL)
        lv = [self._cols[n] for n in l_other] + [self._ones()]
        rv = [other._cols[n] for n in r_other] + [other._ones()]
        jk, jl, jr, counts, ovf = dist_query.distributed_hash_join(
            lk, lv, rk, rv, self._mesh, capacity_per_shard=capacity_per_shard,
            exchange_capacity_factor=exchange_capacity_factor, how=how)
        jks, jls, jrs = list(jk), list(jl), list(jr)
        cols, dicts = {}, dict(key_dicts)
        if flagged:
            fcol, jks = jks[0], jks[1:]
        cols.update(zip(on, jks))
        _payload(cols, dicts, self, l_other, jls[:-1], jls[-1] if how in ("right", "full")
                 else None)
        if how in ("inner", "left", "right", "full"):
            _payload(cols, dicts, other, r_other, jrs[:-1],
                     jrs[-1] if how in ("left", "full") else None, suffix)
        out = self._new(cols, counts.to(torch.int32), dicts)
        if flagged and how in ("left", "anti", "right", "full"):
            # unmatched padding rows emit under these variants: drop them
            out = out.filter(_smap(lambda b: b == 0, fcol))
        return out, ovf

    def _join_lookup(self, other, on, *, suffix="_r", assume_unique=False):
        """The broadcast lookup join (see :meth:`join`): the replicated right
        side is sorted once by key (a validity / NULL-key flag word
        leading when needed), each slot's left rows find their first match
        by merge rank, and one distributed filter compacts the matched rows
        with the gathered right columns. Returns ``(DistTable, dup)``."""
        if not isinstance(other, Table):
            raise TypeError("lookup join needs a replicated single-device Table right side "
                            f"(e.g. an aggregate keyed by the join key); got "
                            f"{type(other).__name__}")
        on = _as_list(on)
        if not all(isinstance(n, str) for n in on):
            raise TypeError("lookup join keys must be column names")
        lk, rk, key_dicts = [], [], {}
        for name in on:
            lc, rc = self._unify_key(other, name, self._value(name), other._resolve([name])[0],
                                     key_dicts)
            lk.append(lc)
            rk.append(rc)
        rnames = [n for n in other.column_names if n not in on]
        for n in rnames:
            if other.null_mask(n) is not None:
                raise TypeError(f"lookup join right column {n!r} carries a null mask — "
                                "DistTable rows cannot hold NULLs; fill_null(...) the "
                                "replicated side first")
        rk_limbs, _ = Q._cols_to_limbs(rk)
        # right flag word: padding rows and NULL keys never match
        rf = None
        if other.count is not None:
            rf = (~other.valid_mask()).to(torch.int32)
        for name in on:
            m = other.null_mask(name)
            if m is not None:
                rf = m.to(torch.int32) if rf is None else (rf | m.to(torch.int32))
        if rf is not None:
            rk_limbs = [rf, *rk_limbs]
        srt = Q._stable_sort([*rk_limbs, *[other[n] for n in rnames]], num_keys=len(rk_limbs))
        rks, rvs = srt[:len(rk_limbs)], srt[len(rk_limbs):]
        n_r = max(other.num_rows, 1)
        matched, gathered, dups = [], [[] for _ in rnames], []
        valid = self.valid_mask()
        for j, dev in enumerate(self._mesh.devices):
            lw, _ = Q._cols_to_limbs([c.blocks[j] for c in lk])
            if rf is not None:
                lw = [torch.zeros_like(lw[0]), *lw]
            lo, hi = Q.merge_rank_pair([w.to(dev) for w in rks], lw)
            matched.append((hi > lo) & valid.blocks[j])
            dups.append(((hi - lo) > 1).any())
            safe = lo.clamp(0, n_r - 1).to(torch.int64)
            for k, rv in enumerate(rvs):
                gathered[k].append(Q._take(rv.to(dev), safe))
        dup = C.any_true(self._mesh, dups) if not assume_unique else None
        if dup:
            raise TypeError("lookup join right side is not key-unique — pairs beyond the first "
                            "match per left row would drop. Aggregate/distinct the right side "
                            "on the join keys first, or use the co-partitioned how='inner' "
                            "join.")
        *outs, counts = dist_query.distributed_filter(
            Sharded(self._mesh, matched), *self._cols.values(),
            *[Sharded(self._mesh, g) for g in gathered], mesh=self._mesh)
        cols, dicts = dict(zip(self._cols, outs[:len(self._cols)])), dict(self._dicts)
        for n, arr in zip(rnames, outs[len(self._cols):]):
            out_name = n + suffix if n in cols else n
            cols[out_name] = arr
            if n in other._dicts:
                dicts[out_name] = other._dicts[n]
        dup_flag = C.all_gather(self._mesh, [d.reshape(1) for d in dups]).any()
        return self._new(cols, counts.to(torch.int32), dicts), dup_flag

    def join_band(self, other: Table, left_on: str, op: str, right_on, *, on=None,
                  capacity_per_shard: int | None = None, how: str = "inner",
                  suffix: str = "_r"):
        """Broadcast non-equi (band) join: ``other`` is a single-device
        :class:`Table` (interval or threshold dimensions). Each slot runs
        ``band_join`` against the replicated side in place (merge-rank range
        probes and the shared expansion, kernel K2 when a row has several
        candidates), so this relation is never exchanged. The predicate
        surface of :meth:`Table.join_band`. Returns ``(DistTable,
        overflow)``: each slot's result rows form its valid prefix
        (left-row-major within the slot), bounded by
        ``capacity_per_shard``; ``overflow`` is True if any slot exceeded
        it."""
        opn = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge"}.get(op, op)
        if opn not in Q.BAND_OPS:
            raise ValueError(f"op must be one of <, <=, >, >=, between (or lt/le/gt/ge), "
                             f"got {op!r}")
        if not isinstance(other, Table):
            raise TypeError("the broadcast band join needs a replicated single-device Table "
                            "right side (interval/threshold dimensions); for two sharded "
                            "relations collect one side first")
        if capacity_per_shard is None:
            if how in ("semi", "anti"):
                capacity_per_shard = self._nl
            else:
                raise TypeError(f"join_band(how={how!r}) needs an explicit capacity_per_shard= "
                                "(the static per-slot result bound); only semi/anti have a "
                                "natural default")
        on = _as_list(on)
        rb_names = list(right_on) if opn == "between" else [right_on]
        if opn == "between" and len(rb_names) != 2:
            raise ValueError('op="between" needs right_on=(lo_col, hi_col)')
        for nm, t in ((left_on, self), *((n, other) for n in rb_names)):
            if isinstance(nm, str) and nm in t._dicts:
                raise TypeError(f"band column {nm!r} is a string column — band predicates "
                                "need numeric/date columns")
        self._no_nulls([left_on, *on], "a band join's left band column or key")
        lb = self._value(left_on)
        rbs = [other._resolve(nm)[0] for nm in rb_names]
        key_dicts, lk, rk, rnull = {}, [], [], None
        for name in on:
            lc, rc = self._unify_key(other, name, self._value(name), other._resolve(name)[0],
                                     key_dicts)
            rnull = NL.merge_masks(rnull, other.null_mask(name))
            lk.append(lc)
            rk.append(rc)
        for nm in rb_names:
            if isinstance(nm, str):
                rnull = NL.merge_masks(rnull, other.null_mask(nm))
        rnames = [n for n in other.column_names if n not in on]
        for n in rnames:
            if n not in rb_names and other.null_mask(n) is not None:
                # a nullable band column is fine: its NULL rows fold into
                # the right flag word and match nothing
                raise TypeError(f"band join right column {n!r} carries a null mask — "
                                "DistTable rows cannot hold NULLs; fill_null(...) the "
                                "replicated side first")
        # per-side flag words, the values of Table's: valid 0, left padding
        # 1, right padding 2, right NULL keys 4 (distinct per side, so
        # filtered-out rows of the two sides never match each other)
        lflag = self._flag()
        rflag = None
        if rnull is not None or other.count is not None:
            rflag = torch.zeros((other.num_rows,), dtype=torch.int32, device=other.device)
            if rnull is not None:
                rflag = torch.where(rnull, 4, rflag)
            if other.count is not None:
                rflag = torch.where(other.valid_mask(), rflag, 2)
        flagged = lflag is not None or rflag is not None
        if flagged:
            lk = [lflag if lflag is not None else self._zeros(), *lk]
            rk = [rflag if rflag is not None else torch.zeros(
                (other.num_rows,), dtype=torch.int32, device=other.device), *rk]
        cap = capacity_per_shard
        include_right = how in ("inner", "left")
        # only left padding rows can emit under these variants
        flagged_keep = lflag is not None and how in ("left", "anti")
        n_r = other.num_rows
        l_names = list(self._cols)
        outs = [[] for _ in l_names + (rnames if include_right else [])]
        cnts, ovfs, unmatched = [], [], []
        for j, dev in enumerate(self._mesh.devices):
            lks = [c.blocks[j] for c in lk]
            lbj = lb.blocks[j]
            n_loc = lbj.shape[0]
            lidx1 = torch.arange(1, n_loc + 1, dtype=torch.int32, device=dev)
            ridx1 = torch.arange(1, n_r + 1, dtype=torch.int32, device=dev)
            rbj = [x.to(dev) for x in rbs]
            jl, jr, cnt, ovf = Q.band_join(
                lbj, lidx1, rbj if opn == "between" else rbj[0], ridx1, op=opn, capacity=cap,
                how=how, left_equi=lks or None, right_equi=[x.to(dev) for x in rk] or None)
            pos = torch.arange(cap, dtype=torch.int32, device=dev)
            valid = pos < cnt
            if flagged_keep:
                # left / anti emit unmatched left rows: drop the padding
                # ones. Real rows are a valid prefix of the slot, so their
                # emissions come first: a truncation lost real rows only if
                # they alone fill the capacity
                fcol = lks[0][(jl - 1).clamp(0, max(n_loc - 1, 0))]
                jl, jr, cnt = Q.filter(valid & (fcol == 0), jl, jr)
                valid = pos < cnt
                ovf = ovf & (cnt >= cap)
            matched_l = valid & (jl > 0)
            lg = (jl - 1).clamp(0, max(n_loc - 1, 0)).to(torch.int64)
            matched = valid & (jr > 0)
            rg = (jr - 1).clamp(0, max(n_r - 1, 0)).to(torch.int64)
            srcs = [(self._cols[n].blocks[j], matched_l, lg) for n in l_names]
            if include_right:
                srcs += [(other[n].to(dev), matched, rg) for n in rnames]
            for k, (c, m, g) in enumerate(srcs):
                outs[k].append(Q._mask(m, Q._signed(Q._take(c, g))).view(c.dtype))
            unmatched.append(~matched)
            cnts.append(cnt.reshape(1).to(torch.int32))
            ovfs.append(ovf)
        counts = C.all_gather(self._mesh, cnts)
        overflow = torch.tensor(C.any_true(self._mesh, ovfs), device=self._mesh.home)
        # the shared equality keys first, as Table.join_band orders them
        cols, dicts = {n: None for n in on}, dict(key_dicts)
        for n, blocks in zip(l_names, outs):
            cols[n] = Sharded(self._mesh, blocks)
            if n in self._dicts:
                dicts[n] = self._dicts[n]
        if include_right:
            for n, blocks in zip(rnames, outs[len(l_names):]):
                out_name = n + suffix if n in cols else n
                cols[out_name] = Sharded(self._mesh, blocks)
                if n in other._dicts:
                    dicts[out_name] = other._dicts[n]
                if how == "left":  # the right cells of unmatched left rows are NULL
                    cols[NL.mask_name(out_name)] = Sharded(self._mesh, unmatched)
        return self._new(cols, counts, dicts), overflow

    def join_asof(self, other: "DistTable", on, *, direction: str = "backward",
                  tolerance=None, suffix: str = "_r",
                  matched_col: str | None = None) -> "DistTable":
        """Distributed ASOF join (pandas ``merge_asof``), row-aligned with
        this table, over the tagged-union exchange. ``other`` must be fully
        valid (filter / compact it first); this table's padding rows never
        match. The matched right rows' columns are gathered by global
        position."""
        other = self._as_dist(other)
        self._no_nulls(on, "an ASOF key")
        if other.nullable_columns:
            raise TypeError(f"join_asof right columns {other.nullable_columns} carry NULLs; "
                            "fill them first")
        if other._counts is not None:
            raise ValueError("join_asof needs a fully-valid right DistTable "
                             "(materialize/compact it first)")
        lk, rk = self._unify_key(other, on, self._value(on), other._value(on), {})
        ridx = Sharded(self._mesh, [s * other._nl + torch.arange(other._nl, dtype=torch.int32,
                                                                 device=dev)
                                    for s, dev in zip(self._mesh.local, self._mesh.devices)])
        _, matched, rpos = dist_asof.distributed_join_asof(
            lk, rk, ridx, self._mesh, direction=direction, tolerance=tolerance, fill=-1)
        if self._counts is not None:
            matched = _smap(torch.logical_and, matched, self.valid_mask())
        rg = _smap(lambda p: p.clamp(0, other._n - 1).to(torch.int64), rpos)
        cols, dicts = dict(self._cols), dict(self._dicts)
        for name, c in other._cols.items():
            if name == on:
                continue
            out_name = name + suffix if name in cols else name
            g = gather_rows(c)  # the right column, replicated for the gather
            cols[out_name] = _smap(
                lambda m, p, _g=g: Q._mask(m, Q._signed(_g.to(p.device))[p]).view(_g.dtype),
                matched, rg)
            if name in other._dicts:
                dicts[out_name] = other._dicts[name]
        if matched_col is not None:
            cols[matched_col] = matched
        return self._new(cols, self._counts, dicts)

    def window(self, ops, *, partition_by=None, order_by=None, descending=None,
               capacity: int | None = None) -> "DistTable":
        """Add window-function columns over the MPP window plan
        (:func:`~.dist_window.distributed_window`; the full single-device
        spec surface, with column names in place of value tensors as in
        :meth:`Table.window`). Padding rows are fenced into partitions of
        their own; the results stay row-aligned and sharded."""
        self._no_nulls([*_as_list(partition_by), *_as_list(order_by)], "a window key")
        specs, out_dicts = [], {}
        for out_name, spec in ops.items():
            if isinstance(spec, str):
                specs.append(spec)
                continue
            spec = list(spec)
            if spec[0] not in ("ntile", "rolling_count", "range_count"):
                self._no_nulls(spec[1], f"window op {spec[0]!r}")
            if spec[0] not in ("ntile", "rolling_count", "range_count"):
                if isinstance(spec[1], str) and spec[1] in self._dicts:
                    if spec[0] in _VALUE_PRESERVING_WINDOW:
                        out_dicts[out_name] = self._dicts[spec[1]]
                    else:
                        self._no_string(spec[1], f"window op {spec[0]!r}")
                spec[1] = self._value(spec[1])
            specs.append(tuple(spec))
        p_cols = self._resolve(partition_by)
        flag = self._flag()
        if flag is not None:
            p_cols = [flag, *p_cols]
        outs = DW.distributed_window(specs, partition_by=p_cols or None,
                                     order_by=self._resolve(order_by) or None,
                                     descending=descending, mesh=self._mesh, capacity=capacity)
        res = self.with_columns(**dict(zip(ops, outs)))
        if out_dicts:
            res = self._new(res._cols, res._counts, {**res._dicts, **out_dicts})
        return res

    def unnest(self, counts, total_size_per_shard: int):
        """UNNEST / explode: valid row i emits ``counts[i]`` copies of every
        column, in row order, into each slot's ``total_size_per_shard`` rows
        (slot-local: one K2 launch per slot, no exchange). Returns
        ``(DistTable, overflow)``; padding rows emit nothing."""
        c = self._value(counts)
        if self._counts is not None:
            c = _smap(lambda x, m: Q._mask(m, x), c, self.valid_mask())
        *outs, new_counts, ovf = dist_query.distributed_repeat(
            list(self._cols.values()), c, self._mesh, total_size_per_shard=total_size_per_shard)
        return self._new(dict(zip(self._cols, outs)), new_counts.to(torch.int32),
                         self._dicts), ovf

    def concat(self, other: "DistTable") -> "DistTable":
        """UNION ALL: this table's valid rows, then ``other``'s (same column
        names and dtypes). Each slot stacks its two blocks; one distributed
        stable sort by (validity flag, global position) packs the combined
        valid rows into a global prefix."""
        other = self._as_dist(other)
        if self.column_names != other.column_names:
            raise ValueError("concat needs identical column names")
        a_cols, b_cols = dict(self._cols), dict(other._cols)
        for n in self.column_names:
            mn = NL.mask_name(n)
            if (mn in a_cols) != (mn in b_cols):
                # a side without a mask contributes all-non-null
                for t, cs in ((self, a_cols), (other, b_cols)):
                    cs.setdefault(mn, t._zeros(torch.bool))
        self, other = (self._new(a_cols, self._counts, self._dicts),
                       other._new(b_cols, other._counts, other._dicts))
        for n, c in self._cols.items():
            if c.dtype != other._cols[n].dtype:
                raise ValueError(f"column {n!r} dtypes differ")
            if (n in self._dicts) != (n in other._dicts):
                raise TypeError(f"column {n!r} is a string column on one side only")
        out_dicts, pairs = {}, {}
        for n, c in self._cols.items():
            a, b = c, other._cols[n]
            if n in self._dicts:
                union, ra, rb = S.unify(self._dicts[n], other._dicts[n])
                a, b, out_dicts[n] = _remap_sharded(ra, a), _remap_sharded(rb, b), union
            pairs[n] = (a, b)
        mesh = self._mesh
        cols = {n: _smap(lambda x, y: C.cat([x, y]), a, b) for n, (a, b) in pairs.items()}
        flag = _smap(lambda x, y: C.cat([(~x).to(torch.int32), (~y).to(torch.int32)]),
                     self.valid_mask(), other.valid_mask())
        # order by (flag, position in this table's rows, then other's)
        pos = Sharded(mesh, [torch.cat([
            s * self._nl + torch.arange(self._nl, dtype=torch.int32, device=dev),
            self._n + s * other._nl + torch.arange(other._nl, dtype=torch.int32, device=dev)])
            for s, dev in zip(mesh.local, mesh.devices)])
        ows, ovs, _, _ = dist_sort.distributed_sort_limbs([flag, pos], list(cols.values()),
                                                          mesh=mesh)
        return self._new(dict(zip(cols, ovs)), self._counts_from_flags(ows[0]), out_dicts)

    # ---- reduction-shaped verbs (single-device results) -------------------------

    def _table(self, cols, count, dicts):
        return Table(cols, count, dictionaries=dicts, device=self._mesh.home)

    def distinct(self, subset=None, *, max_unique: int) -> Table:
        """Distinct valid rows over ``subset`` columns (default: all), the
        two-phase MPP DISTINCT; ``max_unique`` bounds each slot's local
        distinct count (the exact single-device DISTINCT runs past it).
        Returns a single-device :class:`Table`."""
        names = _as_list(subset) or self.column_names
        self._no_nulls(names, "DISTINCT")
        key_cols = self._resolve(names)
        flag = self._flag()
        karg = [flag, *key_cols] if flag is not None else (
            key_cols if len(key_cols) > 1 else key_cols[0])
        uk, _, num, _ = dist_query.distributed_unique(karg, self._mesh, max_unique=max_unique)
        uks = list(uk) if isinstance(uk, (list, tuple)) else [uk]
        if flag is not None:
            fcol, uks = uks[0], uks[1:]
            pos = torch.arange(fcol.shape[0], dtype=torch.int32, device=fcol.device)
            num = ((pos < num) & (fcol == 0)).sum(dtype=torch.int32)
        return self._table(dict(zip(names, uks)), num, self._subdicts(names))

    def aggregate(self, by, aggs, *, max_groups: int, exchange_capacity_factor: float = 2.0,
                  where=None) -> Table:
        """Distributed GROUP BY (the two-phase partial merge for combinable
        aggregations, the shuffle aggregate for holistic ones), with
        :meth:`Table.aggregate`'s ``aggs`` dict. ``max_groups`` bounds each
        slot's group count (the exact single-device aggregate runs past
        it). Returns a single-device :class:`Table`; ``argmin`` /
        ``argmax`` report global row positions."""
        by = _as_list(by)
        if not aggs:
            if not by:
                raise ValueError("aggregate needs group keys or aggs")
            base = self.filter(where) if where is not None else self
            return base.distinct(by, max_unique=max_groups)
        self._no_nulls(by, "a GROUP BY key")
        flag = self._merged_flag(where)
        keys_arg = ([] if flag is None else [flag]) + (self._resolve(by) or [self._zeros()])
        val_cols, agg_list, post, out_dicts = self._agg_plan(keys_arg, aggs)
        uk, outs, cnt, _ = dist_query.distributed_hash_aggregate(
            keys_arg, val_cols, self._mesh, agg_list, max_groups=max_groups,
            exchange_capacity_factor=exchange_capacity_factor)
        # the combined groups are single-device: Table's post-processing
        # (dropping the flag's padding groups, NULL results of all-NULL
        # groups) applies as is
        home = self._table({"_": torch.zeros((1,), device=self._mesh.home)}, None, {})
        home._dicts = dict(self._dicts)
        return home._agg_finish(by, [False] * len(by), post, out_dicts, uk, outs, cnt,
                                has_flag=flag is not None)

    def _agg_plan(self, keys_arg, aggs):
        """:meth:`Table._agg_plan` over Sharded columns: the multi-aggregate's
        value columns and aggregations, with the NULL-skipping rewrites of
        nullable values, and the post-processing plan."""
        val_cols, agg_list, out_dicts, post, nonnull_slot = [], [], {}, [], {}

        def slot(agg, arr):
            val_cols.append(arr)
            agg_list.append(agg)
            return len(val_cols) - 1

        def nonnull(m, key):
            # one shared non-null counter per distinct nullable column
            if key not in nonnull_slot:
                nonnull_slot[key] = slot("sum", _smap(lambda b: (~b).to(torch.int32), m))
            return nonnull_slot[key]

        for out_name, spec in aggs.items():
            agg, col = (spec, None) if isinstance(spec, str) else (
                spec[0], spec[1] if len(spec) > 1 else None)
            if col is None:
                if agg != "count":
                    raise ValueError(f"{out_name!r}: {agg!r} needs a value column")
                col = keys_arg[-1]  # count ignores values
            if agg in _NUMERIC_ONLY_AGGS or agg.startswith("quantile_cont:"):
                self._no_string(col, f"{out_name!r}: {agg}")
            elif (isinstance(col, str) and col in self._dicts
                  and (agg in ("min", "max", "first", "last", "mode", "median")
                       or agg.startswith("quantile:"))):
                out_dicts[out_name] = self._dicts[col]
            if isinstance(col, NL.MaskedColumn):
                m, arr, key = col.mask, self._value(col.values), id(col)
            else:
                m = self.null_mask(col) if isinstance(col, str) else None
                arr, key = self._value(col), (col if isinstance(col, str) else id(col))
            if m is None:
                post.append((out_name, "plain", slot(agg, arr)))
            elif agg == "count":  # COUNT(col): the non-null rows; never NULL itself
                post.append((out_name, "plain", nonnull(m, key)))
            elif agg in ("sum", "any"):
                post.append((out_name, "nullable", slot(agg, arr), nonnull(m, key)))
            elif agg == "mean":
                ft = torch.float64 if arr.dtype == torch.float64 else torch.float32
                post.append((out_name, "mean", slot("sum", _smap(lambda b: b.to(ft), arr)),
                             nonnull(m, key)))
            elif agg in ("min", "max"):
                fill = NL.dtype_max(arr.dtype) if agg == "min" else NL.dtype_min(arr.dtype)
                filled = _smap(lambda b, mb: torch.where(
                    mb, Q._signed(fill.to(b.device)), Q._signed(b)).view(b.dtype), arr, m)
                post.append((out_name, "nullable", slot(agg, filled), nonnull(m, key)))
            elif agg == "all":
                post.append((out_name, "nullable", slot("all", _smap(
                    lambda b, mb: Q._mask(~mb, Q._signed(b), 1).view(b.dtype), arr, m)),
                    nonnull(m, key)))
            elif agg in ("first", "last"):
                post.append((out_name, "pair", slot(agg, arr),
                             slot(agg, _smap(lambda b: b.to(torch.int32), m))))
            else:
                raise TypeError(f"{out_name!r}: aggregate {agg!r} over a NULLABLE column is "
                                "not supported (holistic aggregates need non-null inputs "
                                "here); fill or filter the NULLs first")
        return val_cols, agg_list, post, out_dicts

    def aggregate_sets(self, sets, aggs, grouping=None, *, max_groups: int,
                       exchange_capacity_factor: float = 2.0, where=None) -> Table:
        """Distributed SQL GROUPING SETS / ROLLUP / CUBE: one
        :meth:`aggregate` per grouping set, concatenated with the keys a set
        leaves out as typed NULL columns (:meth:`Table.aggregate_sets`'
        semantics); ``max_groups`` bounds every per-set, per-slot group
        count. When every aggregation re-combines (sum / count / min / max
        / any / all, and mean through hidden sum and count columns), a set
        nested in an already computed superset re-aggregates that
        superset's single-device result instead of running another
        distributed aggregate: a ROLLUP costs one distributed aggregate."""
        sets = [list(_as_list(s)) if s else [] for s in sets]
        if not sets:
            raise ValueError("aggregate_sets needs at least one grouping set")
        all_keys = list(dict.fromkeys(k for s in sets for k in s))
        grouping = dict(grouping or {})
        for key in grouping.values():
            if key not in all_keys:
                raise ValueError(f"GROUPING({key!r}) must reference a column of some "
                                 f"grouping set (have {all_keys})")
        order = [*all_keys, *aggs.keys(), *grouping.keys()]

        def _agg_name(spec):
            return spec if isinstance(spec, str) else spec[0]

        reagg = {"sum": "sum", "count": "sum", "min": "min", "max": "max", "any": "any",
                 "all": "all"}
        shareable = all(_agg_name(s) in reagg or _agg_name(s) == "mean" for s in aggs.values())
        mean_items = [(n, s) for n, s in aggs.items() if _agg_name(s) == "mean"]
        uniq = {}
        for s in sets:
            uniq.setdefault(frozenset(s), list(s))
        tables = {}
        for s in sorted(uniq.values(), key=len, reverse=True):
            fs = frozenset(s)
            parent = None
            if shareable:
                cands = [g for g in tables if fs < g]
                if cands:
                    parent = tables[min(cands, key=len)]
            if parent is None:
                ag = dict(aggs)
                if shareable:
                    # helper partials let coarser levels recover the mean
                    for name, spec in mean_items:
                        if isinstance(spec, str) or len(spec) < 2:
                            continue  # aggregate() raises: mean needs a column
                        ag["__gs_s_" + name] = ("sum", spec[1])
                        ag["__gs_c_" + name] = ("count", spec[1])
                tables[fs] = self.aggregate(s or None, ag, max_groups=max_groups,
                                            exchange_capacity_factor=exchange_capacity_factor,
                                            where=where)
                continue
            ag2 = {}
            for name, spec in aggs.items():
                a = _agg_name(spec)
                if a == "mean":
                    ag2["__gs_s_" + name] = ("sum", "__gs_s_" + name)
                    ag2["__gs_c_" + name] = ("sum", "__gs_c_" + name)
                else:
                    ag2[name] = (reagg[a], name)
            t = parent.aggregate(s or None, ag2)
            if mean_items:
                add = {}
                for name, _ in mean_items:
                    sc, cc = t["__gs_s_" + name], t["__gs_c_" + name]
                    mdt = torch.float64 if sc.dtype == torch.float64 else torch.float32
                    add[name] = sc.to(mdt) / cc.clamp(min=1).to(mdt)
                t = t.with_columns(**add)
            tables[fs] = t
        out = None
        home = self._mesh.home
        for s in sets:
            t = tables[frozenset(s)]
            add = {}
            for k in all_keys:
                if k in s:
                    continue
                zeros = torch.zeros((t.num_rows,), dtype=self._cols[k].dtype, device=home)
                ones = torch.ones((t.num_rows,), dtype=torch.bool, device=home)
                add[k] = (S.DictColumn(zeros, self._dicts[k], ones) if k in self._dicts
                          else NL.MaskedColumn(zeros, ones))
            for gname, key in grouping.items():
                add[gname] = torch.full((t.num_rows,), 0 if key in s else 1, dtype=torch.int32,
                                        device=home)
            if add:
                t = t.with_columns(**add)
            t = t.select(*order)
            out = t if out is None else out.concat(t)
        return out

    def top_k(self, k: int, by, largest: bool = True) -> Table:
        """The global ``k`` rows with extreme ``by`` keys (ORDER BY ... LIMIT
        k over the mesh: k candidate rows per slot gathered). Returns a
        single-device :class:`Table`; ``k`` beyond the row count clamps."""
        k = min(int(k), self.num_rows)
        self._no_nulls(by, "a top_k key")
        keys_arg = self._resolve(by)
        if self._counts is not None:
            ind = (_smap(lambda m: m.to(torch.int32), self.valid_mask()) if largest
                   else self._flag())
            keys_arg = [ind, *keys_arg]
        names = list(self._cols)
        out = dist_query.distributed_top_k(keys_arg if len(keys_arg) > 1 else keys_arg[0], k,
                                           *[self._cols[n] for n in names], mesh=self._mesh,
                                           largest=largest)
        cnt = None if self._counts is None else self.total_count().clamp(max=k)
        return self._table(dict(zip(names, out[1:])), cnt, self._dicts)

    def limit(self, k: int, offset: int = 0) -> Table:
        """The first ``k`` valid rows after ``offset``, in slot-major order,
        as a single-device :class:`Table` (ORDER BY + LIMIT becomes
        :meth:`top_k` in the planner and never lands here)."""
        return self.to_table().limit(k, offset)

    def _set_op(self, other: "DistTable", subset, op_name, max_unique):
        names = _as_list(subset) or self.column_names
        other = self._as_dist(other)
        self._no_nulls(names, "a set operator")
        other._no_nulls(names, "a set operator")
        a_cols, b_cols = self._resolve(names), other._resolve(names)
        out_dicts = {}
        for i, name in enumerate(names):
            a_cols[i], b_cols[i] = self._unify_key(other, name, a_cols[i], b_cols[i], out_dicts)
        aflag, bflag = self._flag(), other._flag()
        flagged = aflag is not None or bflag is not None
        if flagged:
            a_cols = [aflag if aflag is not None else self._zeros(), *a_cols]
            b_cols = [bflag if bflag is not None else other._zeros(), *b_cols]
        fn = {"union": dist_query.distributed_set_union,
              "intersect": dist_query.distributed_set_intersect,
              "difference": dist_query.distributed_set_difference}[op_name]
        keys_out, count, _ = fn(a_cols if len(a_cols) > 1 else a_cols[0],
                                b_cols if len(b_cols) > 1 else b_cols[0], self._mesh,
                                max_unique=max_unique)
        kouts = list(keys_out) if isinstance(keys_out, (list, tuple)) else [keys_out]
        if flagged:
            fcol, kouts = kouts[0], kouts[1:]
            pos = torch.arange(fcol.shape[0], dtype=torch.int32, device=fcol.device)
            count = ((pos < count) & (fcol == 0)).sum(dtype=torch.int32)
        return self._table(dict(zip(names, kouts)), count, out_dicts)

    def union(self, other: "DistTable", subset=None, *, max_unique: int) -> Table:
        """SQL ``UNION`` (distinct) over ``subset`` columns, the two-phase
        distributed set operator; padding on either side contributes
        nothing. Returns a single-device :class:`Table`."""
        return self._set_op(other, subset, "union", max_unique)

    def intersect(self, other: "DistTable", subset=None, *, max_unique: int) -> Table:
        """SQL ``INTERSECT`` over the mesh."""
        return self._set_op(other, subset, "intersect", max_unique)

    def difference(self, other: "DistTable", subset=None, *, max_unique: int) -> Table:
        """SQL ``EXCEPT`` over the mesh (this table minus ``other``)."""
        return self._set_op(other, subset, "difference", max_unique)

    def quantiles(self, column, qs, *, method: str = "lower"):
        """Exact global quantiles of a column's valid rows (on the home
        device): the distributed sort resolves each global rank to the one
        slot that holds it. With padding present the ranks are taken inside
        the valid prefix of a (validity, column) sort."""
        if isinstance(column, str) and column in self._dicts:
            raise TypeError(f"quantiles on string column {column!r}: take them on "
                            f"t[{column!r}] codes and decode(..) explicitly if intended")
        self._no_nulls(column, "quantiles")
        col = self._value(column)
        if self._counts is None:
            return dist_query.distributed_quantiles(col, qs, self._mesh, method=method)
        qs = [float(q) for q in qs]
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile points must be in [0, 1], got {q}")
        if method not in R.QUANTILE_METHODS:
            raise ValueError(f"method must be one of {R.QUANTILE_METHODS}, got {method!r}")
        per = [K.encode_limbs(b) for b in col.blocks]
        limbs = [Sharded(self._mesh, [p[k] for p in per]) for k in range(len(per[0]))]
        ows, _, fill_counts, _ = dist_sort.distributed_sort_limbs([self._flag(), *limbs],
                                                                  mesh=self._mesh)
        home = self._mesh.home
        total = self.total_count()
        x = torch.tensor(qs, dtype=torch.float32, device=home) * (total - 1).to(torch.float32)
        if method == "lower":
            r = torch.floor(x)
        elif method == "higher":
            r = torch.ceil(x)
        else:
            r = torch.floor(x + 0.5)
        ranks = torch.minimum(r.to(torch.int32).clamp(min=0), (total - 1).clamp(min=0))
        # the valid rows are the global prefix of the (flag, value) sort:
        # rank j's owner comes from the fill counts
        fc = fill_counts.to(torch.int64)
        offs = torch.cumsum(fc, 0) - fc
        owner = (torch.searchsorted(offs, ranks.to(torch.int64), right=True) - 1).clamp(
            0, self._P - 1)
        local = ranks.to(torch.int64) - offs[owner]
        parts = []
        for j, s in enumerate(self._mesh.local):
            blk = [w.blocks[j] for w in ows[1:]]
            dev = blk[0].device
            idx = local.to(dev).clamp(0, blk[0].shape[0] - 1)
            hit = owner.to(dev) == s
            parts.append(torch.stack([torch.where(hit, w[idx], 0) for w in blk]).reshape(-1))
        g = C.all_gather(self._mesh, parts).reshape(self._P, len(ows) - 1, len(qs))
        return K.decode_limbs(list(g.sum(0, dtype=torch.int32)), col.dtype)

    # ---- deferred execution ---------------------------------------------

    def lazy(self):
        """A :class:`~radix_sort_tpu_torch.plan.LazyTable` rooted at this
        sharded relation (the planner of :meth:`Table.lazy`; per-slot
        capacity knobs ride each verb's kwargs into the executor)."""
        from radix_sort_tpu_torch.plan import LazyTable, Source

        return LazyTable(Source(self))

    # ---- materialization ------------------------------------------------

    def to_table(self) -> Table:
        """The relation as a single-device :class:`Table` on the home
        device: the slots' valid prefixes packed into one prefix of
        ``num_rows`` rows."""
        if self._counts is None:
            return self._table({n: gather_rows(c) for n, c in self._cols.items()}, None,
                               self._dicts)
        cols = {}
        for n, c in self._cols.items():
            v = valid_rows(c, self._counts)
            cols[n] = C.cat([v, torch.zeros((self._n - v.shape[0],), dtype=v.dtype,
                                            device=v.device)])
        return self._table(cols, self.total_count(), self._dicts)

    def to_numpy(self):
        """dict of numpy arrays holding only the valid rows, in global slot
        order; string columns decode through their dictionaries."""
        def rows(c):
            return _np(gather_rows(c) if self._counts is None else valid_rows(c, self._counts))

        out = {}
        for n in self.column_names:
            a = rows(self._cols[n])
            out[n] = S.decode(a, self._dicts[n]) if n in self._dicts else a
            m = self.null_mask(n)
            if m is not None:
                out[n] = np.ma.MaskedArray(out[n], mask=rows(m))
        return out
