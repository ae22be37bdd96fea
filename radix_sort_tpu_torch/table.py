"""Table: a named-column relational facade over the query operators.

Counterpart of ``radix_sort_tpu/table.py``. The operators (``ops/query.py``,
``ops/relational.py``, ``ops/window.py``, ``ops/sort.py``) work on
positional columns and return data-dependent sizes as (padded tensors...,
count). ``Table`` packages that convention behind named columns and chained
filter / sort_by / aggregate / join / window / distinct / top_k calls.

Validity model: a Table is ``num_rows`` rows of which the first ``count``
are valid (``count=None`` means all). Operators that cannot skip rows weave
validity in as an extra leading key word:

  - sorts order by (invalid flag, keys...), so valid rows stay a prefix;
  - group-bys and distincts group by (invalid flag, keys...): padding
    groups sort after the valid ones and are left out of the count;
  - joins key on per-side flags (left padding 1, right padding 2), so
    padding never matches, and drop the padding rows the outer variants
    would emit;
  - windows partition on (invalid flag, partition keys...).

``count`` is a 0-dim int32 tensor on the table's device; ``to_numpy()``
reads it on the host.

Device: ``Table(..., device=None)`` puts every column on the GPU
(``"cuda"``), and raises when there is none; ``device="cpu"`` keeps them on
the CPU. Every table derived from one keeps its device.

String columns are dictionary-encoded (``strings.py``): host string data
becomes ``uint32`` codes on the device plus a sorted host vocabulary, so
every operator runs on the codes with lexicographically correct results;
joins, set operators and ``concat`` unify the two dictionaries first.
``numpy.datetime64`` columns become int32 epoch days or int64 epoch
microseconds (``dates.py``). Nullable columns carry hidden bool masks
(``nulls.py``).

Column expressions (``expr.py``) are accepted by ``with_columns``,
``filter`` and the ``where=`` of ``aggregate`` / ``aggregate_sets``;
``Table.lazy()`` starts a deferred pipeline (``plan.py``), which is also what
``sql()`` builds. ``Table.from_csv`` reads a CSV file through the native
loader (``native/csvio.py``, ``utils/io.py``).
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
from radix_sort_tpu_torch.ops import sort as SO
from radix_sort_tpu_torch.ops import window as W

__all__ = ["Table"]

# aggregations that are arithmetic over the value domain: meaningless on
# dictionary codes (order- and identity-based ones are fine)
_NUMERIC_ONLY_AGGS = ("sum", "mean", "var", "std", "any", "all")
# window ops whose output is a value of the input column (the output column
# inherits the source column's dictionary)
_VALUE_PRESERVING_WINDOW = (
    "lag", "lead", "first_value", "last_value", "nth_value",
    "min", "max", "cummin", "cummax", "rolling_min", "rolling_max",
    "range_min", "range_max",
)


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("Table puts its columns on the GPU and no CUDA device is available; "
                           "pass device='cpu' to keep them on the CPU")
    return torch.device("cuda")


def _tensor(c, dev):
    """A column (tensor, numpy array, list or scalar) as a tensor on ``dev``;
    unsigned tensors move as their signed views."""
    if not torch.is_tensor(c):
        c = torch.from_numpy(np.array(c))  # a copy: later writes to c do not show
    return Q._signed(c).to(dev).view(c.dtype)


def _np(t):
    return Q._signed(t).cpu().numpy().view(np.dtype(str(t.dtype).replace("torch.", "")))


def _where(keep, a, fill=0):
    """``where(keep, a, fill)`` in ``a``'s dtype (unsigned via the signed view)."""
    return Q._mask(keep, Q._signed(a), fill).view(a.dtype)


def _cat(parts):
    return torch.cat([Q._signed(p) for p in parts]).view(parts[0].dtype)


def _remap(table, codes):
    """``table[codes]`` for a uint32 remap table (numpy) and uint32 codes."""
    t = torch.from_numpy(np.ascontiguousarray(table).view(np.int32)).to(codes.device)
    return t[codes.view(torch.int32).to(torch.int64)].view(torch.uint32)


def _word(m):
    """A bool mask as an int32 key word (0 / 1)."""
    return m.to(torch.int32)


class Table:
    """An immutable relation: equal-length named columns + a valid-row count
    (rows [0, count) are the data)."""

    def __init__(self, columns, count=None, dictionaries=None, null_masks=None, *,
                 device=None):
        dev = _device(device)
        cols = dict(columns)
        if not cols:
            raise ValueError("a Table needs at least one column")
        dicts = dict(dictionaries) if dictionaries else {}
        masks = {n: m for n, m in (null_masks or {}).items() if m is not None}
        n = None
        for name, c in list(cols.items()):
            if NL.is_mask_name(name):
                # internal path: a companion null-mask column inline
                cols[name] = _tensor(c, dev).to(torch.bool)
                continue
            if "\x00" in name:
                raise ValueError(f"column name {name!r} contains NUL")
            det = NL.detect(c)
            if det is not None:
                c, masks[name] = det  # np.ma / None-bearing host input
            if name not in dicts and S.is_string_data(c):
                # uint32 codes on the device, sorted vocabulary on the host
                c, dicts[name] = S.encode(c)
            elif DT.is_datetime_data(c):
                # int32 epoch days / int64 epoch microseconds
                c, _ = DT.encode_datetime64(c)
            c = _tensor(c, dev)
            if c.ndim != 1:
                raise ValueError(f"column {name!r} must be 1-D, got {tuple(c.shape)}")
            if n is None:
                n = c.shape[0]
            elif c.shape[0] != n:
                raise ValueError(f"column {name!r} has length {c.shape[0]}, expected {n}")
            cols[name] = c
        if n is None:
            raise ValueError("a Table needs at least one data column "
                             "(only null-mask columns were given)")
        for name, c in cols.items():
            if NL.is_mask_name(name) and tuple(c.shape) != (n,):
                raise ValueError(f"null-mask column {name!r} has shape {tuple(c.shape)}, "
                                 f"expected ({n},)")
        for name, m in masks.items():
            if name not in cols:
                raise ValueError(f"null mask for unknown column {name!r}")
            m = _tensor(m, dev).to(torch.bool)
            if tuple(m.shape) != (n,):
                raise ValueError(f"null mask for {name!r} has shape {tuple(m.shape)}, "
                                 f"expected ({n},)")
            cols[NL.mask_name(name)] = m
        for name in list(cols):
            # the engine invariant: values are 0 wherever the mask is True
            mn = NL.mask_name(name)
            if not NL.is_mask_name(name) and mn in cols:
                cols[name] = _where(~cols[mn], cols[name])
        self._cols = cols
        self._n = n
        self._dev = dev
        self._count = None if count is None else torch.as_tensor(count).to(dev, torch.int32)
        self._dicts = {k: v for k, v in dicts.items() if k in cols}

    def _new(self, cols, count, dicts):
        return Table(cols, count, dictionaries=dicts, device=self._dev)

    @classmethod
    def from_csv(cls, path: str, *, delimiter: str = ",", dtypes=None,
                 device=None) -> "Table":
        """Read a headered CSV into a Table on ``device`` (the GPU unless
        ``device="cpu"``). With the native C++ loader (native/csv_loader.cpp)
        string columns arrive ALREADY dictionary-encoded (codes + sorted
        vocabulary), ISO dates as dates and empty fields as SQL NULL masks:
        no per-row Python string work. With ``dtypes=``, or without a
        compiler, this takes the numpy path (utils/io.read_csv), which
        dictionary-encodes in the constructor."""
        from radix_sort_tpu_torch.utils.io import read_csv, read_csv_encoded

        if not dtypes:
            try:
                cols, dicts, masks = read_csv_encoded(path, delimiter=delimiter)
            except RuntimeError:
                pass
            else:
                return cls(cols, dictionaries=dicts, null_masks=masks or None, device=device)
        return cls(read_csv(path, delimiter=delimiter, dtypes=dtypes), device=device)

    # ---- introspection -------------------------------------------------

    @property
    def num_rows(self) -> int:
        """Row capacity (valid rows + padding)."""
        return self._n

    @property
    def count(self):
        """Valid-row count: a 0-dim int32 tensor, or None when all rows are
        valid (then it equals ``num_rows``)."""
        return self._count

    @property
    def device(self) -> torch.device:
        return self._dev

    @property
    def column_names(self):
        return [n for n in self._cols if not NL.is_mask_name(n)]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __repr__(self):
        cnt = "all" if self._count is None else "counted"
        return (f"Table({self._n} rows [{cnt} valid] on {self._dev}, "
                f"columns={self.column_names})")

    # ---- NULLs ---------------------------------------------------------

    def is_nullable(self, name: str) -> bool:
        """True if ``name`` carries a null mask."""
        return NL.mask_name(name) in self._cols

    def null_mask(self, name: str):
        """The column's bool null mask (True = NULL), or None."""
        return self._cols.get(NL.mask_name(name))

    @property
    def nullable_columns(self):
        return [n for n in self.column_names if self.is_nullable(n)]

    def _key_words(self, ref, arr):
        """Key words of one sort key: the null-mask word first (NULL sorts
        as +infinity), then the value's rank limbs."""
        m = self._mask_of_ref(ref)
        words = [] if m is None else [_word(m)]
        words.extend(K.encode_limbs(arr))
        return words, m is not None

    def _mask_of_ref(self, ref):
        if isinstance(ref, str):
            return self.null_mask(ref)
        if isinstance(ref, NL.MaskedColumn):
            return _tensor(ref.mask, self._dev).to(torch.bool)
        return None

    def _resolve_masked(self, cols):
        """Like :meth:`_resolve` but keeps the original refs (so callers can
        recover null masks) and zeroes masked values."""
        refs = _as_list(cols)
        arrs = []
        for c in refs:
            if isinstance(c, str):
                arrs.append(self._cols[c])
            elif isinstance(c, NL.MaskedColumn):
                arrs.append(_where(~self._mask_of_ref(c), _tensor(c.values, self._dev)))
            else:
                arrs.append(_tensor(c, self._dev))
        return arrs, refs

    def valid_mask(self) -> torch.Tensor:
        """Bool mask of the valid prefix."""
        if self._count is None:
            return torch.ones((self._n,), dtype=torch.bool, device=self._dev)
        return torch.arange(self._n, dtype=torch.int32, device=self._dev) < self._count

    def _flag(self):
        """Leading validity key word: 0 valid, 1 invalid (None when the
        whole table is valid)."""
        if self._count is None:
            return None
        return _word(~self.valid_mask())

    def _resolve(self, cols):
        """Column names -> tensors (tensors and arrays pass through)."""
        return [self._cols[c] if isinstance(c, str) else _tensor(c, self._dev)
                for c in _as_list(cols)]

    # ---- string columns --------------------------------------------------

    def is_string(self, name: str) -> bool:
        """True if ``name`` is a dictionary-encoded string column."""
        return name in self._dicts

    def dictionary(self, name: str) -> np.ndarray:
        """The sorted host vocabulary of a string column (``vocab[code]`` is
        the value; index 0 is always ``""``)."""
        return self._dicts[name]

    def code(self, name: str, value):
        """The uint32 code(s) of string value(s) under ``name``'s
        dictionary, on the table's device; absent values get a code equal to
        no real code."""
        codes = np.atleast_1d(np.asarray(S.lookup(self._dicts[name], value), np.uint32))
        t = _tensor(codes, self._dev)
        return t[0] if isinstance(value, (str, bytes)) else t

    def decode(self, name: str, codes=None) -> np.ndarray:
        """Decode a code tensor (default: the column itself) against
        ``name``'s dictionary, on the host."""
        if codes is None:
            codes = self._cols[name]
        return S.decode(_np(codes) if torch.is_tensor(codes) else np.asarray(codes),
                        self._dicts[name])

    def _subdicts(self, names):
        return {n: self._dicts[n] for n in names if n in self._dicts}

    def _no_string(self, col, what: str):
        if isinstance(col, str) and col in self._dicts:
            raise TypeError(f"{what} is arithmetic over values and is undefined on string "
                            f"column {col!r} (dictionary codes); use an order/identity-based "
                            "op (min/max/first/last/...) or the raw codes explicitly")

    # ---- projection ----------------------------------------------------

    def select(self, *names) -> "Table":
        cols = {}
        for n in names:
            cols[n] = self._cols[n]
            mn = NL.mask_name(n)
            if mn in self._cols:
                cols[mn] = self._cols[mn]
        return self._new(cols, self._count, self._subdicts(names))

    def drop(self, *names) -> "Table":
        gone = set(names)
        keep = {n: c for n, c in self._cols.items()
                if (NL.base_name(n) if NL.is_mask_name(n) else n) not in gone}
        return self._new(keep, self._count, self._subdicts(keep))

    def rename(self, mapping) -> "Table":
        def new(n):
            if NL.is_mask_name(n):
                b = NL.base_name(n)
                return NL.mask_name(mapping.get(b, b))
            return mapping.get(n, n)

        return self._new({new(n): c for n, c in self._cols.items()}, self._count,
                         {mapping.get(n, n): d for n, d in self._dicts.items()})

    def with_columns(self, **named) -> "Table":
        """Add or replace columns: tensors, numpy arrays, ``np.ma`` arrays,
        lists (``None`` entries become NULLs), host string data,
        :class:`~radix_sort_tpu_torch.nulls.MaskedColumn`,
        :class:`~radix_sort_tpu_torch.strings.DictColumn`, scalars (broadcast
        to every row) or callables taking this Table and returning one of
        those, or :class:`~radix_sort_tpu_torch.expr.Expr` trees (evaluated
        against this Table; string-valued ones keep their dictionary)."""
        from radix_sort_tpu_torch.expr import Expr

        cols = dict(self._cols)
        dicts = dict(self._dicts)
        for n, c in named.items():
            if isinstance(c, Expr):
                sr = c.string_result(self)
                if sr is not None:
                    c = S.DictColumn(*sr)
                else:
                    v, em = c.evaluate_masked(self)
                    c = v if em is None else NL.MaskedColumn(v, em)
            elif callable(c) and not torch.is_tensor(c):
                c = c(self)
            m = None
            if isinstance(c, S.DictColumn):
                # a computed string column: codes plus its own dictionary
                dicts[n] = c.vocab
                c, m = c.codes, c.mask
            else:
                det = NL.detect(c)
                if det is not None:
                    c, m = det
                if S.is_string_data(c):
                    c, dicts[n] = S.encode(c)
                else:
                    dicts.pop(n, None)  # replaced by a numeric column
            c = _tensor(c, self._dev)
            if c.ndim == 0:
                c = Q._signed(c).expand(self._n).clone().view(c.dtype)  # NULL / literal
            if c.shape[0] != self._n:
                raise ValueError(f"column {n!r} has length {c.shape[0]}, expected {self._n}")
            if m is not None:
                m = _tensor(m, self._dev).to(torch.bool).expand(self._n).clone()
                cols[NL.mask_name(n)] = m
                c = _where(~m, c)
            else:
                cols.pop(NL.mask_name(n), None)  # replaced, no longer null
            cols[n] = c
        return self._new(cols, self._count, dicts)

    # ---- relational operators ------------------------------------------

    def _merged_flag(self, where=None):
        """The leading validity flag word with an optional WHERE predicate
        folded in (nonzero = excluded row), or None when every row
        participates."""
        flag = self._flag()
        if where is None:
            return flag
        w = _word(~self._eval_pred(where))
        return w if flag is None else (flag | w)

    def _eval_pred(self, mask):
        """A WHERE predicate (bool column, :class:`Expr`, callable taking this
        Table, or MaskedColumn) -> a plain bool row mask; a nullable
        predicate keeps only the rows where it is known TRUE (SQL WHERE)."""
        from radix_sort_tpu_torch.expr import Expr

        if isinstance(mask, Expr):
            v, m = mask.evaluate_masked(self)
            mask = v if m is None else (v & ~m)
        elif callable(mask) and not torch.is_tensor(mask):
            mask = mask(self)
        if isinstance(mask, NL.MaskedColumn):
            mask = (_tensor(mask.values, self._dev).to(torch.bool)
                    & ~_tensor(mask.mask, self._dev).to(torch.bool))
        mask = _tensor(mask, self._dev)
        if mask.ndim == 0:
            mask = mask.expand(self._n)  # an all-scalar predicate
        return mask

    def filter(self, mask) -> "Table":
        """Rows where ``mask`` holds (a bool column, an :class:`Expr`, or a
        callable taking this Table), compacted to the front in original
        order."""
        mask = self._eval_pred(mask)
        if self._count is not None:
            mask = mask & self.valid_mask()
        *out, cnt = Q.filter(mask, *self._cols.values())
        return self._new(dict(zip(self._cols, out)), cnt, self._dicts)

    def sort_by(self, by, descending=False, nulls_last=None) -> "Table":
        """Stable sort of the valid rows by one or more columns (every other
        column rides the one sort; padding stays last). ``descending`` is a
        bool or a per-column list. NULL keys sort as +infinity by default
        (last ascending, first descending); ``nulls_last`` (bool or a
        per-column list of bool-or-None) overrides it per key."""
        by = _as_list(by)
        desc = [descending] * len(by) if isinstance(descending, bool) else list(descending)
        if len(desc) != len(by):
            raise ValueError("descending list must match the by list")
        nlast = ([nulls_last] * len(by) if nulls_last is None or isinstance(nulls_last, bool)
                 else list(nulls_last))
        if len(nlast) != len(by):
            raise ValueError("nulls_last list must match the by list")
        key_cols, by = self._resolve_masked(by)
        limbs = []
        for c, d, nl_, name in zip(key_cols, desc, nlast, by):
            words, has_mask = self._key_words(name, c)
            if has_mask:
                eff_last = (not d) if nl_ is None else bool(nl_)
                limbs.append(words[0] if eff_last else ~words[0])
                words = words[1:]
            limbs.extend(~w if d else w for w in words)
        flag = self._flag()
        if flag is not None:
            limbs = [flag, *limbs]
        out = Q._stable_sort([*limbs, *self._cols.values()], num_keys=len(limbs))
        return self._new(dict(zip(self._cols, out[len(limbs):])), self._count, self._dicts)

    def _keys_with_masks(self, names, key_cols, lead):
        """GROUP BY / DISTINCT key columns: ``lead`` words, then per key its
        mask word (nullable keys) and its column; and which keys had one."""
        keys_arg, has_mask = list(lead), []
        for name, c in zip(names, key_cols):
            m = self._mask_of_ref(name)
            if m is not None:
                keys_arg.append(_word(m))
            has_mask.append(m is not None)
            keys_arg.append(c)
        return keys_arg, has_mask

    def _key_table_cols(self, names, has_mask, uks):
        cols, i = {}, 0
        for name, hm in zip(names, has_mask):
            if hm:
                cols[NL.mask_name(name)] = uks[i].to(torch.bool)
                i += 1
            cols[name] = uks[i]
            i += 1
        return cols

    def _valid_groups(self, fcol, num):
        """Groups of valid rows among the first ``num`` (flag word 0)."""
        pos = torch.arange(fcol.shape[0], dtype=torch.int32, device=self._dev)
        return ((pos < num) & (fcol == 0)).sum(dtype=torch.int32)

    def distinct(self, subset=None) -> "Table":
        """Distinct rows over ``subset`` columns (default: all columns),
        ascending lexicographically (NULL last; NULL groups with NULL).
        Other columns are dropped."""
        names = _as_list(subset) or self.column_names
        key_cols, names = self._resolve_masked(names)
        flag = self._flag()
        keys_arg, has_mask = self._keys_with_masks(names, key_cols,
                                                   [] if flag is None else [flag])
        uk, _, num = Q.unique(keys_arg if len(keys_arg) > 1 else keys_arg[0])
        uks = list(uk) if isinstance(uk, (list, tuple)) else [uk]
        if flag is not None:
            num = self._valid_groups(uks[0], num)
            uks = uks[1:]
        return self._new(self._key_table_cols(names, has_mask, uks), num,
                         self._subdicts(names))

    def aggregate(self, by, aggs, *, where=None) -> "Table":
        """GROUP BY ``by`` (a column name / list, or None for one group over
        the valid rows) computing ``aggs``: a dict of output name ->
        ``(agg, column)`` with agg one of
        :data:`~radix_sort_tpu_torch.ops.query.AGGREGATIONS` or a quantile
        (``"count"`` alone also works). ``where`` (a predicate as
        :meth:`filter` takes) restricts the aggregated rows without a
        separate compaction: excluded rows ride the key sort's leading flag
        word. One key sort computes every aggregate (the multi-aggregate);
        the (key, value)-sorted ones add one sort each. ``argmin`` /
        ``argmax`` report positions in this table's rows."""
        by = _as_list(by)
        if not aggs:
            if not by:
                raise ValueError("aggregate needs group keys or aggs")
            base = self.filter(where) if where is not None else self
            return base.distinct(by)  # GROUP BY with no aggregates
        key_cols, by = self._resolve_masked(by)
        flag = self._merged_flag(where)
        lead = [] if flag is None else [flag]
        if not key_cols:
            lead.append(torch.zeros((self._n,), dtype=torch.int32, device=self._dev))
        keys_arg, key_has_mask = self._keys_with_masks(by, key_cols, lead)
        val_cols, agg_list, post, out_dicts = self._agg_plan(keys_arg, aggs)
        uk, outs, cnt = Q.hash_aggregate(keys_arg, val_cols, agg_list)
        return self._agg_finish(by, key_has_mask, post, out_dicts, uk, outs, cnt,
                                has_flag=flag is not None)

    def _agg_plan(self, keys_arg, aggs):
        """Parse an ``aggs`` dict into the multi-aggregate call (value
        columns and aggregation names, with the NULL-skipping rewrites) and
        the post-processing plan; shared with the grouping-sets path."""
        val_cols, agg_list, out_dicts = [], [], {}
        post, nonnull_slot = [], {}  # post: (out_name, kind, value slots...)

        def _slot(agg, arr):
            val_cols.append(arr)
            agg_list.append(agg)
            return len(val_cols) - 1

        def _nonnull(m, key):
            # one shared non-null counter per distinct nullable column
            if key not in nonnull_slot:
                nonnull_slot[key] = _slot("sum", (~m).to(torch.int32))
            return nonnull_slot[key]

        for out_name, spec in aggs.items():
            if isinstance(spec, str):
                agg, col = spec, None
            else:
                agg, col = spec[0], (spec[1] if len(spec) > 1 else None)
            if col is None:
                if agg != "count":
                    raise ValueError(f"{out_name!r}: {agg!r} needs a value column")
                col = keys_arg[-1]  # count ignores values
            if agg in _NUMERIC_ONLY_AGGS or agg.startswith("quantile_cont:"):
                self._no_string(col, f"{out_name!r}: {agg}")
            elif (isinstance(col, str) and col in self._dicts
                  and (agg in ("min", "max", "first", "last", "mode", "median")
                       or agg.startswith("quantile:"))):
                out_dicts[out_name] = self._dicts[col]  # a value of the column
            m = self._mask_of_ref(col)
            if isinstance(col, NL.MaskedColumn):
                arr = _where(~m, _tensor(col.values, self._dev))
                mkey = id(col)
            else:
                arr = self._resolve(col)[0]
                mkey = col if isinstance(col, str) else id(col)
            if m is None:
                post.append((out_name, "plain", _slot(agg, arr)))
                continue
            # NULL-skipping rewrites (values are 0 under the mask)
            if agg == "count":
                # COUNT(col): non-null rows only; never NULL itself
                post.append((out_name, "plain", _nonnull(m, mkey)))
            elif agg in ("sum", "any"):
                post.append((out_name, "nullable", _slot(agg, arr), _nonnull(m, mkey)))
            elif agg == "mean":
                ft = torch.float64 if arr.dtype == torch.float64 else torch.float32
                post.append((out_name, "mean", _slot("sum", arr.to(ft)), _nonnull(m, mkey)))
            elif agg in ("min", "max"):
                fill = NL.dtype_max(arr.dtype) if agg == "min" else NL.dtype_min(arr.dtype)
                filled = torch.where(m, Q._signed(fill.to(arr.device)), Q._signed(arr))
                post.append((out_name, "nullable", _slot(agg, filled.view(arr.dtype)),
                             _nonnull(m, mkey)))
            elif agg == "all":
                post.append((out_name, "nullable", _slot("all", _where(~m, arr, 1)),
                             _nonnull(m, mkey)))
            elif agg in ("first", "last"):
                # the value and its nullness at the group's first/last row
                post.append((out_name, "pair", _slot(agg, arr),
                             _slot(agg, m.to(torch.int32))))
            else:
                raise TypeError(f"{out_name!r}: aggregate {agg!r} over a NULLABLE column is "
                                "not supported (holistic aggregates need non-null inputs "
                                "here); fill or filter the NULLs first")
        return val_cols, agg_list, post, out_dicts

    def _agg_finish(self, by, key_has_mask, post, out_dicts, uk, outs, cnt, *, has_flag):
        """Assemble an aggregated Table from the padded ``(unique_keys,
        aggregates, count)`` outputs: :meth:`_agg_plan`'s counterpart."""
        uks, outs = list(uk), list(outs)
        if has_flag:
            cnt = self._valid_groups(uks[0], cnt)
            uks = uks[1:]
        cols = self._key_table_cols(by, key_has_mask, uks)  # drops the dummy key
        for item in post:
            out_name, kind = item[0], item[1]
            if kind == "plain":
                cols[out_name] = outs[item[2]]
                continue
            if kind == "pair":
                v, mi = outs[item[2]], outs[item[3]]
                gm = mi != 0
            else:
                v, nn = outs[item[2]], outs[item[3]]
                gm = nn == 0  # all-NULL group -> NULL result (SQL)
                if kind == "mean":
                    v = v / nn.clamp(min=1).to(v.dtype)
            cols[out_name] = _where(~gm, v)
            cols[NL.mask_name(out_name)] = gm
        return self._new(cols, cnt, {**self._subdicts(by), **out_dicts})

    def aggregate_sets(self, sets, aggs, grouping=None, *, where=None) -> "Table":
        """SQL GROUPING SETS (and the ROLLUP / CUBE shorthands): UNION ALL of
        one :meth:`aggregate` per grouping set over the same ``aggs``, with
        the keys a set leaves out returned as typed NULL columns (string
        keys keep their dictionary). ``sets`` is an iterable of name lists
        (``[]`` / None = the grand total). ``grouping``: {out_name: key}
        adds the SQL ``GROUPING(key)`` indicator (int32: 0 grouped, 1 rolled
        up). When every aggregation is in
        :data:`~radix_sort_tpu_torch.ops.query.LEVEL_AGGREGATIONS`, nested
        sets share one key sort per chain (``hash_aggregate_levels``);
        otherwise each set takes its own aggregate."""
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
        tables = self._aggregate_set_tables(sets, aggs, where=where)
        out = None
        for s in sets:
            t = tables[frozenset(s)]
            add = {}
            for k in all_keys:
                if k in s:
                    continue
                zeros = torch.zeros((t._n,), dtype=self._cols[k].dtype, device=self._dev)
                ones = torch.ones((t._n,), dtype=torch.bool, device=self._dev)
                add[k] = (S.DictColumn(zeros, self._dicts[k], ones) if k in self._dicts
                          else NL.MaskedColumn(zeros, ones))
            for gname, key in grouping.items():
                add[gname] = torch.full((t._n,), 0 if key in s else 1, dtype=torch.int32,
                                        device=self._dev)
            if add:
                t = t.with_columns(**add)
            t = t.select(*order)
            out = t if out is None else out.concat(t)
        return out

    def _aggregate_set_tables(self, sets, aggs, where=None):
        """One aggregated Table per distinct grouping set (keyed by
        frozenset). Nested sets whose aggregations are all segment
        reductions form prefix chains: the chain's keys are ordered
        innermost-out, so every member is a leading prefix of the full key
        list, and one ``hash_aggregate_levels`` call (one sort) serves every
        level. Everything else takes one :meth:`aggregate` per set."""
        shareable = aggs and all((spec if isinstance(spec, str) else spec[0])
                                 in Q.LEVEL_AGGREGATIONS for spec in aggs.values())
        uniq = {}
        for s in sets:
            uniq.setdefault(frozenset(s), list(s))
        chains = []
        if shareable:
            # greedy nesting, largest first: append to the first chain whose
            # innermost set strictly contains this one
            for s in sorted(uniq.values(), key=len, reverse=True):
                for ch in chains:
                    if frozenset(s) < frozenset(ch[-1]):
                        ch.append(s)
                        break
                else:
                    chains.append([s])
        else:
            chains = [[s] for s in uniq.values()]
        tables = {}
        for ch in chains:
            if len(ch) == 1:
                tables[frozenset(ch[0])] = self.aggregate(ch[0] or None, dict(aggs),
                                                          where=where)
                continue
            full_by = []
            for s in reversed(ch):
                full_by.extend(k for k in s if k not in full_by)
            key_cols, by = self._resolve_masked(full_by)
            flag = self._merged_flag(where)
            keys_arg = [] if flag is None else [flag]
            key_has_mask = []
            level_at = [len(keys_arg)]  # keys_arg width per key prefix
            for kname, kc in zip(by, key_cols):
                m = self._mask_of_ref(kname)
                if m is not None:
                    keys_arg.append(_word(m))
                key_has_mask.append(m is not None)
                keys_arg.append(kc)
                level_at.append(len(keys_arg))
            val_cols, agg_list, post, out_dicts = self._agg_plan(keys_arg, aggs)
            levels = Q.hash_aggregate_levels(keys_arg, val_cols, agg_list,
                                             [level_at[len(s)] for s in ch])
            for s, (uk, louts, cnt) in zip(ch, levels):
                k = len(s)
                tables[frozenset(s)] = self._agg_finish(
                    by[:k], key_has_mask[:k], post, out_dicts, uk, louts, cnt,
                    has_flag=flag is not None)
        return tables

    def _join_keys(self, other, on, lextra_null=None, rextra_null=None):
        """Shared join key preparation: resolve the ``on`` columns on both
        sides (unifying string dictionaries), collect key NULL masks, and
        fold validity and NULLs into per-side leading flag words. Returns
        ``(lk, rk, key_dicts, lkey_masks, rkey_masks, flagged)``.
        ``lextra_null`` / ``rextra_null`` add more no-match masks (NULL band
        columns in :meth:`join_band`)."""
        lk, rk, key_dicts = [], [], {}
        lkey_masks, rkey_masks = {}, {}
        lnull, rnull = lextra_null, rextra_null
        for name in on:
            lc = self._resolve(name)[0]
            rc = other._resolve(name)[0]
            if isinstance(name, str) and ((name in self._dicts) != (name in other._dicts)):
                raise TypeError(f"join key {name!r} is a string column on one side only — "
                                "encode both sides or neither")
            if isinstance(name, str) and name in self._dicts:
                # unify the two dictionaries (host), remap the codes into the
                # shared order-preserving space (one small gather each)
                union, ra, rb = S.unify(self._dicts[name], other._dicts[name])
                lc, rc = _remap(ra, lc), _remap(rb, rc)
                key_dicts[name] = union
            if isinstance(name, str):
                lm, rm = self.null_mask(name), other.null_mask(name)
                if lm is not None:
                    lkey_masks[name] = lm
                    lnull = NL.merge_masks(lnull, lm)
                if rm is not None:
                    rkey_masks[name] = rm
                    rnull = NL.merge_masks(rnull, rm)
            lk.append(lc)
            rk.append(rc)
        lflag, rflag = self._flag(), other._flag()
        if lflag is None and rflag is None and lnull is None and rnull is None:
            return lk, rk, key_dicts, lkey_masks, rkey_masks, False
        # per-side flag words: padding never equals anything (left 1, right
        # 2, valid 0); NULL keys never match either, not even each other
        # (SQL), and get their own values (left 3, right 4), kept apart from
        # padding so outer joins can still emit them unmatched
        lf = torch.zeros((self._n,), dtype=torch.int32, device=self._dev)
        if lnull is not None:
            lf = torch.where(lnull, 3, lf)
        if lflag is not None:
            lf = torch.where(lflag != 0, 1, lf)
        rf = torch.zeros((other._n,), dtype=torch.int32, device=self._dev)
        if rnull is not None:
            rf = torch.where(rnull, 4, rf)
        if rflag is not None:
            rf = torch.where(rflag != 0, 2, rf)
        return [lf, *lk], [rf, *rk], key_dicts, lkey_masks, rkey_masks, True

    def _payload(self, out_cols, dicts, matched, g, how_nulls, suffix=None, skip=()):
        """Gather this table's non-key columns to the output rows ``g``
        (zero where not ``matched``), with their null masks; unmatched cells
        are NULL when ``how_nulls``."""
        for name, c in self._cols.items():
            if name in skip or NL.is_mask_name(name):
                continue
            out_name = name + suffix if suffix is not None and name in out_cols else name
            out_cols[out_name] = _where(matched, Q._take(c, g))
            m = self.null_mask(name)
            if m is not None or how_nulls:
                src = m[g] if m is not None else torch.zeros_like(matched)
                out_cols[NL.mask_name(out_name)] = torch.where(matched, src, how_nulls)
            if name in self._dicts:
                dicts[out_name] = self._dicts[name]

    def join(self, other: "Table", on, *, capacity: int | None = None, how: str = "inner",
             suffix: str = "_r"):
        """Equi-join with ``other`` on the shared ``on`` column(s).

        Returns ``(Table, overflow)``. Result columns: the ``on`` keys, this
        table's other columns, and (inner/left/right/full) ``other``'s other
        columns, renamed with ``suffix`` on collision; semi/anti emit left
        columns only. Rows order by left row then right sorted position
        (right joins: by right row then left sorted position; full joins:
        the left-join rows, then the unmatched right rows); the other side's
        cells of an unmatched row are zero and NULL. ``capacity`` bounds the
        result (``overflow`` is True if the true result was larger; rows
        [0, count) are exact regardless); semi/anti/lookup default it to
        this table's rows. ``how="lookup"`` is the inner join of a
        key-unique ``other`` without the expansion; duplicate right keys
        fall back to the exact inner join."""
        if capacity is None:
            if how not in ("semi", "anti", "lookup"):
                raise TypeError(f"join(how={how!r}) needs an explicit capacity= (the static "
                                "result size bound); only semi/anti joins have a natural "
                                "default")
            capacity = self._n
        on = _as_list(on)
        lk, rk, key_dicts, lkey_masks, rkey_masks, flagged = self._join_keys(other, on)
        dev = self._dev
        if how == "lookup":
            return self._join_lookup(other, on, lk, rk, key_dicts, flagged, capacity, suffix)
        # both sides 1-based so 0 = "no row" works for every variant
        lidx1 = torch.arange(1, self._n + 1, dtype=torch.int32, device=dev)
        ridx1 = torch.arange(1, other._n + 1, dtype=torch.int32, device=dev)
        jk, jl, jr, cnt, ovf = Q.hash_join(lk, lidx1, rk, ridx1, capacity=capacity, how=how)
        jks = list(jk)
        pos = torch.arange(capacity, dtype=torch.int32, device=dev)
        valid = pos < cnt
        if flagged:
            fcol, jks = jks[0], jks[1:]
            if how in ("left", "anti", "right", "full"):
                # unmatched padding rows emit under these variants: drop
                # them. NULL-key rows (flags 3 / 4) are real rows that the
                # outer variants keep
                keep_f = fcol == 0
                if how in ("left", "anti", "full"):
                    keep_f = keep_f | (fcol == 3)
                if how in ("right", "full"):
                    keep_f = keep_f | (fcol == 4)
                *packed, cnt = Q.filter(valid & keep_f, *jks, jl, jr)
                jks, jl, jr = packed[:-2], packed[-2], packed[-1]
                valid = pos < cnt
        cols = dict(zip(on, jks))
        dicts = dict(key_dicts)
        matched_l = valid & (jl > 0)
        lg = (jl - 1).clamp(0, max(self._n - 1, 0))
        matched = valid & (jr > 0)
        rg = (jr - 1).clamp(0, max(other._n - 1, 0))
        for name in on:
            # a key cell is NULL iff its emitting row's key was NULL
            lm, rm = lkey_masks.get(name), rkey_masks.get(name)
            if lm is None and rm is None:
                continue
            r_null = rm[rg] & matched if rm is not None else torch.zeros_like(matched)
            cols[NL.mask_name(name)] = torch.where(
                matched_l, lm[lg] if lm is not None else False, r_null)
        # unmatched-left cells (right/full joins) and unmatched-right cells
        # (left/full joins) are SQL NULL
        self._payload(cols, dicts, matched_l, lg, how in ("right", "full"), skip=on)
        if how in ("inner", "left", "right", "full"):
            other._payload(cols, dicts, matched, rg, how in ("left", "full"), suffix, skip=on)
        return self._new(cols, cnt, dicts), ovf

    def _join_lookup(self, other, on, lk, rk, key_dicts, flagged, capacity, suffix):
        """``how="lookup"``: the output rows are the matched left rows in
        left order, each with its one right match, so every payload column
        (and its null mask) rides the lookup's one compaction."""

        def _side(t):
            vals, spec = [], []
            for n in t._cols:
                if n in on or NL.is_mask_name(n):
                    continue
                vals.append(t._cols[n])
                m = t.null_mask(n)
                spec.append((n, m is not None))
                if m is not None:
                    vals.append(m)
            return vals or [torch.zeros((t._n,), dtype=torch.int32, device=t._dev)], spec

        lvs, lspec = _side(self)
        rvs, rspec = _side(other)
        jk, jlv, jrv, cnt, ovf = Q.hash_join(lk, lvs, rk, rvs, capacity=capacity, how="lookup")
        jks = list(jk)[1:] if flagged else list(jk)  # NULL / padding keys never match
        cols = dict(zip(on, jks))
        dicts = dict(key_dicts)
        for t, spec, outs, sfx in ((self, lspec, jlv, None), (other, rspec, jrv, suffix)):
            i = 0
            for n, hm in spec:
                out_name = n + sfx if sfx is not None and n in cols else n
                cols[out_name] = outs[i]
                i += 1
                if hm:
                    cols[NL.mask_name(out_name)] = outs[i]
                    i += 1
                if n in t._dicts:
                    dicts[out_name] = t._dicts[n]
        return self._new(cols, cnt, dicts), ovf

    def join_band(self, other: "Table", left_on: str, op: str, right_on, *, on=None,
                  capacity: int | None = None, how: str = "inner", suffix: str = "_r"):
        """Non-equi (band / theta / interval) join with ``other``.

        Rows pair where the optional shared equality key(s) ``on`` match and
        ``self[left_on] op other[right_on]`` holds for ``op`` in "<", "<=",
        ">", ">=" (or lt/le/gt/ge), or for ``op="between"``
        ``other[lo] <= self[left_on] <= other[hi]`` with ``right_on=(lo,
        hi)``. Band columns are numeric or dates and share a dtype; NULL
        band values match nothing. Returns ``(Table, overflow)``: the ``on``
        keys once, this table's other columns, and (inner/left) ``other``'s
        other columns renamed with ``suffix`` on collision; rows by left row
        then right band order. ``capacity`` bounds the result (for
        "between" it must cover the candidate rows, see
        :func:`~radix_sort_tpu_torch.ops.query.band_join`); semi/anti
        default it to this table's rows. ``how``: inner / left / semi / anti
        for the inequalities, inner for "between"."""
        opn = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge"}.get(op, op)
        if opn not in Q.BAND_OPS:
            raise ValueError(f"op must be one of <, <=, >, >=, between (or lt/le/gt/ge), "
                             f"got {op!r}")
        if capacity is None:
            if how not in ("semi", "anti"):
                raise TypeError(f"join_band(how={how!r}) needs an explicit capacity= (the "
                                "static result size bound); only semi/anti joins have a "
                                "natural default")
            capacity = self._n
        on = _as_list(on)
        rb_names = list(right_on) if opn == "between" else [right_on]
        if opn == "between" and len(rb_names) != 2:
            raise ValueError('op="between" needs right_on=(lo_col, hi_col)')
        for nm, t in ((left_on, self), *((n, other) for n in rb_names)):
            if isinstance(nm, str) and nm in t._dicts:
                raise TypeError(f"band column {nm!r} is a string column — band predicates "
                                "need numeric/date columns")
        lb = self._resolve(left_on)[0]
        rbs = [other._resolve(nm)[0] for nm in rb_names]
        # NULL band values match nothing: fold them into the flag words
        lb_null = self.null_mask(left_on) if isinstance(left_on, str) else None
        rb_null = None
        for nm in rb_names:
            if isinstance(nm, str):
                rb_null = NL.merge_masks(rb_null, other.null_mask(nm))
        lk, rk, key_dicts, lkey_masks, _, flagged = self._join_keys(other, on, lb_null,
                                                                    rb_null)
        keys_l = lk[1:] if flagged else lk
        dev = self._dev
        lidx1 = torch.arange(1, self._n + 1, dtype=torch.int32, device=dev)
        ridx1 = torch.arange(1, other._n + 1, dtype=torch.int32, device=dev)
        jl, jr, cnt, ovf = Q.band_join(lb, lidx1, rbs if opn == "between" else rbs[0], ridx1,
                                       op=opn, capacity=capacity, how=how,
                                       left_equi=lk or None, right_equi=rk or None)
        pos = torch.arange(capacity, dtype=torch.int32, device=dev)
        valid = pos < cnt
        if flagged and how in ("left", "anti"):
            # these emit unmatched left rows: drop the padding ones, keep the
            # NULL-keyed real rows; every output row has a left source
            fcol = lk[0][(jl - 1).clamp(0, max(self._n - 1, 0))]
            jl, jr, cnt = Q.filter(valid & ((fcol == 0) | (fcol == 3)), jl, jr)
            valid = pos < cnt
        cols, dicts = {}, dict(key_dicts)
        matched_l = valid & (jl > 0)
        lg = (jl - 1).clamp(0, max(self._n - 1, 0))
        matched = valid & (jr > 0)
        rg = (jr - 1).clamp(0, max(other._n - 1, 0))
        # the shared equality keys once, from the left side
        for name, kc in zip(on, keys_l):
            cols[name] = _where(matched_l, Q._take(kc, lg))
            lm = lkey_masks.get(name)
            if lm is not None:
                cols[NL.mask_name(name)] = torch.where(matched_l, lm[lg], False)
        self._payload(cols, dicts, matched_l, lg, False, skip=on)
        if how in ("inner", "left"):
            other._payload(cols, dicts, matched, rg, how == "left", suffix, skip=on)
        return self._new(cols, cnt, dicts), ovf

    def cross_join(self, other: "Table", *, capacity: int | None = None, suffix: str = "_r"):
        """CROSS JOIN: every (left, right) pair of valid rows, ordered by
        left row then right row: the equi join on a constant key. Returns
        ``(Table, overflow)``; ``capacity`` defaults to ``num_rows *
        other.num_rows``."""
        if capacity is None:
            capacity = self._n * other._n
        name = "__cross_key__"
        while name in self._cols or name in other._cols:
            name += "_"
        zl = self.with_columns(**{name: torch.zeros((self._n,), dtype=torch.uint32)})
        zr = other.with_columns(**{name: torch.zeros((other._n,), dtype=torch.uint32)})
        out, ovf = zl.join(zr, name, capacity=capacity, how="inner", suffix=suffix)
        return out.drop(name), ovf

    def join_asof(self, other: "Table", on, *, direction: str = "backward", tolerance=None,
                  suffix: str = "_r", matched_col: str | None = None) -> "Table":
        """ASOF join (pandas ``merge_asof``): each valid row takes
        ``other``'s nearest valid row on the shared ``on`` column
        (``direction`` backward / forward / nearest; optional
        ``tolerance``). The result keeps this table's rows and count and
        adds ``other``'s non-key columns (``suffix`` on collision), zero
        where unmatched; ``matched_col`` adds the bool match column."""
        (lk,) = self._resolve([on])
        (rk,) = other._resolve([on])
        if isinstance(on, str) and ((on in self._dicts) != (on in other._dicts)):
            raise TypeError(f"asof key {on!r} is a string column on one side only")
        if isinstance(on, str) and on in self._dicts:
            _, ra, rb = S.unify(self._dicts[on], other._dicts[on])
            lk, rk = _remap(ra, lk), _remap(rb, rk)
        rvalid = None if other._count is None else other.valid_mask()
        rk_null = other.null_mask(on) if isinstance(on, str) else None
        if rk_null is not None:
            # NULL right keys are never match candidates
            rvalid = ~rk_null if rvalid is None else (rvalid & ~rk_null)
        lk_null = self.null_mask(on) if isinstance(on, str) else None
        ridx = torch.arange(other._n, dtype=torch.int32, device=self._dev)
        _, matched, rpos = R.join_asof(lk, rk, ridx, direction=direction, tolerance=tolerance,
                                       right_valid=rvalid)
        if self._count is not None:
            matched = matched & self.valid_mask()
        if lk_null is not None:
            matched = matched & ~lk_null  # NULL query keys never match
        rg = rpos.clamp(0, max(other._n - 1, 0))
        cols = dict(self._cols)
        dicts = dict(self._dicts)
        # matched rows inherit the source cell's nullness; unmatched stay 0
        # (matched_col tells them apart)
        other._payload(cols, dicts, matched, rg, False, suffix, skip=(on,))
        if matched_col is not None:
            cols[matched_col] = matched
        return self._new(cols, self._count, dicts)

    def _set_op(self, other: "Table", subset, want) -> "Table":
        names = _as_list(subset) or self.column_names
        a_cols, b_cols = self._resolve(names), other._resolve(names)
        out_dicts = {}
        for i, name in enumerate(names):
            if not isinstance(name, str):
                continue
            if (name in self._dicts) != (name in other._dicts):
                raise TypeError(f"set-op column {name!r} is a string column on one side only")
            if name in self._dicts:
                union, ra, rb = S.unify(self._dicts[name], other._dicts[name])
                a_cols[i], b_cols[i] = _remap(ra, a_cols[i]), _remap(rb, b_cols[i])
                out_dicts[name] = union
        # NULL rows equal NULL rows in set operators (SQL DISTINCT): a mask
        # word per nullable column
        a_keys, b_keys, has_mask = [], [], []
        for i, name in enumerate(names):
            am = self.null_mask(name) if isinstance(name, str) else None
            bm = other.null_mask(name) if isinstance(name, str) else None
            hm = am is not None or bm is not None
            if hm:
                a_keys.append(_word(am) if am is not None else torch.zeros(
                    (self._n,), dtype=torch.int32, device=self._dev))
                b_keys.append(_word(bm) if bm is not None else torch.zeros(
                    (other._n,), dtype=torch.int32, device=self._dev))
            has_mask.append(hm)
            a_keys.append(a_cols[i])
            b_keys.append(b_cols[i])
        keys_out, count = R._set_op(
            a_keys if len(a_keys) > 1 else a_keys[0], b_keys if len(b_keys) > 1 else b_keys[0],
            want, a_valid=None if self._count is None else self.valid_mask(),
            b_valid=None if other._count is None else other.valid_mask())
        kouts = list(keys_out) if isinstance(keys_out, (list, tuple)) else [keys_out]
        return self._new(self._key_table_cols(names, has_mask, kouts), count, out_dicts)

    def union(self, other: "Table", subset=None) -> "Table":
        """SQL ``UNION`` (distinct) over ``subset`` columns (default: all of
        this table's columns; both tables need them with matching dtypes).
        Padding rows on either side contribute nothing."""
        return self._set_op(other, subset, lambda ha, hb: ha | hb)

    def intersect(self, other: "Table", subset=None) -> "Table":
        """SQL ``INTERSECT``: distinct rows present in both tables."""
        return self._set_op(other, subset, lambda ha, hb: ha & hb)

    def difference(self, other: "Table", subset=None) -> "Table":
        """SQL ``EXCEPT``: distinct rows of this table absent from ``other``."""
        return self._set_op(other, subset, lambda ha, hb: ha & ~hb)

    def window(self, ops, *, partition_by=None, order_by=None, descending=None) -> "Table":
        """Add window-function columns: ``ops`` is a dict of output name ->
        spec per :func:`radix_sort_tpu_torch.window`, with column names in
        place of value tensors (e.g. ``{"rn": "row_number", "s": ("sum",
        "v"), "prev": ("lag", "v", 1)}``). ``descending`` flips ``order_by``
        (one bool, or one per order column). Padding rows sit in partitions
        of their own."""
        specs, out_dicts = [], {}
        mask_spec_of = {}  # out_name -> index of its parallel mask spec
        tail_specs = []    # the mask specs, after the real ones
        for out_name, spec in ops.items():
            if isinstance(spec, str):
                specs.append(spec)
                continue
            spec = list(spec)
            # value-less parameterized ops carry ints after the name
            if spec[0] not in ("ntile", "rolling_count", "range_count"):
                if isinstance(spec[1], str) and spec[1] in self._dicts:
                    if spec[0] in _VALUE_PRESERVING_WINDOW:
                        out_dicts[out_name] = self._dicts[spec[1]]
                    else:
                        self._no_string(spec[1], f"window op {spec[0]!r}")
                vmask = self._mask_of_ref(spec[1])
                spec[1] = self._resolve_masked([spec[1]])[0][0]
                if vmask is not None:
                    if spec[0] not in ("lag", "lead", "first_value", "last_value",
                                       "nth_value"):
                        raise TypeError(f"window op {spec[0]!r} over a NULLABLE value column "
                                        "is not supported (only the row-selection ops lag/"
                                        "lead/first_value/last_value/nth_value carry NULLs "
                                        "through); fill the NULLs first")
                    # the selection op on the mask itself gives the selected
                    # cell's nullness; out-of-window fills are NULL (fill=1)
                    mspec = [spec[0], vmask.to(torch.int32), *spec[2:]]
                    if spec[0] in ("lag", "lead", "nth_value"):
                        if len(mspec) == 2:
                            mspec.append(1)  # default offset / k
                        mspec = mspec[:3] + [1]  # fill = NULL
                    mask_spec_of[out_name] = len(ops) + len(tail_specs)
                    tail_specs.append(tuple(mspec))
            specs.append(tuple(spec))
        specs.extend(tail_specs)
        p_cols, _ = self._resolve_masked(partition_by)
        pmasks = [_word(self._mask_of_ref(c)) for c in _as_list(partition_by)
                  if self._mask_of_ref(c) is not None]
        if pmasks:
            p_cols = [*pmasks, *p_cols]  # NULL partition keys form one partition
        flag = self._flag()
        if flag is not None:
            p_cols = [flag, *p_cols]
        ob = _as_list(order_by)
        if any(self._mask_of_ref(c) is not None for c in ob):
            # a NULL word per nullable order column: NULL orders as +infinity
            desc_in = ([descending] * len(ob) if descending is None
                       or isinstance(descending, bool) else list(descending))
            o_cols, o_desc = [], []
            for c, d in zip(ob, desc_in):
                m = self._mask_of_ref(c)
                d = bool(d) if d is not None else False
                if m is not None:
                    o_cols.append(_word(m))
                    o_desc.append(d)
                o_cols.append(self._resolve_masked([c])[0][0])
                o_desc.append(d)
        else:
            o_cols, o_desc = self._resolve(ob), descending
        outs = W.window(specs, partition_by=p_cols or None, order_by=o_cols or None,
                        descending=o_desc)
        new_cols = dict(zip(ops, outs))
        for out_name, idx in mask_spec_of.items():
            new_cols[out_name] = NL.MaskedColumn(new_cols[out_name], outs[idx] != 0)
        res = self.with_columns(**new_cols)
        if out_dicts:
            res = self._new(res._cols, res._count, {**res._dicts, **out_dicts})
        return res

    def top_k(self, k: int, by, largest: bool = True) -> "Table":
        """The ``k`` rows with extreme ``by`` keys (ORDER BY ... LIMIT k),
        sorted by key (descending for ``largest``), ties by input position;
        every other column is co-selected. ``k`` beyond the row count
        clamps."""
        k = min(int(k), self._n)
        key_cols, by = self._resolve_masked(_as_list(by))
        keys_arg = []
        for name, c in zip(by, key_cols):
            m = self._mask_of_ref(name)
            if m is not None:
                # NULL keys behave as +infinity: first for largest
                keys_arg.append(_word(m))
            keys_arg.append(c)
        flag = self._flag()
        if flag is not None:
            # a leading indicator that makes the valid rows win either way
            keys_arg = [_word(self.valid_mask()) if largest else flag, *keys_arg]
        names = list(self._cols)
        out = SO.top_k(keys_arg if len(keys_arg) > 1 else keys_arg[0], k,
                       *[self._cols[n] for n in names], largest=largest)
        cnt = None if self._count is None else self._count.clamp(max=k)
        return self._new(dict(zip(names, out[1:])), cnt, self._dicts)

    def unnest(self, counts, total_size: int):
        """UNNEST / explode: valid row i emits ``counts[i]`` copies of every
        column, in row order, into ``total_size`` rows, in one launch of
        kernel K2 on the GPU. Returns ``(Table, overflow)``: ``overflow`` is
        True if the true expansion exceeds ``total_size`` (rows [0, count)
        exact regardless). Padding rows emit nothing."""
        (c,) = self._resolve([counts])
        if self._count is not None:
            c = _where(self.valid_mask(), c)
        outs, cnt, ovf = Q._expand_rows(list(self._cols.values()), c, total_size)
        return self._new(dict(zip(self._cols, outs)), cnt, self._dicts), ovf

    def limit(self, k: int, offset: int = 0) -> "Table":
        """Valid rows [offset, offset+k) (valid rows are a prefix, so OFFSET
        is a start shift)."""
        off = min(int(offset), self._n)
        k = max(0, min(int(k), self._n - off))
        cols = {n: c[off:off + k] for n, c in self._cols.items()}
        cnt = k if self._count is None else (self._count - off).clamp(0, k)
        return self._new(cols, cnt, self._dicts)

    def concat(self, other: "Table") -> "Table":
        """UNION ALL: this table's valid rows followed by ``other``'s (same
        column names and dtypes)."""
        if self.column_names != other.column_names:
            raise ValueError("concat needs identical column names")
        for n in self.column_names:
            if self._cols[n].dtype != other._cols[n].dtype:
                raise ValueError(f"column {n!r} dtypes differ")
            if (n in self._dicts) != (n in other._dicts):
                raise TypeError(f"column {n!r} is a string column on one side only")
        out_dicts, remapped = {}, {}
        for n in self._dicts:
            union, ra, rb = S.unify(self._dicts[n], other._dicts[n])
            remapped[n] = (_remap(ra, self._cols[n]), _remap(rb, other._cols[n]))
            out_dicts[n] = union
        cols = {}
        for n in self.column_names:
            cols[n] = _cat(remapped[n] if n in remapped else [self._cols[n], other._cols[n]])
            am, bm = self.null_mask(n), other.null_mask(n)
            if am is not None or bm is not None:
                # a side without a mask contributes all-non-null
                cols[NL.mask_name(n)] = torch.cat([
                    am if am is not None else torch.zeros((self._n,), dtype=torch.bool,
                                                          device=self._dev),
                    bm if bm is not None else torch.zeros((other._n,), dtype=torch.bool,
                                                          device=self._dev)])
        if self._count is None and other._count is None:
            return self._new(cols, None, out_dicts)
        # both sides are valid-prefix tables: slide other's prefix up against
        # ours (the reference's roll by ca - n_a, as a gather) and select by
        # position; tail rows past the combined count are arbitrary
        ca = self._count if self._count is not None else torch.tensor(
            self._n, dtype=torch.int32, device=self._dev)
        cb = other._count if other._count is not None else torch.tensor(
            other._n, dtype=torch.int32, device=self._dev)
        total = self._n + other._n
        pos = torch.arange(total, dtype=torch.int32, device=self._dev)
        src = torch.remainder(pos - (ca - self._n), total).to(torch.int64)
        head = pos < ca
        cols = {name: torch.where(head, Q._signed(c), Q._signed(Q._take(c, src))).view(c.dtype)
                for name, c in cols.items()}
        return self._new(cols, ca + cb, out_dicts)

    def quantiles(self, column, qs, *, method: str = "lower"):
        """Exact quantiles of a column's valid, non-NULL rows (see
        :func:`radix_sort_tpu_torch.quantiles`). With padding or NULLs
        present this sorts (excluded flag, value) and picks float32 ranks
        inside the kept prefix, as the reference does."""
        if isinstance(column, str) and column in self._dicts:
            raise TypeError(f"quantiles on string column {column!r}: quantiles of dictionary "
                            f"codes would be surprising — take them on t[{column!r}] and "
                            "decode(..) explicitly if intended")
        (col,) = self._resolve([column])
        m = self.null_mask(column) if isinstance(column, str) else None
        if self._count is None and m is None:
            return R.quantiles(col, qs, method=method)
        keep = self.valid_mask()
        if m is not None:
            keep = keep & ~m
        eff_count = keep.sum(dtype=torch.int32)
        limbs = K.encode_limbs(col)
        out = Q._stable_sort([_word(~keep), *limbs], num_keys=1 + len(limbs))
        svals = K.decode_limbs(out[1:], col.dtype)
        qs = [float(q) for q in qs]
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile points must be in [0, 1], got {q}")
        if method not in R.QUANTILE_METHODS:
            raise ValueError(f"method must be one of {R.QUANTILE_METHODS}, got {method!r}")
        x = torch.tensor(qs, dtype=torch.float32, device=self._dev) * (
            eff_count - 1).to(torch.float32)
        if method == "lower":
            r = torch.floor(x)
        elif method == "higher":
            r = torch.ceil(x)
        else:
            r = torch.floor(x + 0.5)
        idx = torch.minimum(r.to(torch.int32).clamp(min=0), (eff_count - 1).clamp(min=0))
        return Q._take(svals, idx.to(torch.int64))

    # ---- deferred execution ---------------------------------------------

    def lazy(self):
        """A :class:`~radix_sort_tpu_torch.plan.LazyTable` rooted at this
        table: record the pipeline as a logical plan, optimize
        (filter/sort/window fusion, sort+limit -> top_k, projection
        pruning), execute on ``collect()``."""
        from radix_sort_tpu_torch.plan import LazyTable, Source

        return LazyTable(Source(self))

    # ---- materialization ------------------------------------------------

    def to_numpy(self):
        """dict of numpy arrays holding only the valid rows (reads ``count``
        on the host). String columns decode through their dictionaries;
        nullable columns come back as ``np.ma.MaskedArray`` (mask True =
        NULL; the data under the mask is 0 / ``""``)."""
        n = self._n if self._count is None else int(self._count)
        out = {}
        for name, col in self._cols.items():
            if NL.is_mask_name(name):
                continue
            a = _np(col[:n])
            if name in self._dicts:
                a = S.decode(a, self._dicts[name])
            m = self.null_mask(name)
            if m is not None:
                a = np.ma.MaskedArray(a, mask=_np(m[:n]))
            out[name] = a
        return out
