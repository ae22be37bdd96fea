"""SQL frontend: compile a SQL SELECT into a :class:`LazyTable` plan.

Counterpart of ``radix_sort_tpu/sql.py``: the same grammar and plans, over
the port's ``Table``. Two things differ on purpose: an ASOF JOIN's ``ON``
keeps its qualifiers to decide which side each column names (an unqualified
name on both sides is an error), and renaming the right key onto a name the
right side already has is an error instead of a silent shadow.

``sql(query, tables)`` parses a practical SQL subset and compiles it onto
the lazy planner (plan.py), so every query rides the engine's optimizer
(filter fusion, ORDER BY+LIMIT -> top_k, projection pruning) and executes
as the same static-shape variadic-sort pipeline as the native API —
single-chip (``Table``) or MPP (``DistTable``) depending on what you
register. String literals compare against dictionary-encoded columns
through the string-aware expression layer (expr.py / strings.py).

Supported grammar::

    query := [WITH name AS ( query ) [, ...]]
             select [ (UNION [ALL] | INTERSECT | EXCEPT) select ]*
             [ORDER BY key [ASC|DESC] [NULLS FIRST|LAST], ...
              | ORDER BY ALL [ASC|DESC]]  -- every output column, L-to-R
             [LIMIT n [OFFSET m]]
             (INTERSECT binds tighter; engine set-op semantics: distinct
             rows matched by column NAME — both sides must expose the
             same column names; UNION ALL = concat. An ORDER BY key is a
             column or an expression; it may reference base / group-key
             columns the projection drops — except under DISTINCT or a
             set-op compound, where only output columns order)

    select := SELECT [DISTINCT] item [, item ...]
              FROM source
              [ [INNER|LEFT|RIGHT|FULL [OUTER]|SEMI|ANTI] JOIN source
                    (ON conj [AND conj ...] | USING (k, ...))
                | CROSS JOIN source
                | ASOF [LEFT] JOIN source ON a.t >= b.t ]*
    conj   := a.k1 = b.k2          -- differently-named keys rename the
                                   -- right side
            | a.x (< | <= | > | >=) b.y     -- at most ONE band conjunct:
            | a.x BETWEEN b.lo AND b.hi     -- a non-equi (band) join;
                                   -- INNER/LEFT/SEMI/ANTI (BETWEEN:
                                   -- INNER only), needs capacity=
                                   -- (DistTable left: a broadcast band
                                   -- join against a replicated Table
                                   -- right side, capacity_per_shard=)
             ASOF JOIN (timeseries nearest-key join, DuckDB syntax):
             exactly ONE inequality conjunct — ``l.t >= r.t`` matches
             each left row with the nearest right row at-or-before it
             (backward), ``l.t <= r.t`` the nearest at-or-after
             (forward); differently-named keys rename like equi joins.
             Qualifiers choose the sides (``ON b.t <= a.t`` is
             backward when ``b`` is the joined source); an unqualified
             name present on both sides is an error.
             Plain ASOF JOIN drops unmatched left rows (inner); ASOF
             LEFT JOIN keeps them with the right side's columns
             zero-filled (``Table.join_asof`` contract). No equality
             (by-key) conjuncts — partition first, or use
             ``Table.join_asof`` directly.
              [WHERE expr]
              [GROUP BY (factor [, ...] | ALL)] [HAVING expr]
                 -- GROUP BY ALL: every plain (non-aggregate) SELECT
                 -- item becomes a grouping key (DuckDB convenience)
            | ( query )

    factor := key | ROLLUP (key, ...) | CUBE (key, ...)
            | GROUPING SETS ( (key, ...) | key | () [, ...] )
             -- key is a column or expression; the query's grouping sets
             are the cross product of the factors (standard SQL): one
             aggregate per set, concatenated, with rolled-up keys as
             typed NULLs. GROUPING(key) in SELECT -> 0 grouped / 1
             rolled up

    source := name | ( query ) [[AS] alias]   -- derived-table subqueries;
             the planner namespace is flat, so the alias is decorative

    item  := * | expr [[AS] alias] | agg(expr) [[AS] alias]
           | winfn(args) OVER ([PARTITION BY cols] [ORDER BY col
             [ASC|DESC], ...] [ROWS frame]) [[AS] alias]
    agg   := SUM COUNT AVG MEAN MIN MAX MEDIAN MODE VAR VARIANCE STD
             STDDEV FIRST LAST ARGMIN ARGMAX BOOL_AND BOOL_OR
             COUNT(*) COUNT(DISTINCT x_or_expr)
             QUANTILE(x, q) / PERCENTILE_DISC(x, q): the group value at
             rank floor(q*(len-1)) — exact order statistic;
             PERCENTILE_CONT(x, q): linear interpolation between the
             bracketing order statistics (float64)
    winfn := ROW_NUMBER RANK DENSE_RANK PERCENT_RANK CUME_DIST NTILE(n)
             FIRST_VALUE(x) LAST_VALUE(x) NTH_VALUE(x, k)
             LAG(x[, off[, default]]) LEAD(x[, off[, default]])
             SUM MIN MAX AVG COUNT over partition/running/ROWS frames
    frame := [ROWS | RANGE] BETWEEN bound AND bound | bound (ROWS:
             ties break by input order; bound := UNBOUNDED PRECEDING |
             n PRECEDING | CURRENT ROW | n FOLLOWING | UNBOUNDED
             FOLLOWING. RANGE: bounds are ORDER BY value deltas — a
             number or a fixed-width INTERVAL n DAY|WEEK — over ONE
             ascending numeric/date order column; frame = rows with
             value in [cur-p, cur+f], peers included, for
             SUM/MIN/MAX/AVG/COUNT). Agg OVER with ORDER BY and no
             frame = running; without ORDER BY = whole partition.
             LAST_VALUE is always
             partition-wide (the useless SQL default running frame is
             deliberately not reproduced).

    HAVING may call aggregates inline (``HAVING COUNT(*) > 1``), and
    window functions compose with GROUP BY — evaluated over the
    aggregated rows after HAVING, with aggregate calls allowed in the
    OVER clause and as window arguments
    (``RANK() OVER (ORDER BY SUM(v) DESC)``). Such calls hoist into
    synthetic aggregate columns dropped by the final projection.
    expr  := literals ('s', 1, 2.5), columns, + - * / %,
             = != <> < <= > >=, AND OR NOT, [NOT] IN (literals),
             col [NOT] IN ( query ) — rewrites to a semi/anti join; only
             as a top-level AND conjunct of WHERE / HAVING,
             ( query ) as a scalar operand — one selected column, row 0
             broadcasts (e.g. WHERE v > (SELECT AVG(v) FROM t)),
             [NOT] BETWEEN a AND b, [NOT] LIKE 'pat' (% _ and \\ escapes,
             over dictionary string columns),
             scalar math: ABS FLOOR CEIL[ING] ROUND(x[, d]) SIGN SQRT EXP
             LN LOG LOG10 LOG2 POWER/POW(a, b) MOD(a, b)
             LEAST(a, b, ...) GREATEST(a, b, ...),
             dates (epoch-days int32 / epoch-us int64 storage, Arrow
             convention; datetime64 columns auto-encode): DATE 'Y-m-d'
             and TIMESTAMP literals, YEAR MONTH DAY DAYOFWEEK DAYOFYEAR
             WEEK QUARTER (and on timestamps HOUR MINUTE SECOND),
             EXTRACT(field FROM x) incl. MILLISECOND/MICROSECOND/EPOCH,
             DATE_TRUNC('year|quarter|month|week|day', x) plus
             'hour|minute|second' on timestamps,
             x +/- INTERVAL n DAY|WEEK|MONTH|YEAR (calendar-exact,
             month-end clamped) and sub-day HOUR|MINUTE|SECOND|
             MILLISECOND on timestamps, ADD_MONTHS(x, n) (keeps time of
             day on timestamps), MAKE_DATE(y, m, d),
             CASE WHEN c THEN a [WHEN ...] [ELSE b] END and the simple
             form CASE x WHEN v THEN a ... END
             (missing ELSE is NULL, per the standard),
             a IS [NOT] DISTINCT FROM b (null-safe equality),
             NULL handling (nulls.py masks; full three-valued logic):
             the NULL literal, x IS [NOT] NULL, COALESCE(a, b, ...),
             IFNULL(a, b), NULLIF(a, b); WHERE keeps known-TRUE rows;
             COUNT(x) counts non-NULL; SUM/AVG/MIN/MAX skip NULLs and
             are NULL for all-NULL groups; GROUP BY groups NULLs
             together; join keys never match on NULL; ORDER BY puts
             NULL last ascending / first descending (PostgreSQL)

Engine capacity knobs (static shapes) ride keyword arguments:
``sql(q, tables, capacity=..., max_groups=...)`` — join verbs receive the
join-ish knobs, aggregate/distinct theirs.

The reference crate is sort-only (src/radix_sort/mod.rs); a SQL surface
belongs to the north-star query-engine scope (BASELINE.json).
"""

from __future__ import annotations

import re

import torch

from radix_sort_tpu_torch.expr import Expr, col, lit, where

__all__ = ["sql", "SqlError"]


class SqlError(ValueError):
    """A SQL parse or compile error, with position context."""


_TOKEN_RE = re.compile(
    r"""\s*(?:
      (?P<num>\d+\.\d*|\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op>\|\||<=|>=|!=|<>|=|<|>|\(|\)|,|\*|\+|-|/|%|\.)
    )""",
    re.X,
)

_KEYWORDS = {
    "SELECT", "DISTINCT", "FROM", "WHERE", "GROUP", "BY", "HAVING",
    "ORDER", "LIMIT", "AS", "AND", "OR", "NOT", "IN", "BETWEEN", "ASC",
    "DESC", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "SEMI",
    "CROSS",
    "ANTI", "ON", "CASE", "WHEN", "THEN", "ELSE", "END", "IS", "NULL",
    "LIKE", "UNION", "ALL", "INTERSECT", "EXCEPT", "WITH", "USING",
    "OVER", "PARTITION", "ROWS", "PRECEDING", "FOLLOWING", "CURRENT",
    "ROW", "UNBOUNDED", "OFFSET", "EXISTS", "ASOF",
}

_AGG_FNS = {
    "SUM": "sum", "COUNT": "count", "AVG": "mean", "MEAN": "mean",
    "MIN": "min", "MAX": "max", "MEDIAN": "median", "MODE": "mode",
    "VAR": "var", "VARIANCE": "var", "STD": "std", "STDDEV": "std",
    "FIRST": "first", "LAST": "last", "ARGMIN": "argmin",
    "ARGMAX": "argmax", "BOOL_AND": "all", "BOOL_OR": "any",
}
# parameterized aggregates: QUANTILE(x, q) -> the engine's "quantile:<q>"
# (PERCENTILE_DISC semantics: the group value at rank floor(q*(len-1)))
_PARAM_AGG_FNS = {"QUANTILE", "PERCENTILE_DISC", "PERCENTILE_CONT"}

# single-argument scalar functions -> the Expr method computing them
_SCALAR_FNS = {
    "ABS": "abs", "FLOOR": "floor", "CEIL": "ceil", "CEILING": "ceil",
    "ROUND": "round", "SIGN": "sign", "SQRT": "sqrt", "EXP": "exp",
    "LN": "log", "LOG": "log", "LOG10": "log10", "LOG2": "log2",
}

# CAST target types
_CAST_TYPES = {
    "TINYINT": "int8", "SMALLINT": "int16", "INT": "int32",
    "INTEGER": "int32", "BIGINT": "int64",
    "UTINYINT": "uint8", "USMALLINT": "uint16", "UINT": "uint32",
    "UINTEGER": "uint32", "UBIGINT": "uint64",
    "FLOAT": "float32", "REAL": "float32", "DOUBLE": "float64",
    "BOOLEAN": "bool", "BOOL": "bool",
}

# date functions (operands are epoch-days ints; dates.py civil math)
_DATE_FNS = {
    "YEAR": "year", "MONTH": "month", "DAY": "day",
    "DAYOFWEEK": "dow", "DAYOFYEAR": "doy", "WEEK": "week",
    "QUARTER": "quarter", "HOUR": "hour", "MINUTE": "minute",
    "SECOND": "second",
}

# INTERVAL units -> ("day"|"us"|"month", multiplier)
_INTERVAL_UNITS = {
    "DAY": ("day", 1), "DAYS": ("day", 1),
    "WEEK": ("day", 7), "WEEKS": ("day", 7),
    "HOUR": ("us", 3_600_000_000), "HOURS": ("us", 3_600_000_000),
    "MINUTE": ("us", 60_000_000), "MINUTES": ("us", 60_000_000),
    "SECOND": ("us", 1_000_000), "SECONDS": ("us", 1_000_000),
    "MILLISECOND": ("us", 1_000), "MILLISECONDS": ("us", 1_000),
    "MONTH": ("month", 1), "MONTHS": ("month", 1),
    "YEAR": ("month", 12), "YEARS": ("month", 12),
}

# verb-specific capacity knobs routed from sql(**kwargs)
_JOIN_KNOBS = ("capacity", "capacity_per_shard", "exchange_capacity_factor")
_AGG_KNOBS = ("max_groups", "exchange_capacity_factor")
_DISTINCT_KNOBS = ("max_unique",)

# window functions: argument-less rank fns and single-value fns map 1:1
# onto the engine's op names (ops/window.py WINDOW_OPS)
_WIN_RANK_FNS = {
    "ROW_NUMBER": "row_number", "RANK": "rank",
    "DENSE_RANK": "dense_rank", "PERCENT_RANK": "percent_rank",
    "CUME_DIST": "cume_dist",
}
_WIN_VALUE_FNS = {"FIRST_VALUE": "first_value", "LAST_VALUE": "last_value"}
# aggregate OVER: (partition-wide op, running op, rolling op) — SQL
# semantics pick by ORDER BY / frame presence
_WIN_AGG_FNS = {
    "SUM": ("sum", "cumsum", "rolling_sum"),
    "MIN": ("min", "cummin", "rolling_min"),
    "MAX": ("max", "cummax", "rolling_max"),
    "AVG": ("mean", None, "rolling_mean"),
    "MEAN": ("mean", None, "rolling_mean"),
    "COUNT": ("count", "row_number", "rolling_count"),
}
_WIN_FNS = (set(_WIN_RANK_FNS) | set(_WIN_VALUE_FNS) | set(_WIN_AGG_FNS)
            | {"NTILE", "NTH_VALUE", "LAG", "LEAD"})


def _tokenize(q: str):
    toks, pos = [], 0
    while pos < len(q):
        m = _TOKEN_RE.match(q, pos)
        if not m or m.end() == m.start():
            if q[pos:].strip() == "":
                break
            raise SqlError(f"cannot tokenize SQL at: {q[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            text = m.group("num")
            toks.append(("num", float(text) if "." in text else int(text)))
        elif m.lastgroup == "str":
            toks.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "id":
            word = m.group("id")
            if word.upper() in _KEYWORDS:
                toks.append(("kw", word.upper()))
            else:
                toks.append(("id", word))
        else:
            toks.append(("op", m.group("op")))
    toks.append(("end", None))
    return toks


class _Parser:
    def __init__(self, q: str):
        self.q = q
        self.toks = _tokenize(q)
        self.i = 0
        # aggregate calls inside HAVING / OVER clauses are hoisted into
        # synthetic aggregate columns: spec tuple -> "__agg_<n>" (deduped),
        # computed alongside the SELECT aggregates and dropped by the final
        # projection. allow_aggs gates where such calls may appear.
        self.agg_sink = {}
        self.allow_aggs = False
        # expression arguments to aggregates / window value fns
        # (SUM(price * qty)) hoist into synthetic pre-aggregation columns:
        # repr(expr) -> ("__pre_<n>", expr), computed via with_columns
        # before the aggregate / window and dropped by the projection
        self.pre_sink = {}
        # IN (SELECT ...) subqueries rewrite to semi/anti joins: the
        # handler appends (how, column, LazyTable) here and returns a
        # lit(True) placeholder; only valid as a top-level AND conjunct
        # of WHERE / HAVING (subq_ok). sub_ctx = (tables, kwargs) of the
        # enclosing select, for compiling the nested query.
        self.pending_joins = []
        self.subq_ok = False
        self.sub_ctx = None
        # the table name and alias of the last FROM / JOIN target
        self.last_quals = set()
        # (pre-projection relation, final output names) stashed by the
        # LAST completed _select_core (None under DISTINCT): lets the
        # trailing ORDER BY reference base / group-key columns the
        # projection drops (standard SQL). _query reads and clears it;
        # set-operation compounds invalidate it.
        self.order_full = None

    # -- token plumbing -----------------------------------------------------

    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i = min(self.i + 1, len(self.toks) - 1)
        return t

    def at_kw(self, *kws):
        t = self.peek()
        return t[0] == "kw" and t[1] in kws

    def eat_kw(self, *kws):
        if self.at_kw(*kws):
            return self.next()[1]
        return None

    def expect_kw(self, kw):
        if not self.eat_kw(kw):
            raise SqlError(f"expected {kw} near {self.peek()[1]!r}")

    def at_op(self, *ops):
        t = self.peek()
        return t[0] == "op" and t[1] in ops

    def eat_op(self, *ops):
        if self.at_op(*ops):
            return self.next()[1]
        return None

    def expect_op(self, op):
        if not self.eat_op(op):
            raise SqlError(f"expected {op!r} near {self.peek()[1]!r}")

    def ident(self, what="identifier"):
        t = self.next()
        if t[0] != "id":
            raise SqlError(f"expected {what}, got {t[1]!r}")
        return t[1]

    # -- expressions ----------------------------------------------------------

    def parse_expr(self) -> Expr:
        return self._or()

    def _or(self):
        base = len(self.pending_joins)
        e = self._and()
        while self.eat_kw("OR"):
            if len(self.pending_joins) != base:
                raise SqlError(
                    "IN (SELECT ...) / EXISTS cannot appear under OR "
                    "(they rewrite to semi/anti joins, which have no "
                    "disjunctive form)"
                )
            saved, self.subq_ok = self.subq_ok, False
            try:
                rhs = self._and()
            finally:
                self.subq_ok = saved
            e = e | rhs
        return e

    def _and(self):
        e = self._not()
        while self.eat_kw("AND"):
            e = e & self._not()
        return e

    def _not(self):
        if self.at_kw("NOT") and self.peek(1) == ("kw", "EXISTS"):
            self.next()
            return self._exists(neg=True)
        if self.at_kw("EXISTS"):
            return self._exists(neg=False)
        if self.eat_kw("NOT"):
            saved, self.subq_ok = self.subq_ok, False
            try:
                return ~self._not()
            finally:
                self.subq_ok = saved
        return self._cmp()

    def _exists(self, neg):
        """``[NOT] EXISTS (SELECT ... FROM tbl [WHERE pred])`` -> a
        semi/anti join (the same rewrite as ``IN (SELECT ...)``).

        Correlated equality conjuncts — ``s.a = t.b`` with exactly one
        side in the subquery's schema, or a self-equality ``s.k = t.k``
        that the flat namespace parses as ``col(k) == col(k)`` — become
        the join keys; every other conjunct must read only subquery
        columns and filters it. With no correlation the rewrite is a
        constant-key semi/anti join: keep every outer row iff the
        subquery has any row. The subquery is restricted to a simple
        ``SELECT items FROM target [WHERE ...]`` (no GROUP BY tail —
        pre-aggregate in a CTE instead)."""
        self.expect_kw("EXISTS")
        if not self.subq_ok or self.sub_ctx is None:
            raise SqlError(
                "EXISTS is only supported as a top-level AND conjunct "
                "of WHERE or HAVING"
            )
        tables, kwargs = self.sub_ctx
        self.expect_op("(")
        self.expect_kw("SELECT")
        while True:  # the item list is irrelevant to EXISTS semantics
            if not self.eat_op("*"):
                self.parse_expr()
                self._alias()
            if not self.eat_op(","):
                break
        self.expect_kw("FROM")
        sub = _from_target(self, tables, kwargs)
        schema = set(sub.column_names)
        pairs, local = {}, None
        if self.eat_kw("WHERE"):
            for c in _conjuncts(self.parse_expr()):
                pr = _corr_pair(c, schema)
                if pr is not None:
                    pairs[pr] = True
                elif c.columns <= schema:
                    local = c if local is None else (local & c)
                else:
                    missing = sorted(c.columns - schema)
                    raise SqlError(
                        f"EXISTS subquery predicate reads {missing} "
                        f"outside its FROM table; correlated conjuncts "
                        f"must be equalities between one inner and one "
                        f"outer column"
                    )
        self.expect_op(")")
        if local is not None:
            sub = sub.filter(local)
        how = "anti" if neg else "semi"
        if not pairs:
            self.pending_joins.append((how, None, sub))
            return lit(True)
        inner = list(dict.fromkeys(a for a, _ in pairs))
        sub = sub.select(*inner)
        ren = {a: b for a, b in pairs if a != b}
        if ren:
            sub = sub.rename(ren)
        outer = tuple(dict.fromkeys(b for _, b in pairs))
        self.pending_joins.append((how, outer, sub))
        return lit(True)

    def _cmp(self):
        e = self._add()
        neg = bool(self.eat_kw("NOT"))
        if self.eat_kw("IN"):
            self.expect_op("(")
            if self.at_kw("SELECT", "WITH") or self.at_op("("):
                # IN (SELECT ...) -> semi join; NOT IN -> anti join
                if not self.subq_ok or self.sub_ctx is None:
                    raise SqlError(
                        "IN (SELECT ...) is only supported as a top-level "
                        "AND conjunct of WHERE or HAVING"
                    )
                if e.kind != "col":
                    raise SqlError(
                        "IN (SELECT ...) needs a plain column on the left"
                    )
                tables, kwargs = self.sub_ctx
                sub = _query(self, tables, kwargs)
                self.expect_op(")")
                names = list(sub.column_names)
                if len(names) != 1:
                    raise SqlError(
                        f"an IN subquery must select exactly one column, "
                        f"got {names}"
                    )
                if names[0] != e.args[0]:
                    sub = sub.rename({names[0]: e.args[0]})
                self.pending_joins.append(
                    ("anti" if neg else "semi", e.args[0], sub)
                )
                return lit(True)
            vals = [self._literal()]
            while self.eat_op(","):
                vals.append(self._literal())
            self.expect_op(")")
            out = e.isin(vals)
            return ~out if neg else out
        if self.eat_kw("BETWEEN"):
            lo = self._add()
            self.expect_kw("AND")
            hi = self._add()
            out = (e >= lo) & (e <= hi)
            return ~out if neg else out
        if self.eat_kw("LIKE"):
            t = self.next()
            if t[0] != "str":
                raise SqlError(
                    f"LIKE needs a string literal pattern, got {t[1]!r}"
                )
            out = e.like(t[1])
            return ~out if neg else out
        if self.eat_kw("IS"):
            not_ = self.eat_kw("NOT")
            if self.eat_kw("DISTINCT"):
                # null-safe equality: never NULL — NULLs compare equal
                self.expect_kw("FROM")
                b = self._add()
                an, bn = e.is_null(), b.is_null()
                same = where(an | bn, an & bn, e == b)
                out = same if not_ else ~same
                return ~out if neg else out
            self.expect_kw("NULL")
            out = e.is_not_null() if not_ else e.is_null()
            return ~out if neg else out
        if neg:
            raise SqlError("NOT must precede IN, BETWEEN or LIKE here")
        op = self.eat_op("=", "!=", "<>", "<=", ">=", "<", ">")
        if op is None:
            return e
        rhs = self._add()
        return {
            "=": lambda a, b: a == b,
            "!=": lambda a, b: a != b,
            "<>": lambda a, b: a != b,
            "<": lambda a, b: a < b,
            "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b,
            ">=": lambda a, b: a >= b,
        }[op](e, rhs)

    def _literal(self):
        t = self.next()
        if t[0] in ("num", "str"):
            return t[1]
        raise SqlError(f"expected a literal, got {t[1]!r}")

    def _str1(self, build):
        """One-argument string-function tail: ``expr )``."""
        e = self.parse_expr()
        self.expect_op(")")
        return build(e)

    def _str_param(self, what):
        t = self.next()
        if t[0] != "str":
            raise SqlError(f"{what} must be a string literal, got "
                           f"{t[1]!r}")
        return t[1]

    def _int_param(self, what):
        neg = bool(self.eat_op("-"))
        t = self.next()
        if t[0] != "num" or not isinstance(t[1], int):
            raise SqlError(f"{what} must be an integer literal, got "
                           f"{t[1]!r}")
        return -t[1] if neg else t[1]

    def _interval(self, what):
        """``INTERVAL n unit`` / ``INTERVAL 'n' unit`` after +/- ->
        ``(days, months)`` with exactly one non-zero."""
        self.next()  # INTERVAL
        t = self.next()
        if t[0] == "num" and isinstance(t[1], int):
            n = t[1]
        elif t[0] == "str":
            try:
                n = int(t[1])
            except ValueError:
                raise SqlError(
                    f"INTERVAL quantity must be an integer, got "
                    f"{t[1]!r}") from None
        else:
            raise SqlError(
                f"INTERVAL quantity must be an integer, got {t[1]!r}")
        u = self.next()
        unit = str(u[1]).upper() if u[0] in ("id", "kw") else ""
        if unit not in _INTERVAL_UNITS:
            raise SqlError(
                f"unknown INTERVAL unit {u[1]!r} (supported: "
                f"{', '.join(sorted(set(_INTERVAL_UNITS)))})"
            )
        kind, mult = _INTERVAL_UNITS[unit]
        if kind == "month":
            return 0, n * mult, 0
        if kind == "us":
            return 0, 0, n * mult
        return n * mult, 0, 0

    def _add(self):
        e = self._mul()
        while True:
            op = self.eat_op("+", "-", "||")
            if op is None:
                return e
            if op == "||":
                from radix_sort_tpu_torch.expr import concat
                e = concat(e, self._mul())
            elif (self.peek()[0] == "id"
                  and str(self.peek()[1]).upper() == "INTERVAL"):
                days, months, us = self._interval(op)
                sign = 1 if op == "+" else -1
                if months:
                    e = e.add_months(sign * months)
                else:
                    # dtype-resolved at evaluation: DATE columns take
                    # days, TIMESTAMP columns days+us
                    e = Expr("datefn", ("add_time", e,
                                        (sign * days, sign * us)))
            else:
                e = e + self._mul() if op == "+" else e - self._mul()

    def _mul(self):
        e = self._unary()
        while True:
            op = self.eat_op("*", "/", "%")
            if op is None:
                return e
            rhs = self._unary()
            e = (e * rhs if op == "*"
                 else e / rhs if op == "/" else e % rhs)

    def _unary(self):
        if self.eat_op("-"):
            return -self._unary()
        return self._primary()

    def _primary(self):
        t = self.peek()
        if t[0] == "num" or t[0] == "str":
            self.next()
            return lit(t[1])
        if self.eat_op("("):
            if self.at_kw("SELECT", "WITH"):
                # a scalar subquery: (SELECT AVG(v) FROM t) — must yield
                # one column; row 0 of its collected result broadcasts as
                # a scalar operand (single-row by construction for global
                # aggregates; extra rows are ignored like SQL's LIMIT 1)
                if self.sub_ctx is None:
                    raise SqlError(
                        "scalar subqueries are only supported inside a "
                        "query's WHERE / HAVING / SELECT expressions"
                    )
                tables, kwargs = self.sub_ctx
                sub = _query(self, tables, kwargs)
                self.expect_op(")")
                names = list(sub.column_names)
                if len(names) != 1:
                    raise SqlError(
                        f"a scalar subquery must select exactly one "
                        f"column, got {names}"
                    )
                from radix_sort_tpu_torch.expr import udf
                cname = names[0]
                return udf(
                    lambda _sub=sub, _c=cname: _sub.collect()[_c][0],
                    columns=[],
                    label=f"scalar_subquery({cname})",
                )
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if self.at_kw("CASE"):
            return self._case()
        if self.eat_kw("NULL"):
            from radix_sort_tpu_torch.expr import null
            return null()
        if (t[0] == "kw" and t[1] in ("LEFT", "RIGHT")
                and self.peek(1) == ("op", "(")):
            # LEFT/RIGHT are join keywords; as callables they are the
            # string functions
            self.next()
            return self._call(t[1])
        if (t[0] == "id" and str(t[1]).upper() in ("DATE", "TIMESTAMP")
                and self.peek(1)[0] == "str"):
            # DATE '2026-08-20' -> epoch days (int32); TIMESTAMP
            # 'Y-m-d H:M:S[.f]' -> epoch microseconds (int64; x64)
            from radix_sort_tpu_torch import dates as D

            kindw = str(self.next()[1]).upper()
            s = self.next()[1]
            try:
                return lit(D.parse_date(s) if kindw == "DATE"
                           else D.parse_timestamp(s))
            except ValueError as err:
                raise SqlError(f"bad {kindw} literal {s!r}: "
                               f"{err}") from None
        if t[0] == "id":
            name = self.ident()
            if self.at_op("."):
                # qualified name: the planner has one merged namespace;
                # resolve to the bare column (join suffixes rename
                # collisions — address those by the suffixed name)
                self.next()
                name = self.ident("column after '.'")
            if self.at_op("("):
                return self._call(name)
            return col(name)
        raise SqlError(f"unexpected token {t[1]!r} in expression")

    def _call(self, name) -> Expr:
        fn = name.upper()
        self.expect_op("(")
        if fn in _SCALAR_FNS:
            e = self.parse_expr()
            if fn == "ROUND" and self.eat_op(","):
                # ROUND(x, d): scale, round, unscale (d static non-negative)
                t = self.next()
                if t[0] != "num" or not isinstance(t[1], int) or t[1] < 0:
                    raise SqlError(
                        f"ROUND digits must be a non-negative integer, "
                        f"got {t[1]!r}"
                    )
                self.expect_op(")")
                s = float(10 ** t[1])
                return (e * s).round() / s
            self.expect_op(")")
            return getattr(e, _SCALAR_FNS[fn])()
        if fn in ("POWER", "POW", "MOD"):
            a = self.parse_expr()
            self.expect_op(",")
            b = self.parse_expr()
            self.expect_op(")")
            return a.pow(b) if fn != "MOD" else a % b
        if fn in ("LEAST", "GREATEST"):
            args = [self.parse_expr()]
            while self.eat_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            if len(args) < 2:
                raise SqlError(f"{fn} needs at least two arguments")
            out = args[0]
            for a in args[1:]:
                out = out.minimum(a) if fn == "LEAST" else out.maximum(a)
            return out
        if fn in ("COALESCE", "IFNULL"):
            from radix_sort_tpu_torch.expr import coalesce
            args = [self.parse_expr()]
            while self.eat_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            if len(args) < 2:
                raise SqlError(f"{fn} needs at least two arguments")
            return coalesce(*args)
        if fn == "NULLIF":
            from radix_sort_tpu_torch.expr import nullif
            a = self.parse_expr()
            self.expect_op(",")
            b = self.parse_expr()
            self.expect_op(")")
            return nullif(a, b)
        if fn in ("CAST", "TRY_CAST"):
            e = self.parse_expr()
            self.expect_kw("AS")
            t = self.next()
            if t[0] not in ("id", "kw"):
                raise SqlError(f"expected a type name after AS, got "
                               f"{t[1]!r}")
            tname = str(t[1]).upper()
            if tname == "DOUBLE" and self.peek()[0] == "id" and \
                    str(self.peek()[1]).upper() == "PRECISION":
                self.next()
            if tname not in _CAST_TYPES:
                raise SqlError(
                    f"unknown CAST type {tname!r} (supported: "
                    f"{', '.join(sorted(_CAST_TYPES))})"
                )
            self.expect_op(")")
            return e.cast(_CAST_TYPES[tname])
        if fn in ("UPPER", "UCASE"):
            return self._str1(lambda e: e.upper())
        if fn in ("LOWER", "LCASE"):
            return self._str1(lambda e: e.lower())
        if fn == "REVERSE":
            return self._str1(lambda e: e.reverse())
        if fn in ("LENGTH", "LEN", "CHAR_LENGTH", "CHARACTER_LENGTH"):
            return self._str1(lambda e: e.length())
        if fn in ("TRIM", "LTRIM", "RTRIM"):
            e = self.parse_expr()
            chars = " "
            if self.eat_op(","):
                chars = self._str_param(f"{fn} characters")
            self.expect_op(")")
            m = {"TRIM": "trim", "LTRIM": "ltrim", "RTRIM": "rtrim"}[fn]
            return getattr(e, m)(chars)
        if fn in ("SUBSTR", "SUBSTRING"):
            e = self.parse_expr()
            self.expect_op(",")
            start = self._int_param("SUBSTR start")
            length = None
            if self.eat_op(","):
                length = self._int_param("SUBSTR length")
            self.expect_op(")")
            return e.substr(start, length)
        if fn == "REPLACE":
            e = self.parse_expr()
            self.expect_op(",")
            old = self._str_param("REPLACE search string")
            self.expect_op(",")
            new = self._str_param("REPLACE replacement")
            self.expect_op(")")
            return e.replace(old, new)
        if fn in ("LEFT", "RIGHT"):
            e = self.parse_expr()
            self.expect_op(",")
            n = self._int_param(f"{fn} count")
            self.expect_op(")")
            return e.left(n) if fn == "LEFT" else e.right(n)
        if fn in ("LPAD", "RPAD"):
            e = self.parse_expr()
            self.expect_op(",")
            width = self._int_param(f"{fn} width")
            fill = " "
            if self.eat_op(","):
                fill = self._str_param(f"{fn} fill")
            self.expect_op(")")
            return e.lpad(width, fill) if fn == "LPAD" else \
                e.rpad(width, fill)
        if fn in ("STRPOS", "INSTR"):
            e = self.parse_expr()
            self.expect_op(",")
            sub = self._str_param(f"{fn} search string")
            self.expect_op(")")
            return e.strpos(sub)
        if fn in ("STARTS_WITH", "ENDS_WITH", "CONTAINS"):
            e = self.parse_expr()
            self.expect_op(",")
            s = self._str_param(f"{fn} string")
            self.expect_op(")")
            m = {"STARTS_WITH": "starts_with", "ENDS_WITH": "ends_with",
                 "CONTAINS": "contains"}[fn]
            return getattr(e, m)(s)
        if fn == "EXTRACT":
            # EXTRACT(field FROM expr) over epoch-days date columns
            from radix_sort_tpu_torch import dates as D

            t = self.next()
            field = str(t[1]).upper() if t[0] in ("id", "kw") else ""
            if field not in D.EXTRACT_FIELDS:
                raise SqlError(
                    f"unknown EXTRACT field {t[1]!r} (supported: "
                    f"{', '.join(sorted(D.EXTRACT_FIELDS))})"
                )
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect_op(")")
            return e._datefn(D.EXTRACT_FIELDS[field])
        if fn in _DATE_FNS:
            e = self.parse_expr()
            self.expect_op(")")
            return e._datefn(_DATE_FNS[fn])
        if fn == "DATE_TRUNC":
            from radix_sort_tpu_torch import dates as D

            unit = self._str_param("DATE_TRUNC unit").lower()
            if unit not in D.TRUNC_UNITS:
                raise SqlError(
                    f"unknown DATE_TRUNC unit {unit!r} (supported: "
                    f"{', '.join(D.TRUNC_UNITS)})"
                )
            self.expect_op(",")
            e = self.parse_expr()
            self.expect_op(")")
            return e.date_trunc(unit)
        if fn == "ADD_MONTHS":
            e = self.parse_expr()
            self.expect_op(",")
            n = self._int_param("ADD_MONTHS count")
            self.expect_op(")")
            return e.add_months(n)
        if fn == "MAKE_DATE":
            from radix_sort_tpu_torch import dates as D

            y = self._int_param("MAKE_DATE year")
            self.expect_op(",")
            m = self._int_param("MAKE_DATE month")
            self.expect_op(",")
            d = self._int_param("MAKE_DATE day")
            self.expect_op(")")
            try:
                return lit(D.parse_date(f"{y:04d}-{m:02d}-{d:02d}"))
            except ValueError as err:
                raise SqlError(f"MAKE_DATE: {err}") from None
        if fn == "GROUPING":
            # SQL GROUPING(key): 0 when this row's grouping set includes
            # the key, 1 when the key is rolled up. Parsed as a marker
            # node; _select_core routes it to aggregate_sets
            e = self.parse_expr()
            self.expect_op(")")
            if e.kind != "col":
                raise SqlError("GROUPING takes a single column name")
            return Expr("grouping", (e.args[0],))
        if fn == "CONCAT":
            from radix_sort_tpu_torch.expr import concat
            args = [self.parse_expr()]
            while self.eat_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return concat(*args)
        if fn in _AGG_FNS or fn in _PARAM_AGG_FNS:
            if self.allow_aggs:
                agg, argname = self._agg_args(fn)
                return col(self._sink(agg, argname))
            raise SqlError(
                f"aggregate {fn} is only allowed as a top-level SELECT "
                f"item or inside HAVING / OVER clauses, not in this "
                f"expression"
            )
        if fn in _WIN_FNS:
            raise SqlError(
                f"window function {fn} is only allowed as a top-level "
                f"SELECT item (optionally aliased), not inside an "
                f"expression"
            )
        raise SqlError(f"unknown function {name!r}")

    def _agg_args(self, fname):
        """Parse an aggregate call's argument list (the ``(`` is already
        consumed) through the ``)``; returns ``(engine_agg, argname)`` with
        ``argname None`` for COUNT(*)."""
        if fname in _PARAM_AGG_FNS:
            saved, self.allow_aggs = self.allow_aggs, False
            try:
                e = self.parse_expr()
            finally:
                self.allow_aggs = saved
            self.expect_op(",")
            q = self.next()
            if q[0] != "num" or not 0 <= q[1] <= 1:
                raise SqlError(
                    f"{fname} takes (column_or_expr, q) with q in [0, 1]"
                )
            self.expect_op(")")
            name = e.args[0] if e.kind == "col" else self._pre(e)
            pre = ("quantile_cont" if fname == "PERCENTILE_CONT"
                   else "quantile")
            return f"{pre}:{float(q[1])}", name
        agg = _AGG_FNS[fname]
        if self.eat_op("*"):
            if fname != "COUNT":
                raise SqlError(f"{fname}(*) is not supported; name a column")
            self.expect_op(")")
            return agg, None
        if self.eat_kw("DISTINCT"):
            if fname != "COUNT":
                raise SqlError("DISTINCT only inside COUNT(...)")
            saved = (self.allow_aggs, self.subq_ok)
            self.allow_aggs = self.subq_ok = False
            try:
                e = self.parse_expr()
            finally:
                self.allow_aggs, self.subq_ok = saved
            self.expect_op(")")
            name = e.args[0] if e.kind == "col" else self._pre(e)
            return "count_distinct", name
        saved = (self.allow_aggs, self.subq_ok)  # no nested aggs/subqueries
        self.allow_aggs = self.subq_ok = False
        try:
            e = self.parse_expr()
        finally:
            self.allow_aggs, self.subq_ok = saved
        self.expect_op(")")
        name = e.args[0] if e.kind == "col" else self._pre(e)
        return agg, name

    def _sink(self, agg, argname):
        """Register a hoisted aggregate (HAVING / OVER) and return its
        synthetic post-aggregation column name (deduped by spec)."""
        spec = (agg,) if argname is None else (agg, argname)
        if spec not in self.agg_sink:
            self.agg_sink[spec] = f"__agg_{len(self.agg_sink)}"
        return self.agg_sink[spec]

    def _pre(self, e):
        """Register a hoisted pre-aggregation expression argument and
        return its synthetic column name (deduped by printed form)."""
        key = repr(e)
        if key not in self.pre_sink:
            self.pre_sink[key] = (f"__pre_{len(self.pre_sink)}", e)
        return self.pre_sink[key][0]

    def _case(self) -> Expr:
        saved, self.subq_ok = self.subq_ok, False
        try:
            return self._case_inner()
        finally:
            self.subq_ok = saved

    def _case_inner(self) -> Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            # simple CASE: CASE x WHEN v THEN r ... — each arm compares
            # the operand for equality
            operand = self.parse_expr()
        arms = []
        while self.eat_kw("WHEN"):
            c = self.parse_expr()
            if operand is not None:
                c = operand == c
            self.expect_kw("THEN")
            v = self.parse_expr()
            arms.append((c, v))
        if not arms:
            raise SqlError("CASE needs at least one WHEN arm")
        if self.eat_kw("ELSE"):
            default = self.parse_expr()
        else:
            from radix_sort_tpu_torch.expr import null
            default = null()  # SQL: missing ELSE is NULL
        self.expect_kw("END")
        out = default
        for c, v in reversed(arms):
            out = where(c, v, out)
        return out

    # -- select items ---------------------------------------------------------

    def parse_item(self):
        """One SELECT item -> ("star",) | ("agg", agg, arg_col, alias)
        | ("win", spec, partition, order, desc, alias)
        | ("expr", Expr, alias)."""
        if self.eat_op("*"):
            return ("star",)
        t = self.peek()
        if (t[0] == "id"
                and (t[1].upper() in _AGG_FNS
                     or t[1].upper() in _PARAM_AGG_FNS
                     or t[1].upper() in _WIN_FNS)
                and self.peek(1) == ("op", "(")):
            return self._call_item()
        e = self.parse_expr()
        alias = self._alias()
        if alias is None:
            if e.kind == "col":
                alias = e.args[0]
            else:
                raise SqlError(
                    f"computed SELECT item needs an alias (AS name): {e!r}"
                )
        return ("expr", e, alias)

    def _call_item(self):
        """A top-level call item: ``fn(args...)`` — an aggregate, or a
        window function when followed by ``OVER (...)``."""
        fname = self.next()[1].upper()
        self.expect_op("(")
        star = False
        distinct_arg = False
        hoisted_arg = False
        args = []  # ("col", name) | ("num", v) | ("str", v)
        if self.eat_op("*"):
            star = True
        elif not self.at_op(")"):
            if self.eat_kw("DISTINCT"):
                distinct_arg = True
            while True:
                t = self.peek()
                if (t[0] == "id"
                        and (t[1].upper() in _AGG_FNS
                             or t[1].upper() in _PARAM_AGG_FNS)
                        and self.peek(1) == ("op", "(")):
                    # an aggregate as a window-fn argument, e.g.
                    # LAG(SUM(v)) OVER (...): hoist it (rejected below if
                    # this item turns out to be a plain aggregate)
                    inner = self.next()[1].upper()
                    self.expect_op("(")
                    args.append(("col", self._sink(*self._agg_args(inner))))
                    hoisted_arg = True
                else:
                    # a full expression argument: plain columns and
                    # literals classify back to their simple forms;
                    # anything else (SUM(price * qty)) becomes an
                    # ("expr", Expr) hoisted by the consumer
                    e = self.parse_expr()
                    if e.kind == "col":
                        args.append(("col", e.args[0]))
                    elif e.kind == "lit":
                        v = e.args[0]
                        args.append(
                            ("str" if isinstance(v, (str, bytes)) else
                             "num", v)
                        )
                    elif (e.kind == "un" and e.args[0] == "neg"
                          and e.args[1].kind == "lit"):
                        args.append(("num", -e.args[1].args[0]))
                    else:
                        args.append(("expr", e))
                if not self.eat_op(","):
                    break
        self.expect_op(")")

        if self.at_kw("OVER"):
            if distinct_arg:
                raise SqlError(
                    "DISTINCT is not supported inside window functions"
                )
            if fname in _PARAM_AGG_FNS:
                raise SqlError(f"{fname} is not a window function")
            return self._window_item(fname, star, args)

        if fname not in _AGG_FNS and fname not in _PARAM_AGG_FNS:
            raise SqlError(
                f"window function {fname} needs an OVER (...) clause"
            )
        if hoisted_arg:
            raise SqlError(f"nested aggregates are not supported: "
                           f"{fname}(agg(...))")
        if fname in _PARAM_AGG_FNS:
            if (star or distinct_arg or len(args) != 2
                    or args[0][0] not in ("col", "expr")
                    or args[1][0] != "num" or not 0 <= args[1][1] <= 1):
                raise SqlError(
                    f"{fname} takes (column_or_expr, q) with q in [0, 1]"
                )
            pre = ("quantile_cont" if fname == "PERCENTILE_CONT"
                   else "quantile")
            agg = f"{pre}:{float(args[1][1])}"
            if args[0][0] == "expr":
                argname, expr_arg = self._pre(args[0][1]), True
            else:
                argname, expr_arg = args[0][1], False
            alias = self._alias()
            if alias is None:
                if expr_arg:
                    raise SqlError(
                        f"{fname}(<expression>, q) needs an alias (AS name)"
                    )
                alias = f"quantile_{argname}"
            return ("agg", agg, argname, alias)
        agg = _AGG_FNS[fname]
        argname = None
        expr_arg = False
        if star:
            if fname != "COUNT":
                raise SqlError(f"{fname}(*) is not supported; name a column")
        else:
            if distinct_arg:
                if fname != "COUNT":
                    raise SqlError("DISTINCT only inside COUNT(...)")
                agg = "count_distinct"
            if len(args) != 1 or args[0][0] not in ("col", "expr"):
                raise SqlError(
                    f"aggregate {fname} takes exactly one column or "
                    f"expression argument"
                )
            if args[0][0] == "expr":
                argname = self._pre(args[0][1])
                expr_arg = True
            else:
                argname = args[0][1]
        if self.at_op("+", "-", "*", "/", "%",
                      "=", "!=", "<>", "<", "<=", ">", ">="):
            raise SqlError(
                f"aggregate {fname} is only allowed as a top-level "
                f"SELECT item (optionally aliased), not inside an "
                f"expression"
            )
        alias = self._alias()
        if alias is None:
            if expr_arg:
                raise SqlError(
                    f"{fname}(<expression>) needs an alias (AS name)"
                )
            alias = agg if argname is None else f"{agg}_{argname}"
        return ("agg", agg, argname, alias)

    def _qualified_ident(self, what):
        return self._qualified_ref(what)[1]

    def _qualified_ref(self, what):
        """``(qualifier or None, column)`` of a possibly qualified name."""
        name = self.ident(what)
        if self.at_op("."):
            self.next()
            return name, self.ident("column after '.'")
        return None, name

    def _win_col(self, what):
        """A column reference inside an OVER clause: a plain (qualified)
        identifier, or an aggregate call — ``OVER (ORDER BY SUM(v))`` —
        hoisted into a synthetic aggregate column."""
        t = self.peek()
        if (t[0] == "id"
                and (t[1].upper() in _AGG_FNS
                     or t[1].upper() in _PARAM_AGG_FNS)
                and self.peek(1) == ("op", "(")):
            fname = self.next()[1].upper()
            self.expect_op("(")
            return self._sink(*self._agg_args(fname))
        return self._qualified_ident(what)

    def _window_item(self, fname, star, args):
        """``fn(args) OVER ([PARTITION BY ...] [ORDER BY ...] [ROWS ...])``
        -> ("win", engine_spec, partition, order, desc, alias)."""
        self.expect_kw("OVER")
        self.expect_op("(")
        partition, order, desc = [], [], []
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            while True:
                partition.append(self._win_col("partition column"))
                if not self.eat_op(","):
                    break
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                order.append(self._win_col("order column"))
                d = self.eat_kw("ASC", "DESC")
                desc.append(d == "DESC")
                if not self.eat_op(","):
                    break
        frame = None
        if self.eat_kw("ROWS"):
            frame = self._parse_frame()
        elif (self.peek()[0] == "id"
                and str(self.peek()[1]).upper() == "RANGE"):
            self.next()
            frame = self._parse_range_frame()
        self.expect_op(")")
        spec = self._window_spec(fname, star, args, bool(order), frame)
        if self.at_op("+", "-", "*", "/", "%",
                      "=", "!=", "<>", "<", "<=", ">", ">="):
            raise SqlError(
                f"window function {fname} is only allowed as a top-level "
                f"SELECT item (optionally aliased), not inside an "
                f"expression"
            )
        alias = self._alias()
        if alias is None:
            name = spec if isinstance(spec, str) else spec[0]
            arg = (spec[1] if not isinstance(spec, str) and len(spec) > 1
                   and isinstance(spec[1], str) else None)
            alias = name if arg is None else f"{name}_{arg}"
        return ("win", spec, tuple(partition), tuple(order), tuple(desc),
                alias)

    def _frame_bound(self):
        if self.eat_kw("UNBOUNDED"):
            which = self.eat_kw("PRECEDING", "FOLLOWING")
            if which is None:
                raise SqlError(
                    "expected PRECEDING or FOLLOWING after UNBOUNDED"
                )
            return ("unbounded", which)
        if self.eat_kw("CURRENT"):
            self.expect_kw("ROW")
            return (0, "CURRENT")
        t = self.next()
        if t[0] != "num" or not isinstance(t[1], int):
            raise SqlError(
                f"a ROWS frame bound needs an integer, got {t[1]!r}"
            )
        which = self.eat_kw("PRECEDING", "FOLLOWING")
        if which is None:
            raise SqlError(
                f"expected PRECEDING or FOLLOWING after {t[1]} in ROWS frame"
            )
        return (t[1], which)

    def _range_bound(self):
        """A RANGE frame bound: numeric value delta, INTERVAL (days),
        CURRENT ROW, or UNBOUNDED."""
        if self.eat_kw("UNBOUNDED"):
            which = self.eat_kw("PRECEDING", "FOLLOWING")
            if which is None:
                raise SqlError(
                    "expected PRECEDING or FOLLOWING after UNBOUNDED"
                )
            return ("unbounded", which)
        if self.eat_kw("CURRENT"):
            self.expect_kw("ROW")
            return (0, "CURRENT")
        if (self.peek()[0] == "id"
                and str(self.peek()[1]).upper() == "INTERVAL"):
            days, months, us = self._interval("RANGE bound")
            if months:
                raise SqlError(
                    "RANGE frames take fixed-width intervals "
                    "(DAY/WEEK/HOUR/...); MONTH/YEAR vary by calendar "
                    "position"
                )
            # dtype-resolved: DATE order columns take days, TIMESTAMP
            # columns days+us (ops/window._range_delta)
            v = ("interval", days, us)
        else:
            t = self.next()
            if t[0] != "num":
                raise SqlError(
                    f"a RANGE frame bound needs a number or INTERVAL, "
                    f"got {t[1]!r}"
                )
            v = t[1]
        if (v[1] if isinstance(v, tuple) else v) < 0 or \
                (isinstance(v, tuple) and v[2] < 0):
            raise SqlError("RANGE frame bounds must be >= 0")
        which = self.eat_kw("PRECEDING", "FOLLOWING")
        if which is None:
            raise SqlError(
                f"expected PRECEDING or FOLLOWING after {v} in RANGE "
                f"frame"
            )
        return (v, which)

    def _parse_range_frame(self):
        """After RANGE: same shapes as ROWS but bounds are ORDER BY
        value deltas. Returns ("range", preceding, following) with
        "unbounded" markers."""
        if self.eat_kw("BETWEEN"):
            start = self._range_bound()
            self.expect_kw("AND")
            end = self._range_bound()
        else:
            start = self._range_bound()
            end = (0, "CURRENT")
        sv, sw = start
        if sw == "FOLLOWING":
            raise SqlError("a RANGE frame cannot start at FOLLOWING")
        ev, ew = end
        if ew == "PRECEDING" and ev not in ("unbounded", 0):
            raise SqlError("a RANGE frame cannot end at n PRECEDING")
        if ew == "PRECEDING" and ev == "unbounded":
            raise SqlError(
                "a RANGE frame cannot end at UNBOUNDED PRECEDING"
            )
        return ("range", sv, ev)

    def _parse_frame(self):
        """After ROWS: ``BETWEEN <bound> AND <bound>`` or a lone start
        bound (implicit end = CURRENT ROW). Returns (preceding, following),
        each an int or "unbounded"."""
        if self.eat_kw("BETWEEN"):
            start = self._frame_bound()
            self.expect_kw("AND")
            end = self._frame_bound()
        else:
            start = self._frame_bound()
            end = (0, "CURRENT")
        sv, sw = start
        if sw == "FOLLOWING":
            raise SqlError("a ROWS frame cannot start at FOLLOWING")
        preceding = sv  # n PRECEDING -> n; CURRENT ROW -> 0; unbounded
        ev, ew = end
        if ew == "PRECEDING" and ev != "unbounded" and ev != 0:
            raise SqlError("a ROWS frame cannot end at n PRECEDING")
        if ew == "PRECEDING" and ev == "unbounded":
            raise SqlError("a ROWS frame cannot end at UNBOUNDED PRECEDING")
        following = ev  # n FOLLOWING -> n; CURRENT ROW -> 0; unbounded
        return (preceding, following)

    def _window_spec(self, fname, star, args, has_order, frame):
        """Map a SQL window call + frame onto an engine op spec
        (ops/window.py WINDOW_OPS)."""

        def one_col(nargs_max=1):
            if star or not args or args[0][0] not in ("col", "expr"):
                raise SqlError(f"{fname} takes a column argument")
            if len(args) > nargs_max:
                raise SqlError(f"too many arguments to {fname}(...)")
            if args[0][0] == "expr":
                # hoisted pre-window computed column (base columns only;
                # rejected at compile time under GROUP BY)
                return self._pre(args[0][1])
            return args[0][1]

        def int_arg(i, what):
            if len(args) <= i:
                return None
            if args[i][0] != "num" or not isinstance(args[i][1], int):
                raise SqlError(f"{fname}'s {what} must be an integer")
            return args[i][1]

        is_range = isinstance(frame, tuple) and len(frame) == 3 \
            and frame[0] == "range"
        if fname in _WIN_RANK_FNS:
            if star or args:
                raise SqlError(f"{fname}() takes no arguments")
            if frame is not None:
                raise SqlError(f"{fname} does not take a frame")
            return _WIN_RANK_FNS[fname]
        if fname == "NTILE":
            if star or len(args) != 1:
                raise SqlError("NTILE takes one bucket count: NTILE(n)")
            n = int_arg(0, "bucket count")
            return ("ntile", n)
        if fname in _WIN_VALUE_FNS:
            # partition-wide first/last under ORDER BY: the engine
            # evaluates over the whole partition (SQL's default running
            # frame for LAST_VALUE is a well-known footgun; an explicit
            # full frame is accepted and means the same thing)
            if is_range:
                raise SqlError(
                    f"{fname} does not take a RANGE frame"
                )
            if frame is not None and frame != ("unbounded", "unbounded"):
                raise SqlError(
                    f"{fname} supports only the full-partition frame "
                    f"(ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED "
                    f"FOLLOWING) or no frame"
                )
            return (_WIN_VALUE_FNS[fname], one_col())
        if fname == "NTH_VALUE":
            c = one_col(nargs_max=2)
            k = int_arg(1, "k")
            if k is None:
                raise SqlError("NTH_VALUE takes (column, k)")
            return ("nth_value", c, k)
        if fname in ("LAG", "LEAD"):
            c = one_col(nargs_max=3)
            spec = [fname.lower(), c]
            if len(args) > 1:
                spec.append(int_arg(1, "offset"))
            if len(args) > 2:
                spec.append(args[2][1])  # default/fill literal
            return tuple(spec)

        # aggregate OVER: pick partition-wide / running / rolling by the
        # ORDER BY + frame, per SQL ROWS semantics (ties break by input
        # order — ROWS, not RANGE)
        if fname not in _WIN_AGG_FNS:
            raise SqlError(
                f"{fname} is not supported as a window function "
                f"(supported aggregates OVER: "
                f"{', '.join(sorted(_WIN_AGG_FNS))})"
            )
        part_op, run_op, roll_op = _WIN_AGG_FNS[fname]
        if fname == "COUNT":
            c = None if star or not args else one_col()
            # no NULLs in this engine: COUNT(x) == COUNT(*)
        else:
            c = one_col()

        def mk(name):
            if name is None:
                raise SqlError(
                    f"{fname} OVER (... ORDER BY ...) needs an explicit "
                    f"ROWS frame (no running form); e.g. ROWS BETWEEN "
                    f"k PRECEDING AND CURRENT ROW"
                )
            # COUNT maps onto the value-less rank ops (no NULLs here)
            return name if fname == "COUNT" else (name, c)

        if frame is None:
            return mk(run_op) if has_order else mk(part_op)
        if is_range:
            # value-based frames -> the engine's range_* ops (one
            # ascending numeric ORDER BY column; UNBOUNDED -> None)
            if not has_order:
                raise SqlError("a RANGE frame needs ORDER BY")
            rp = None if frame[1] == "unbounded" else frame[1]
            rf = None if frame[2] == "unbounded" else frame[2]
            rop = {"SUM": "range_sum", "MIN": "range_min",
                   "MAX": "range_max", "AVG": "range_mean",
                   "MEAN": "range_mean", "COUNT": "range_count"}
            if fname not in rop:
                raise SqlError(
                    f"{fname} does not support RANGE frames"
                )
            if fname == "COUNT":
                return ("range_count", rp, rf)
            return (rop[fname], c, rp, rf)
        p, f = frame
        if p == "unbounded" and f == "unbounded":
            return mk(part_op)
        if p == "unbounded" and f == 0:
            return mk(run_op)
        if p == "unbounded" or f == "unbounded":
            raise SqlError(
                "unsupported ROWS frame: UNBOUNDED may pair only with "
                "CURRENT ROW or UNBOUNDED on the other side"
            )
        if fname == "COUNT":
            return ("rolling_count", p, f)
        return (roll_op, c, p, f)

    def _alias(self):
        if self.eat_kw("AS"):
            return self.ident("alias")
        if self.peek()[0] == "id":
            return self.ident()
        return None


def _gb_key(p):
    g = p.parse_expr()
    return g.args[0] if g.kind == "col" else g


def _gb_keylist(p):
    p.expect_op("(")
    ks = [_gb_key(p)]
    while p.eat_op(","):
        ks.append(_gb_key(p))
    p.expect_op(")")
    return ks


def _group_factor(p):
    """One comma item of GROUP BY -> its list of grouping sets:
    ``ROLLUP(a, b)`` -> [[a, b], [a], []]; ``CUBE(a, b)`` -> all
    subsets; ``GROUPING SETS ((a, b), b, ())`` -> the literal list; a
    plain key -> [[key]]."""
    t = p.peek()
    word = str(t[1]).upper() if t[0] == "id" else None
    if word in ("ROLLUP", "CUBE") and p.peek(1) == ("op", "("):
        p.next()
        ks = _gb_keylist(p)
        if word == "ROLLUP":
            return [ks[:i] for i in range(len(ks), -1, -1)]
        if len(ks) > 6:
            raise SqlError(
                f"CUBE over {len(ks)} columns would expand to "
                f"{2 ** len(ks)} grouping sets; use GROUPING SETS to "
                f"name the ones you want"
            )
        from itertools import combinations

        return [list(c) for size in range(len(ks), -1, -1)
                for c in combinations(ks, size)]
    if (word == "GROUPING" and p.peek(1)[0] == "id"
            and str(p.peek(1)[1]).upper() == "SETS"
            and p.peek(2) == ("op", "(")):
        p.next()
        p.next()
        p.expect_op("(")
        sets = []
        while True:
            if p.at_op("("):
                if p.peek(1) == ("op", ")"):  # the grand-total set ()
                    p.next()
                    p.next()
                    sets.append([])
                else:
                    sets.append(_gb_keylist(p))
            else:
                sets.append([_gb_key(p)])
            if not p.eat_op(","):
                break
        p.expect_op(")")
        return sets
    return [[_gb_key(p)]]


def _conjuncts(e):
    """Flatten a predicate over top-level ANDs."""
    if isinstance(e, Expr) and e.kind == "bin" and e.args[0] == "and":
        return _conjuncts(e.args[1]) + _conjuncts(e.args[2])
    return [e]


def _corr_pair(c, schema):
    """``(inner, outer)`` join-key names when ``c`` is a correlated
    equality conjunct of an EXISTS subquery, else None."""
    if not (isinstance(c, Expr) and c.kind == "bin"
            and c.args[0] == "eq"):
        return None
    a, b = c.args[1], c.args[2]
    if not (isinstance(a, Expr) and a.kind == "col"
            and isinstance(b, Expr) and b.kind == "col"):
        return None
    an, bn = a.args[0], b.args[0]
    if an == bn:
        # s.k = t.k under the flat namespace parses as col(k) == col(k);
        # a genuine self-equality filter is vacuous, so read it as the
        # intended correlation on the shared name
        return (an, an) if an in schema else None
    a_in, b_in = an in schema, bn in schema
    if a_in != b_in:
        return (an, bn) if a_in else (bn, an)
    return None


def _apply_pending_join(lt, how, on, sub):
    """Attach one rewritten subquery predicate (IN / EXISTS) as a
    semi/anti join. ``on`` is a column name, a tuple of names, or None
    for the uncorrelated-EXISTS constant-key join (keep every outer row
    iff the subquery has any row)."""
    if on is None:
        key = "__exists_one"
        one = lit(torch.zeros((), dtype=torch.uint32))
        sub1 = sub.with_columns(**{key: one}).select(key)
        return (lt.with_columns(**{key: one})
                .join(sub1, [key], how=how)
                .drop(key))
    cols = [on] if isinstance(on, str) else list(on)
    return lt.join(sub, cols, how=how)


def _route(kwargs, names):
    return {k: v for k, v in kwargs.items() if k in names}


def sql(query: str, tables, **kwargs):
    """Compile ``query`` against ``tables`` (dict name -> Table/DistTable/
    LazyTable) into a :class:`LazyTable`. Call ``.collect()`` to run (or
    ``.explain()`` to inspect the optimized plan). Capacity knobs for the
    static-shape verbs pass through ``kwargs`` (``capacity``/
    ``capacity_per_shard`` for joins, ``max_groups`` for GROUP BY,
    ``max_unique`` for DISTINCT / set operations).

    ``EXPLAIN <query>`` returns the optimized plan rendering (a string)
    instead of a LazyTable — the same text as ``.explain()``."""
    p = _Parser(query)
    explain = False
    t = p.peek()
    if t[0] == "id" and str(t[1]).upper() == "EXPLAIN":
        p.next()
        explain = True
    lt = _query(p, tables, kwargs)
    if p.peek()[0] != "end":
        raise SqlError(f"unexpected trailing input near {p.peek()[1]!r}")
    return lt.explain() if explain else lt


def _query(p, tables, kwargs):
    """[WITH ctes] compound select + its trailing ORDER BY / LIMIT (which
    apply to the whole compound, per standard SQL)."""
    saved_ctx = p.sub_ctx
    if p.eat_kw("WITH"):
        # CTEs: each compiles to a LazyTable registered for the rest of
        # this query (later CTEs may reference earlier ones)
        tables = dict(tables)
        while True:
            name = p.ident("CTE name")
            p.expect_kw("AS")
            p.expect_op("(")
            tables[name] = _query(p, tables, kwargs)
            p.expect_op(")")
            if not p.eat_op(","):
                break
    lt = _compound(p, tables, kwargs)
    full, p.order_full = p.order_full, None
    drop_after = ()
    reproject = None
    if p.eat_kw("ORDER"):
        p.expect_kw("BY")
        order_by, order_desc, order_nulls, hoisted = [], [], [], {}
        if p.at_kw("ALL"):
            # DuckDB convenience: ORDER BY ALL [ASC|DESC] sorts by every
            # output column left-to-right
            p.next()
            d = p.eat_kw("ASC", "DESC")
            order_by = list(lt.column_names)
            order_desc = [d == "DESC"] * len(order_by)
            order_nulls = [None] * len(order_by)
        else:
            while True:
                # expression keys (ORDER BY UPPER(w), v % 10, ...) hoist
                # into synthetic columns dropped after the (sort, limit)
                # tail
                e = p.parse_expr()
                if e.kind == "col":
                    order_by.append(e.args[0])
                else:
                    name = f"__ord_{len(hoisted)}"
                    hoisted[name] = e
                    order_by.append(name)
                d = p.eat_kw("ASC", "DESC")
                order_desc.append(d == "DESC")
                nl_ = None
                t = p.peek()
                if t[0] == "id" and str(t[1]).upper() == "NULLS":
                    p.next()
                    w = p.next()
                    word = (str(w[1]).upper()
                            if w[0] in ("id", "kw") else "")
                    if word not in ("FIRST", "LAST"):
                        raise SqlError(
                            f"expected FIRST or LAST after NULLS, got "
                            f"{w[1]!r}"
                        )
                    nl_ = word == "LAST"
                order_nulls.append(nl_)
                if not p.eat_op(","):
                    break
        # keys (and hoisted expressions) may reference columns the SELECT
        # projection drops — base columns / group keys (standard SQL):
        # sort the stashed pre-projection relation and re-project after
        # the (sort, limit) tail. Not available under DISTINCT/compounds.
        schema = set(lt.column_names)
        missing = [o for o in order_by
                   if o not in schema and o not in hoisted]
        if full is not None and (missing or hoisted):
            full_lt, proj = full
            fschema = set(full_lt.column_names)
            if all(m in fschema for m in missing):
                lt, reproject, schema = full_lt, proj, fschema
                missing = []
        if missing:
            raise SqlError(
                f"ORDER BY column {missing[0]!r} is not in the SELECT "
                f"output{' or the underlying relation' if full else ''} "
                f"(available: {sorted(schema)})"
            )
        if hoisted:
            lt = lt.with_columns(**hoisted)
            drop_after = tuple(hoisted)
        lt = lt.sort_by(order_by, descending=order_desc,
                        nulls_last=(order_nulls
                                    if any(x is not None
                                           for x in order_nulls)
                                    else None))
    if p.eat_kw("LIMIT"):
        t = p.next()
        if t[0] != "num" or not isinstance(t[1], int):
            raise SqlError(f"LIMIT needs an integer, got {t[1]!r}")
        offset = 0
        if p.eat_kw("OFFSET"):
            o = p.next()
            if o[0] != "num" or not isinstance(o[1], int):
                raise SqlError(f"OFFSET needs an integer, got {o[1]!r}")
            offset = o[1]
        lt = lt.limit(t[1], offset)
    if drop_after:
        lt = lt.drop(*drop_after)
    if reproject is not None:
        lt = lt.select(*reproject)
    p.sub_ctx = saved_ctx
    return lt


def _check_setop_schemas(a, b, op):
    an, bn = list(a.column_names), list(b.column_names)
    if set(an) != set(bn):
        raise SqlError(
            f"{op} sides must expose the same column names (the engine "
            f"matches by name); got {an} vs {bn} — alias the SELECT items "
            f"to line them up"
        )


def _compound(p, tables, kwargs):
    """``term ((UNION [ALL] | EXCEPT) term)*`` where ``term`` binds
    INTERSECT tighter (standard SQL precedence)."""

    def term():
        lt = _select_core(p, tables, kwargs)
        while p.eat_kw("INTERSECT"):
            rhs = _select_core(p, tables, kwargs)
            _check_setop_schemas(lt, rhs, "INTERSECT")
            lt = lt.intersect(rhs, **_route(kwargs, _DISTINCT_KNOBS))
            p.order_full = None  # rhs's stash doesn't describe the setop
        return lt

    lt = term()
    while True:
        if p.eat_kw("UNION"):
            all_ = bool(p.eat_kw("ALL"))
            rhs = term()
            _check_setop_schemas(lt, rhs, "UNION")
            lt = (lt.concat(rhs) if all_
                  else lt.union(rhs, **_route(kwargs, _DISTINCT_KNOBS)))
            p.order_full = None
        elif p.eat_kw("EXCEPT"):
            rhs = term()
            _check_setop_schemas(lt, rhs, "EXCEPT")
            lt = lt.difference(rhs, **_route(kwargs, _DISTINCT_KNOBS))
            p.order_full = None
        else:
            return lt


def _from_target(p, tables, kwargs):
    """A FROM / JOIN target: a registered table name, or a parenthesized
    derived table ``( select ) [AS] alias`` (the planner namespace is
    flat, so the alias is accepted and ignored)."""
    if p.at_op("(") :
        p.next()
        lt = _query(p, tables, kwargs)
        p.expect_op(")")
        # optional [AS] name; the qualifiers this target answers to (only
        # ASOF JOIN reads them)
        p.last_quals = {p._alias()} - {None}
        return lt
    name = p.ident("table name")
    if name not in tables:
        raise SqlError(f"unknown table {name!r} (registered: "
                       f"{sorted(tables)})")
    t = tables[name]
    # optional [AS] alias (flat namespace: self-joins name the same table
    # twice; qualified refs resolve by bare column name, the join's suffix
    # renames right-side collisions)
    p.last_quals = {name, p._alias()} - {None}
    return t if hasattr(t, "collect") else t.lazy()


def _asof_join(p, lt, tables, kwargs, left_quals):
    """``ASOF [LEFT] JOIN source ON l.t >= r.t`` (DuckDB syntax; the ASOF
    keyword is already consumed) -> the planner's ``join_asof`` node.
    ``>=`` matches the nearest right row at-or-before each left row
    (direction="backward"), ``<=`` the nearest at-or-after ("forward");
    the sides may be written in either order (mirrored). Each column's side
    comes from its qualifier (a table name or alias of the left relation,
    ``left_quals``, or of the joined source); an unqualified column names
    the side that has it, and is an error when both do. Plain ASOF JOIN
    keeps only matched left rows; ASOF LEFT JOIN keeps all left rows with
    unmatched right cells zero-filled (``Table.join_asof`` contract). The
    qualifiers returned are those of the joined relation."""
    asof_left = bool(p.eat_kw("LEFT"))
    p.expect_kw("JOIN")
    rhs = _from_target(p, tables, kwargs)
    right_quals = set(p.last_quals)
    p.expect_kw("ON")
    _mirror = {">=": "<=", "<=": ">="}
    qa, a = p._qualified_ref("asof join column")
    op_sym = p.eat_op(">=", "<=")
    if not op_sym:
        raise SqlError(
            "ASOF JOIN ON needs exactly one >= or <= conjunct "
            "(strict </> and equality by-keys are not supported)"
        )
    qb, b = p._qualified_ref("asof join column")
    if p.eat_kw("AND"):
        raise SqlError(
            "ASOF JOIN supports exactly one inequality conjunct — no "
            "equality (by-key) conjuncts; use Table.join_asof after a "
            "per-key partition instead"
        )
    ln, rn = set(lt.column_names), set(rhs.column_names)

    def side(q, c):
        if q is not None:
            in_l, in_r = q in left_quals, q in right_quals
            if in_l == in_r:
                raise SqlError(
                    f"ASOF JOIN ON {q}.{c}: qualifier {q!r} names "
                    f"{'both sides' if in_l else 'neither side'}; give "
                    f"the tables distinct aliases"
                )
            s, names = ("left", ln) if in_l else ("right", rn)
            if c not in names:
                raise SqlError(f"ASOF JOIN ON {q}.{c}: the {s} side has "
                               f"no column {c!r}")
            return s
        if c in ln and c in rn:
            raise SqlError(
                f"ASOF JOIN ON column {c!r} is on both sides; qualify it "
                f"with a table name or alias"
            )
        if c in ln or c in rn:
            return "left" if c in ln else "right"
        raise SqlError(f"ASOF JOIN ON: no column {c!r} on either side")

    sa, sb = side(qa, a), side(qb, b)
    if (sa, sb) == ("right", "left"):
        a, b = b, a
        op_sym = _mirror[op_sym]
    elif sa == sb:
        raise SqlError(
            f"ASOF JOIN ON {a} {op_sym} {b}: one side must name a left "
            f"column and the other a right column"
        )
    direction = "backward" if op_sym == ">=" else "forward"
    if a != b:
        if a in rn:
            raise SqlError(
                f"ASOF JOIN ON {a} {op_sym} {b}: renaming the right key "
                f"{b!r} to {a!r} would shadow the right column {a!r}; "
                f"rename or drop it first"
            )
        rhs = rhs.rename({b: a})
    if asof_left:
        return lt.join_asof(rhs, a, direction=direction), right_quals
    m = "__asof_matched__"
    lt = lt.join_asof(rhs, a, direction=direction, matched_col=m)
    return lt.filter(col(m)).drop(m), right_quals


def _select_core(p, tables, kwargs):
    """One ``SELECT ... [GROUP BY ... HAVING ...]`` core (no ORDER BY /
    LIMIT — those belong to the enclosing compound), compiled onto the
    planner. A parenthesized compound is also accepted:
    ``( select )`` as a term of UNION/INTERSECT/EXCEPT."""
    if p.at_op("(") and p.peek(1) in (("kw", "SELECT"), ("op", "(")):
        p.next()
        lt = _query(p, tables, kwargs)
        p.expect_op(")")
        return lt
    # per-core hoisted-aggregate/expression sinks; the outer core's are
    # restored on exit so nested subqueries (scalar / IN / derived-table)
    # parsed mid-core don't wipe aggregates already hoisted by the outer
    # HAVING / OVER clauses
    outer_sinks = (p.agg_sink, p.pre_sink)
    p.agg_sink = {}
    p.pre_sink = {}
    p.sub_ctx = (tables, kwargs)  # for IN (SELECT ...) subqueries
    p.expect_kw("SELECT")
    distinct = bool(p.eat_kw("DISTINCT"))
    items = [p.parse_item()]
    while p.eat_op(","):
        items.append(p.parse_item())
    p.expect_kw("FROM")
    lt = _from_target(p, tables, kwargs)
    quals = set(p.last_quals)  # table names / aliases joined so far

    # JOIN clauses
    while True:
        if p.at_kw("ASOF"):
            p.next()
            lt, rq = _asof_join(p, lt, tables, kwargs, quals)
            quals |= rq
            continue
        how = None
        if p.at_kw("JOIN"):
            how = "inner"
        for kw, h in (("INNER", "inner"), ("LEFT", "left"),
                      ("RIGHT", "right"), ("FULL", "full"),
                      ("SEMI", "semi"), ("ANTI", "anti"),
                      ("CROSS", "cross")):
            if how is None and p.at_kw(kw):
                p.next()
                p.eat_kw("OUTER")
                how = h
        if how is None:
            break
        p.expect_kw("JOIN")
        rhs = _from_target(p, tables, kwargs)
        quals |= p.last_quals
        if how == "cross":  # CROSS JOIN takes no ON/USING clause
            lt = lt.cross_join(rhs, **_route(kwargs, _JOIN_KNOBS))
            continue
        on, renames, band = [], {}, None
        if p.eat_kw("USING"):
            # USING (k [, ...]): shorthand for same-named equi-keys
            p.expect_op("(")
            while True:
                on.append(p.ident("join column"))
                if not p.eat_op(","):
                    break
            p.expect_op(")")
        else:
            p.expect_kw("ON")
            _mirror = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            while True:
                a = p._qualified_ident("join column")
                if p.eat_kw("BETWEEN"):
                    # band conjunct: probe BETWEEN lo AND hi (the range
                    # AND binds before the conjunct AND, as usual)
                    b = p._qualified_ident("join column")
                    p.expect_kw("AND")
                    c = p._qualified_ident("join column")
                    if band is not None:
                        raise SqlError(
                            "at most one band (non-equality) conjunct "
                            "per ON clause"
                        )
                    ln = set(lt.column_names)
                    rn = set(rhs.column_names)
                    if a in ln and b in rn and c in rn:
                        band = (a, "between", (b, c))
                    elif a in rn and b in ln and c in ln:
                        raise SqlError(
                            f"ON {a} BETWEEN {b} AND {c}: the probe "
                            f"column must come from the LEFT table "
                            f"(swap the join sides)"
                        )
                    else:
                        raise SqlError(
                            f"ON {a} BETWEEN {b} AND {c}: the probe must "
                            f"be a left column and both bounds right "
                            f"columns"
                        )
                else:
                    op_sym = p.eat_op("=", "<", "<=", ">", ">=")
                    if not op_sym:
                        raise SqlError(
                            "join ON conjunct needs =, <, <=, >, >= "
                            "or BETWEEN"
                        )
                    b = p._qualified_ident("join column")
                    if op_sym == "=":
                        if a != b:
                            # differently-named keys: rename the right
                            # side's column to the left's name pre-join
                            # (the engine matches keys by name). Sides
                            # may be written in either order.
                            ln = set(lt.column_names)
                            rn = set(rhs.column_names)
                            if (a in rn and b in ln
                                    and not (a in ln and b in rn)):
                                a, b = b, a
                            if a not in ln or b not in rn:
                                raise SqlError(
                                    f"join key {a!r} = {b!r}: one side "
                                    f"must name a left column and the "
                                    f"other a right column"
                                )
                            renames[b] = a
                        on.append(a)
                    else:
                        if band is not None:
                            raise SqlError(
                                "at most one band (non-equality) "
                                "conjunct per ON clause"
                            )
                        ln = set(lt.column_names)
                        rn = set(rhs.column_names)
                        if a in ln and b in rn:
                            band = (a, op_sym, (b,))
                        elif a in rn and b in ln:
                            band = (b, _mirror[op_sym], (a,))
                        else:
                            raise SqlError(
                                f"band conjunct {a} {op_sym} {b}: one "
                                f"side must name a left column and the "
                                f"other a right column"
                            )
                if not p.eat_kw("AND"):
                    break
        if renames:
            rhs = rhs.rename(renames)
            if band is not None:
                band = (band[0], band[1],
                        tuple(renames.get(x, x) for x in band[2]))
        if band is not None:
            lo_, opx, ro_ = band
            if opx == "between" and how != "inner":
                raise SqlError(
                    f"{how.upper()} JOIN: BETWEEN join conjuncts are "
                    f"INNER-only"
                )
            if how not in ("inner", "left", "semi", "anti"):
                raise SqlError(
                    f"{how.upper()} JOIN does not support a band "
                    f"(non-equality) conjunct"
                )
            lt = lt.join_band(
                rhs, lo_, opx, ro_ if opx == "between" else ro_[0],
                on=on, how=how, **_route(kwargs, _JOIN_KNOBS),
            )
        else:
            lt = lt.join(rhs, on, how=how, **_route(kwargs, _JOIN_KNOBS))

    if p.eat_kw("WHERE"):
        base = len(p.pending_joins)
        p.subq_ok = True
        pred = p.parse_expr()
        p.subq_ok = False
        if not (pred.kind == "lit" and pred.args[0] is True):
            lt = lt.filter(pred)
        # IN (SELECT ...) conjuncts -> semi/anti joins (natural capacity:
        # at most one output row per left row, no knob needed)
        for how, on, sub in p.pending_joins[base:]:
            lt = _apply_pending_join(lt, how, on, sub)
        del p.pending_joins[base:]

    group_by, group_sets = [], None
    if p.eat_kw("GROUP"):
        p.expect_kw("BY")
        if p.at_kw("ALL") and p.peek(1) != ("op", "("):
            # DuckDB convenience: GROUP BY ALL groups by every plain
            # (non-aggregate, non-window) SELECT item
            p.next()
            for it in items:
                if it[0] == "star":
                    raise SqlError(
                        "GROUP BY ALL cannot be combined with SELECT *"
                    )
                if it[0] == "expr":
                    e = it[1]
                    group_by.append(
                        e.args[0] if e.kind == "col" else e)
            if not group_by:
                raise SqlError(
                    "GROUP BY ALL: the SELECT list has no plain "
                    "(non-aggregate) items to group by"
                )
        else:
            # each comma item is a FACTOR: a plain key contributes one
            # single-key set; ROLLUP/CUBE/GROUPING SETS contribute
            # several. The grouping sets are the cross product of the
            # factors (standard SQL). A key is a full expression: a
            # plain (qualified) column stays a name; anything else
            # resolves against a structurally equal SELECT item
            # (GROUP BY LOWER(w) with SELECT LOWER(w) AS k) or hoists
            # into a synthetic key column
            factors = []
            while True:
                factors.append(_group_factor(p))
                if not p.eat_op(","):
                    break
            if any(len(f) > 1 for f in factors):
                from itertools import product

                seen, group_sets = set(), []
                for parts in product(*factors):
                    s = [k for part in parts for k in part]
                    sig = tuple(k if isinstance(k, str) else repr(k)
                                for k in s)
                    if sig not in seen:
                        seen.add(sig)
                        group_sets.append(s)
                for s in group_sets:  # flat unique key list, order of use
                    for k in s:
                        sig = k if isinstance(k, str) else repr(k)
                        if sig not in {g if isinstance(g, str)
                                       else repr(g) for g in group_by}:
                            group_by.append(k)
            else:
                group_by = [k for f in factors for k in f[0]]

    having = None
    having_joins = []
    if p.eat_kw("HAVING"):
        # HAVING may call aggregates inline (COUNT(*) > 1); they hoist
        # into synthetic aggregate columns alongside the SELECT aggregates
        base = len(p.pending_joins)
        p.allow_aggs = p.subq_ok = True
        having = p.parse_expr()
        p.allow_aggs = p.subq_ok = False
        having_joins = p.pending_joins[base:]
        del p.pending_joins[base:]
        if having.kind == "lit" and having.args[0] is True:
            having = None  # pure IN-subquery HAVING

    has_aggs = any(it[0] == "agg" for it in items) or p.agg_sink
    if has_aggs or group_by:
        aggs, out_names, grouping_out = {}, [], {}
        derived_keys = {}  # computed GROUP BY keys (SELECT expr AS g)
        win_groups = {}  # (partition, order, desc) -> {alias: spec}
        if any(not isinstance(g, str) for g in group_by):
            # expression GROUP BY keys: reuse a structurally identical
            # SELECT item's alias, else hoist a synthetic key column
            # (computed pre-aggregation, dropped by the final projection)
            sel = {repr(e): alias for tag, *rest in items
                   if tag == "expr"
                   for e, alias in [rest]}
            resolved, key_names = [], {}
            for g in group_by:
                if isinstance(g, str):
                    resolved.append(g)
                    key_names[g] = g
                    continue
                alias = sel.get(repr(g))
                if alias is None:
                    alias = f"__grp_{len(derived_keys)}"
                    derived_keys[alias] = g
                resolved.append(alias)
                key_names[repr(g)] = alias
            group_by = resolved
            if group_sets is not None:
                group_sets = [
                    [key_names[k if isinstance(k, str) else repr(k)]
                     for k in s]
                    for s in group_sets
                ]
        for it in items:
            if it[0] == "star":
                raise SqlError("SELECT * cannot mix with GROUP BY — name "
                               "the group keys and aggregates")
            if it[0] == "win":
                # a window over the aggregated relation: its partition /
                # order / argument columns are group keys, select aliases,
                # or hoisted aggregates; computed after HAVING (SQL
                # evaluation order), before the final projection
                _, spec, part, order, desc, alias = it
                win_groups.setdefault((part, order, desc), {})[alias] = spec
                out_names.append(alias)
            elif it[0] == "agg":
                _, agg, argname, alias = it
                aggs[alias] = (agg,) if argname is None else (agg, argname)
                out_names.append(alias)
            else:
                _, e, alias = it
                if e.kind == "grouping":
                    if group_sets is None:
                        raise SqlError(
                            "GROUPING() needs ROLLUP / CUBE / GROUPING "
                            "SETS in the GROUP BY clause"
                        )
                    key = e.args[0]
                    if key not in group_by:
                        raise SqlError(
                            f"GROUPING({key!r}) must name a grouping-set "
                            f"column (have {group_by})"
                        )
                    grouping_out[alias] = key
                    out_names.append(alias)
                elif e.kind == "col" and e.args[0] in group_by:
                    if alias != e.args[0]:
                        raise SqlError(
                            "aliasing a group key in SELECT is not "
                            "supported; rename after the query"
                        )
                    out_names.append(e.args[0])
                elif alias in group_by:
                    # a computed group key: SELECT k / 10 AS bucket ...
                    # GROUP BY bucket — materialized pre-aggregation
                    derived_keys[alias] = e
                    out_names.append(alias)
                else:
                    raise SqlError(
                        f"non-aggregate SELECT item {alias!r} must be a "
                        f"GROUP BY key"
                    )
        for spec, sname in p.agg_sink.items():
            aggs[sname] = spec  # hoisted HAVING / OVER aggregates
        if p.pre_sink:
            # expression aggregate arguments (SUM(price * qty)) compute
            # before the aggregate; window-arg expressions can't — under
            # GROUP BY a window runs over post-aggregate rows where base
            # columns are gone
            pre_names = {n for n, _ in p.pre_sink.values()}
            used_by_aggs = {a for spec in aggs.values()
                            for a in spec[1:]}
            for wspecs in win_groups.values():
                for spec in wspecs.values():
                    refs = [spec] if isinstance(spec, str) else list(spec)
                    bad = [r for r in refs if isinstance(r, str)
                           and r in pre_names and r not in used_by_aggs]
                    if bad:
                        raise SqlError(
                            "window-function expression arguments cannot "
                            "mix with GROUP BY (the expression would read "
                            "pre-aggregation columns); alias the "
                            "expression as an aggregate first"
                        )
            lt = lt.with_columns(
                **{n: e for n, e in p.pre_sink.values()}
            )
        if derived_keys:
            lt = lt.with_columns(**derived_keys)
        if group_sets is not None:
            lt = lt.aggregate_sets(group_sets, aggs,
                                   grouping=grouping_out or None,
                                   **_route(kwargs, _AGG_KNOBS))
        else:
            lt = lt.aggregate(group_by, aggs,
                              **_route(kwargs, _AGG_KNOBS))
        if having is not None:
            lt = lt.filter(having)
        for how, on, sub in having_joins:
            lt = _apply_pending_join(lt, how, on, sub)
        for (part, order, desc), ops in win_groups.items():
            lt = lt.window(
                ops,
                partition_by=list(part) or None,
                order_by=list(order) or None,
                descending=list(desc) or None,
            )
        full_lt = lt
        lt = lt.select(*out_names)
        if distinct:
            # GROUP BY on a superset of the selected keys can still yield
            # duplicate output rows; DISTINCT applies after aggregation
            lt = lt.distinct(subset=out_names,
                             **_route(kwargs, _DISTINCT_KNOBS))
            p.order_full = None
        else:
            p.order_full = (full_lt, tuple(out_names))
    else:
        if having is not None or having_joins:
            raise SqlError("HAVING needs GROUP BY or aggregates")
        derived = {}
        names = []
        star = False
        win_groups = {}  # (partition, order, desc) -> {alias: spec}
        for it in items:
            if it[0] == "star":
                star = True
                continue
            if it[0] == "win":
                _, spec, part, order, desc, alias = it
                win_groups.setdefault((part, order, desc), {})[alias] = spec
                names.append(alias)
                continue
            _, e, alias = it
            if e.kind == "grouping":
                raise SqlError(
                    "GROUPING() needs ROLLUP / CUBE / GROUPING SETS in "
                    "the GROUP BY clause"
                )
            if e.kind == "col" and e.args[0] == alias:
                names.append(alias)
            else:
                derived[alias] = e
                names.append(alias)
        base_names = list(lt.column_names) if star else None
        pre = {n: e for n, e in p.pre_sink.values()}
        if pre or derived:
            lt = lt.with_columns(**pre, **derived)
        for (part, order, desc), ops in win_groups.items():
            lt = lt.window(
                ops,
                partition_by=list(part) or None,
                order_by=list(order) or None,
                descending=list(desc) or None,
            )
        full_lt = lt
        if not star:
            lt = lt.select(*names)
        elif pre:
            # SELECT * must not leak hoisted __pre_ columns
            lt = lt.select(*base_names, *names)
        if distinct:
            lt = lt.distinct(subset=None if star else names,
                             **_route(kwargs, _DISTINCT_KNOBS))
            p.order_full = None
        else:
            p.order_full = (full_lt, tuple(lt.column_names))

    p.agg_sink, p.pre_sink = outer_sinks
    return lt
