"""The db-benchmark groupby questions as SQL text through
``radix_sort_tpu_torch.sql(text, {"x": Table}).collect()`` over one
``radix_sort_tpu_torch.Table`` of the G1 data set.

Configuration: the data set's sizes (``benchmark.h2o_data``: ``rows``,
``k``) and ``reference``, the module under ``benchmark/reference`` that
answers each question. Traffic: ``queries``, names of
``benchmark/queries/<name>.json`` (``sql``, ``kw``, ``answer``,
``limits``; under ``queries/h2o/``, where the TPC-H tests, which take every
file directly in ``queries/`` for theirs, do not look), issued in that
order round and round by one closed-loop client; each is named by its
``answer`` (``q1`` ... ``q10``) in the latencies and the checks. A
question is timed from its ``sql()`` call until its result ``Table`` is on
the card, synced; the answer is not copied to the host.

Judging: after its latency each result is reduced on the card to a
fingerprint of a few words (:func:`fingerprint`), and the question's
latest result replaces the one kept from its previous cycle. ``judge()``
holds the warm-up's result and the window's last result of each question
row for row against the reference (keys and integers exactly, floats by
the widest ``|got - exact| / scale`` of each stated dtype), and every
window result's fingerprint against the reference's: its exact words
equal, its float sums within the same limits. The program's counters
(:data:`COUNTERS`, those it has) grow into ``rec.counters`` at each step;
``close()`` writes them and each question's median latency to stderr.
"""

from __future__ import annotations

import importlib
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from benchmark import h2o_data
from benchmark.reference.h2o_groupby import lexsort

# the program's counters, by their names in ``rec.counters``
COUNTERS = {"agg_calls": ("ops.query", "AGG_CALLS"),
            "agg_key_passes": ("ops.query", "AGG_KEY_PASSES"),
            "window_calls": ("ops.window", "CALLS")}
BIG = 1e300  # a gap that is not a finite number reads as this
MASK32 = 0xFFFFFFFF
# odd multipliers below 2**29 of the row hash, one per 32-bit half of a
# column's word: three products and a hash below 2**32 add below 2**63
MULTIPLIERS = (0x0D2B79F5, 0x1B873593, 0x0C6EF373, 0x165667B1, 0x027D4EB3, 0x1F3A2C35,
               0x0A5F1B47, 0x11C64E6D, 0x06C07893, 0x19660D0F, 0x0B3C6D29, 0x14057B7F)
MIX = 0x045D9F3B  # the final bijection's multiplier


def program_counters() -> dict:
    """The current values of the program's :data:`COUNTERS` that it has."""
    out = {}
    for name, (module, attr) in COUNTERS.items():
        mod = importlib.import_module(f"radix_sort_tpu_torch.{module}")
        if isinstance(getattr(mod, attr, None), int):
            out[name] = getattr(mod, attr)
    return out


def words(x):
    """A column's values as int64 words of their bits (a float's bit
    pattern, an unsigned value's zero extension)."""
    if x.dtype == torch.bool:
        return x.to(torch.int64)
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & MASK32
    if x.is_floating_point():
        return x.to(torch.float64).view(torch.int64)
    return x.to(torch.int64)


def result_columns(table):
    """{name: (values, null mask or None)} of a result Table's valid rows,
    on its device, and each string column's dictionary."""
    n = table.num_rows if table.count is None else int(table.count)
    cols = {}
    for c in table.column_names:
        m = table.null_mask(c)
        cols[c] = (table[c][:n], None if m is None else m[:n])
    return cols, {c: table.dictionary(c) for c in table.column_names if table.is_string(c)}


def answer_columns(ans, stated=False):
    """{name: (values, null mask or None)} of a reference answer; with
    ``stated``, a float32 result's values rounded to float32, the dtype the
    result states."""
    return {c: (v.to(torch.float32) if stated and ans.kinds[c] == "f32" else v,
                ans.masks.get(c)) for c, v in ans.columns.items()}


NULL_WORD = 1 << 40  # a NULL's word: no 32-bit value's


def fingerprint(cols) -> list:
    """A result reduced on the device to a few numbers, read to the host in
    one copy: its columns' names and dtypes, its row count, the sum over
    the rows of a 32-bit hash of each row's words (every column but the
    float ones, a NULL as :data:`NULL_WORD`; an odd multiple of each 32-bit
    half, summed mod 2**32, then a bijection), its count of NULLs, and each
    float column's sum and sum of |x| over its non-NULL rows. Nothing
    wraps: the products stay below 2**61 and the row sums of values below
    2**32 below 2**63."""
    names = sorted(cols)
    n = cols[names[0]][0].shape[0]
    dev = cols[names[0]][0].device
    h = torch.zeros(n, dtype=torch.int64, device=dev)
    nulls = torch.zeros((), dtype=torch.int64, device=dev)
    floats, muls = [], iter(MULTIPLIERS * 8)
    for c in names:
        v, m = cols[c]
        if m is not None:
            nulls = nulls + m.sum()
        if v.is_floating_point():
            x = v.to(torch.float64)
            x = x if m is None else torch.where(m, 0.0, x)
            floats += [x.sum(), x.abs().sum()]
            continue
        w = words(v) if m is None else torch.where(m, NULL_WORD, words(v))
        for half in [w] + ([w >> 32] if v.element_size() > 4 or m is not None else []):
            h = (h + (half & MASK32) * next(muls)) & MASK32
    h = h ^ (h >> 16)
    h = (h * MIX) & MASK32
    h = h ^ (h >> 16)
    nums = torch.stack([h.sum(), nulls]).cpu().tolist()
    fl = torch.stack(floats).cpu().tolist() if floats else []
    schema = ",".join(f"{c}:{str(cols[c][0].dtype).replace('torch.', '')}" for c in names)
    return [schema, n, *nums, *fl]


def exact_words(cols, ans):
    """The int64 words of the answer's exact columns and of its nullable
    columns' masks, in ``cols``."""
    out = []
    for c, kind in ans.kinds.items():
        v, m = cols[c]
        if kind == "exact":
            out.append(words(v))
        if c in ans.masks:
            out.append(torch.zeros_like(v, dtype=torch.int64) if m is None else words(m))
    return out


def compare(cols, dicts, ans, in_dicts):
    """(mismatches, {dtype tag: widest relative gap}) of a result against
    the answer, both sorted by their exact words: a mismatch is a row too
    many or too few, a row whose exact words differ, or every row of a
    column that is missing, of another dtype or coded in another
    dictionary; a float's gap is ``|got - exact| / scale``."""
    n_ref = next(iter(ans.columns.values())).shape[0]
    n = next(iter(cols.values()))[0].shape[0]
    stated = {c: {"f64": torch.float64, "f32": torch.float32}.get(k, ans.columns[c].dtype)
              for c, k in ans.kinds.items()}
    if (set(cols) != set(stated) or any(cols[c][0].dtype != dt for c, dt in stated.items())
            or any(not np.array_equal(dicts.get(c), d) for c, d in in_dicts.items()
                   if c in cols)):
        return n_ref + n, {}
    if n != n_ref:
        return abs(n - n_ref) + min(n, n_ref), {}
    ref = answer_columns(ans)
    gw, rw = exact_words(cols, ans), exact_words(ref, ans)
    pg, pr = lexsort(gw), lexsort(rw)
    bad = torch.zeros(n, dtype=torch.bool, device=pg.device)
    for a, b in zip(gw, rw):
        bad |= a[pg] != b[pr]
    gaps = {}
    for c, kind in ans.kinds.items():
        if kind == "exact":
            continue
        g = cols[c][0].to(torch.float64)[pg]
        diff = (g - ref[c][0][pr]).abs()
        err = torch.where(diff == 0, 0.0, diff / ans.scales[c][pr])
        err = torch.nan_to_num(err, nan=BIG, posinf=BIG)
        gaps[kind] = max(gaps.get(kind, 0.0), float(err.max()) if n else 0.0)
    return int(bad.sum()), gaps


def fingerprint_gaps(fp, ref_fp, ans):
    """(1 if a name, dtype, count or hash differs else 0, {dtype tag:
    widest gap of a float sum, over the sum of the reference's scales of
    the column (of its |x| where it states none)}) of a fingerprint."""
    if fp[:4] != ref_fp[:4]:
        return 1, {}
    gaps, i = {}, 4
    for c, dtype in (f.split(":") for f in fp[0].split(",")):
        if not dtype.startswith("float"):
            continue
        total = float(ans.scales[c].sum()) if c in ans.scales else ref_fp[i + 1]
        tag = "f32" if dtype == "float32" else "f64"
        for got, want in ((fp[i], ref_fp[i]), (fp[i + 1], ref_fp[i + 1])):
            gap = 0.0 if got == want else abs(got - want) / total if total else BIG
            gaps[tag] = max(gaps.get(tag, 0.0), gap if gap == gap else BIG)
        i += 2
    return 0, gaps


class Session:
    def __init__(self, reg, cfg, traffic, seed, dev):
        t = time.perf_counter()
        import radix_sort_tpu_torch as rst

        self.split = [("the program's import", time.perf_counter() - t)]
        t = time.perf_counter()
        self.rst, self.dev = rst, dev
        self.ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
        self.limits = cfg["limits"]
        gen = torch.Generator(device=dev.t).manual_seed(seed)
        self.raw, self.dicts = h2o_data.generate(gen, cfg)
        self.tables = {"x": rst.Table(self.raw, dictionaries=self.dicts, device=dev.t)}
        dev.sync()
        self.split.append(("table", time.perf_counter() - t))
        t = time.perf_counter()
        self.queries = [(q["answer"], q) for q in (reg.data("queries", name)
                                                    for name in traffic["queries"])]
        self.cycle = len(self.queries)
        self.i = 0
        self.warm, self.last = {}, {}
        self.prints, self.latencies = defaultdict(list), defaultdict(list)
        for name, q in self.queries:  # warm-up: each question once
            self.warm[name] = self._run(q)[1]
        self.split.append(("warm-up", time.perf_counter() - t))
        self.base = program_counters()

    def _run(self, q):
        """(seconds to compile, the result Table, synced)."""
        t = time.perf_counter()
        plan = self.rst.sql(q["sql"], self.tables, **q["kw"])
        t_plan = time.perf_counter() - t
        out = plan.collect()
        self.dev.sync()
        return t_plan, out

    def counters(self) -> dict:
        """Each program counter's growth since the window opened."""
        now = program_counters()
        return {k: now[k] - v for k, v in self.base.items()}

    def step(self, rec) -> bool:
        name, q = self.queries[self.i % self.cycle]
        self.i += 1
        t = time.perf_counter()
        t_plan, out = self._run(q)
        rec.latencies.append((name, time.perf_counter() - t))
        self.latencies[name].append(rec.latencies[-1][1])
        rec.plan_s.append(t_plan)
        rec.counters.update(self.counters())
        self.last[name] = out  # the previous cycle's result is let go
        self.prints[name].append(fingerprint(result_columns(out)[0]))
        rec.items += 1
        return True

    def close(self):
        """Drop the table; write the program's counters and each question's
        median latency over the window to stderr."""
        print(f"program counters over the window: {self.counters()}", file=sys.stderr,
              flush=True)
        med = {k: round(1e3 * statistics.median(v), 3) for k, v in self.latencies.items()}
        print(f"median ms by question: {med}", file=sys.stderr, flush=True)
        if self.dev.cuda:
            st = torch.cuda.memory_stats(self.dev.t)
            print(f"allocator: {st['num_alloc_retries']} retries, peak reserved "
                  f"{st['reserved_bytes.all.peak'] / 2**30:.2f} GiB", file=sys.stderr,
                  flush=True)
        self.tables = None

    def judge(self, control=False) -> dict:
        """{name: (value, limit)}: the mismatches of the judged results, the
        fingerprints whose exact words differ, and per question the widest
        relative gap of its float results of each dtype; with ``control``,
        of the reference one precision lower in the program's place."""
        mism = fp_mism = 0
        out = {}
        for name, q in self.queries:
            ans = self.ref.answer(self.raw, q["answer"])
            ref_fp = fingerprint(answer_columns(ans, stated=True))
            if control:
                low = answer_columns(self.ref.answer(self.raw, q["answer"], lower=True),
                                     stated=True)
                judged, prints = [(low, self.dicts)], [fingerprint(low)]
            else:
                judged = [result_columns(t) for t in (self.warm.get(name), self.last.get(name))
                          if t is not None]
                prints = self.prints[name]
            gaps = {}
            for cols, dicts in judged:
                m, g = compare(cols, dicts, ans, self.dicts)
                mism += m
                for tag, v in g.items():
                    gaps[tag] = max(gaps.get(tag, 0.0), v)
            for fp in prints:
                m, g = fingerprint_gaps(fp, ref_fp, ans)
                fp_mism += m
                for tag, v in g.items():
                    gaps[tag] = max(gaps.get(tag, 0.0), v)
            for tag, v in sorted(gaps.items()):
                key = f"{tag}_rel_err"
                out[f"{name}.{key}"] = (v, q["limits"][key])
            del ans
        return {"mismatches": (mism, self.limits["mismatches"]),
                "fingerprint_mismatches": (fp_mism, self.limits["mismatches"]), **out}
