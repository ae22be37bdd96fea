"""TPC-H queries as SQL text through ``radix_sort_tpu_torch.sql(text,
tables, **kw).collect()`` over ``radix_sort_tpu_torch.Table``.

Configuration: the generator's sizes (``benchmark.tpch_data``) and
``reference``, the package under ``benchmark/reference`` that answers each
query. Traffic: ``queries``, names of ``benchmark/queries/<name>.json``
(``sql``, ``kw``, ``answer``), issued in that order round and round by one
closed-loop client; ``limits`` in a query's file bound the relative gaps
of its float aggregates. A query is timed from its ``sql()`` call until its
result rows are on the host; one whose joins overflow their capacity has
failed. Every result of the window is kept and judged.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict

import torch

from benchmark import tpch_data


class Session:
    def __init__(self, reg, cfg, traffic, seed, dev):
        t = time.perf_counter()
        import radix_sort_tpu_torch as rst

        self.split = [("the program's import", time.perf_counter() - t)]
        t = time.perf_counter()
        self.rst, self.dev = rst, dev
        self.reference, self.limits = cfg["reference"], cfg["limits"]
        gen = torch.Generator(device=dev.t).manual_seed(seed)
        self.raw = tpch_data.generate(gen, cfg)
        self.tables = {
            name: rst.Table(cols, dictionaries={k: v for k, v in tpch_data.DICTIONARIES.items()
                                                if k in cols}, device=dev.t)
            for name, cols in self.raw.items()}
        dev.sync()
        self.split.append(("tables", time.perf_counter() - t))
        t = time.perf_counter()
        self.queries = [(name, reg.data("queries", name)) for name in traffic["queries"]]
        self.cycle = len(self.queries)
        self.results = defaultdict(list)
        self.i = 0
        for _, q in self.queries:  # warm-up: each query once
            self._run(q)
        self.split.append(("warm-up", time.perf_counter() - t))

    def _run(self, q):
        """(seconds to compile, result rows on the host, overflowed)."""
        t = time.perf_counter()
        plan = self.rst.sql(q["sql"], self.tables, **q["kw"])
        t_plan = time.perf_counter() - t
        out, ovf = plan.collect(return_overflow=True)
        rows = out.to_numpy()
        self.dev.sync()
        return t_plan, rows, bool(ovf)

    def step(self, rec) -> bool:
        name, q = self.queries[self.i % self.cycle]
        self.i += 1
        t = time.perf_counter()
        t_plan, rows, overflowed = self._run(q)
        rec.latencies.append((name, time.perf_counter() - t))
        rec.plan_s.append(t_plan)
        if overflowed:
            return False
        rec.items += 1
        self.results[name].append(rows)
        return True

    def close(self):
        self.tables = None

    def judge(self, control=False) -> dict:
        """{name: (value, limit)}: the mismatches of every result, and per
        query the widest relative gap of its float aggregates of each
        dtype, against the limit its query file states; with ``control``,
        of the reference one precision lower in the program's place."""
        from benchmark.reference.tpch import common

        mism, out = 0, {}
        for name, q in dict(self.queries).items():
            ref = importlib.import_module(f"benchmark.reference.{self.reference}.{q['answer']}")
            ans = ref.answer(self.raw)
            got = [ref.answer(self.raw, lower=True).as_result()] if control \
                else self.results[name]
            gaps = {}
            for rows in got:
                m, g = common.compare(rows, ans)
                mism += m
                for tag, v in g.items():
                    gaps[tag] = max(gaps.get(tag, 0.0), v)
            for tag, v in sorted(gaps.items()):
                key = f"{tag}_rel_err"
                out[f"{name}.{key}"] = (v, q["limits"][key])
        return {"mismatches": (mism, self.limits["mismatches"]), **out}
