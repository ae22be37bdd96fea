"""Stable (key, payload) row sorts through ``radix_sort_tpu_torch.sort_pairs``.

Configuration: ``rows``, ``key_dtype``, ``payload_dtype`` (``uint32`` or
``uint64``). Traffic: ``keys`` (the name of a sampler of
``benchmark.distributions``) with ``key_params`` (its keyword arguments,
such as ``s`` or ``steps``), ``batches`` (distinct
resident batches; the calls go round them) and optionally
``implementation``. Every call sorts one whole batch and ends in a sync.

The outputs of one call, drawn from the seed as a reservoir of one over
the window's calls, are kept and judged against the reference's stable sort
of the same batch.
"""

from __future__ import annotations

import functools
import importlib
import random
import time

import torch

from benchmark import distributions as D

DTYPES = {"uint32": torch.uint32, "uint64": torch.uint64}


def make_keys(gen, n, dtype, traffic):
    """``n`` keys from the sampler of :mod:`benchmark.distributions` that
    ``traffic["keys"]`` names, called with ``traffic["key_params"]``."""
    kind = traffic["keys"]
    sampler = None if kind.startswith("_") else getattr(D, kind, None)
    if not callable(sampler):
        raise ValueError(f"unknown key sampler {kind!r}")
    return sampler(gen, n, dtype, **traffic.get("key_params", {}))


class Session:
    def __init__(self, reg, cfg, traffic, seed, dev):
        t = time.perf_counter()
        import radix_sort_tpu_torch as rst

        self.split = [("the program's import", time.perf_counter() - t)]
        t = time.perf_counter()
        self.ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
        self.dev, self.n, self.limits = dev, cfg["rows"], cfg["limits"]
        kdt, vdt = DTYPES[cfg["key_dtype"]], DTYPES[cfg["payload_dtype"]]
        self.key_bits = 8 * kdt.itemsize
        gen = torch.Generator(device=dev.t).manual_seed(seed)
        self.batches = [(make_keys(gen, self.n, kdt, traffic), D.uniform(gen, self.n, vdt))
                        for _ in range(traffic["batches"])]
        kw = {"implementation": traffic["implementation"]} if "implementation" in traffic else {}
        self.sort = functools.partial(rst.sort_pairs, **kw)
        self.cycle = len(self.batches)
        self.calls, self.kept = 0, None
        self.pick = random.Random(seed)
        self.row_bytes = kdt.itemsize + vdt.itemsize
        dev.sync()
        self.split.append(("inputs", time.perf_counter() - t))
        t = time.perf_counter()
        # warm-up: each batch once, the previous output held as the window holds one
        held = None
        for keys, values in self.batches:
            out = self.sort(keys, values)
            dev.sync()
            held = out
        del held, out
        self.split.append(("warm-up", time.perf_counter() - t))

    def step(self, rec) -> bool:
        b = self.calls % self.cycle
        t = time.perf_counter()
        out = self.sort(*self.batches[b])
        self.dev.sync()
        rec.latencies.append(("sort", time.perf_counter() - t))
        rec.items += self.n
        rec.counters["row_bytes"] = self.row_bytes
        self.calls += 1
        if self.pick.random() * self.calls < 1:
            self.kept = (b, out)
        return True

    def close(self):
        """Keep the judged call's batch and output; drop the rest."""
        if self.kept is not None:
            self.inputs = self.batches[self.kept[0]]
        self.batches = self.sort = None

    def judge(self, control=False) -> dict:
        """{name: (value, limit)}; with ``control``, of the reference at
        half the key's width in the program's place."""
        limit = self.limits["mismatched_rows"]
        if self.kept is None:
            return {"mismatched_rows": (self.n, limit)}
        R = self.ref
        ref = R.sort_rows(*self.inputs)
        got = R.sort_rows(*self.inputs, key_bits=self.key_bits // 2) if control else self.kept[1]
        return {"mismatched_rows": (R.mismatched(*got, *ref), limit)}
