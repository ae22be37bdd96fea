"""Stable (key, payload) row sorts over a mesh of cards through
``radix_sort_tpu_torch.parallel.dist_sort.distributed_sort_pairs``.

Configuration: ``rows`` (in all), ``slots`` (mesh slots: on CUDA one a
card, ``cuda:0`` to ``cuda:<slots-1>``, in one process; on the CPU, in the
tests, that many slots of the CPU), ``key_dtype``, ``payload_dtype``.
Traffic: as :mod:`.sort_pairs` (``keys``, ``key_params``, ``batches``).
Each slot's rows are made on its device from its own stream of the seed;
slot-major order is the global input order. Every call sorts one whole
batch and ends in a sync of every card (the harness's own sync waits for
card 0 alone); a call that reports ``overflow`` counts as failed.

The outputs of one call, drawn from the seed as a reservoir of one, are
kept and judged against the blocked reference of
:mod:`benchmark.reference.dist_sort_pairs`. ``peak_mem_gib`` reads card 0,
the mesh's home, which also holds the gathered splitter sketch; ``close()``
writes every card's peak over the window to stderr, and the growth over
the window of the program's counters (:data:`COUNTERS`, those it has),
which each call also leaves in ``rec.counters`` for the metrics.
"""

from __future__ import annotations

import importlib
import random
import sys
import time

import torch

from benchmark import distributions as D
from benchmark.drivers.sort_pairs import DTYPES, make_keys

# the program's counters, by their names in ``rec.counters``
COUNTERS = {"dist_calls": ("dist_sort", "CALLS"), "dist_overflows": ("dist_sort", "OVERFLOWS"),
            "dist_host_reads": ("dist_sort", "HOST_READS"),
            "peer_bytes": ("collectives", "PEER_BYTES")}


def program_counters() -> dict:
    """The current values of the program's :data:`COUNTERS` that it has."""
    out = {}
    for name, (module, attr) in COUNTERS.items():
        mod = importlib.import_module(f"radix_sort_tpu_torch.parallel.{module}")
        if isinstance(getattr(mod, attr, None), int):
            out[name] = getattr(mod, attr)
    return out


def slot_devices(dev, slots):
    """One device a slot: the first ``slots`` cards, or the CPU ``slots`` times."""
    if not dev.cuda:
        return [torch.device("cpu")] * slots
    found = torch.cuda.device_count()
    if found < slots:
        raise RuntimeError(f"{slots} mesh slots need {slots} cards; {found} visible")
    return [torch.device("cuda", i) for i in range(slots)]


class Session:
    def __init__(self, reg, cfg, traffic, seed, dev):
        t = time.perf_counter()
        from radix_sort_tpu_torch.parallel import dist_sort, runtime

        self.split = [("the program's import", time.perf_counter() - t)]
        t = time.perf_counter()
        self.ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
        slots = cfg["slots"]
        self.devices = slot_devices(dev, slots)
        self.cuda = dev.cuda
        self.mesh = runtime.data_mesh(devices=self.devices)
        self.n, self.limits = cfg["rows"], cfg["limits"]
        if self.n % slots:
            raise ValueError(f"{self.n} rows do not split into {slots} slots")
        per = self.n // slots
        kdt, vdt = DTYPES[cfg["key_dtype"]], DTYPES[cfg["payload_dtype"]]
        gens = [torch.Generator(device=d).manual_seed((seed * slots + s) % 2**64)
                for s, d in enumerate(self.devices)]
        self.batches = []
        for _ in range(traffic["batches"]):
            blocks = [(make_keys(g, per, kdt, traffic), D.uniform(g, per, vdt)) for g in gens]
            self.batches.append((runtime.Sharded(self.mesh, [k for k, _ in blocks]),
                                 runtime.Sharded(self.mesh, [v for _, v in blocks])))
        self.sort = dist_sort.distributed_sort_pairs
        self.cycle = len(self.batches)
        self.calls, self.kept = 0, None
        self.pick = random.Random(seed)
        self.sync()
        self.split.append(("inputs", time.perf_counter() - t))
        t = time.perf_counter()
        # warm-up: each batch once, the previous output held as the window holds one
        held = None
        for keys, values in self.batches:
            out = self.sort(keys, values, self.mesh)
            self.sync()
            held = out
        del held, out
        self.split.append(("warm-up", time.perf_counter() - t))
        if self.cuda:
            for d in self.devices:
                torch.cuda.reset_peak_memory_stats(d)
        self.base = program_counters()

    def counters(self) -> dict:
        """Each program counter's growth since the window opened."""
        now = program_counters()
        return {k: now[k] - v for k, v in self.base.items()}

    def sync(self):
        if self.cuda:
            for d in self.devices:
                torch.cuda.synchronize(d)

    def step(self, rec) -> bool:
        b = self.calls % self.cycle
        t = time.perf_counter()
        out = self.sort(*self.batches[b], self.mesh)
        self.sync()
        rec.latencies.append(("sort", time.perf_counter() - t))
        rec.counters["devices"] = len(self.devices)
        rec.counters.update(self.counters())
        self.calls += 1
        if bool(out[3]):
            return False  # an overflow fell back to the replicated sort
        rec.items += self.n
        if self.pick.random() * self.calls < 1:
            self.kept = (b, out)
        return True

    def close(self):
        """Keep the judged call's batch and output as plain blocks; drop the
        rest. Write every card's peak and the program's counters to stderr."""
        if self.cuda:
            peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in self.devices]
            print("peak GiB by card: " + ", ".join(f"{d} {p:.3f}" for d, p in
                                                   zip(self.devices, peaks)),
                  file=sys.stderr, flush=True)
        print(f"program counters over the window: {self.counters()}", file=sys.stderr,
              flush=True)
        if self.kept is not None:
            b, (keys, values, counts, _) = self.kept
            self.inputs = [x.blocks for x in self.batches[b]]
            self.output = (keys.blocks, values.blocks, [int(c) for c in counts.tolist()])
        self.batches = self.sort = self.kept = None

    def judge(self, control=False) -> dict:
        """{name: (value, limit)}; with ``control``, of the reference at
        half the key's width in the program's place."""
        limit = self.limits["mismatched_rows"]
        if not hasattr(self, "output"):
            return {"mismatched_rows": (self.n, limit)}
        keys, values = self.inputs
        out_keys, out_values, counts = self.output
        bits = 4 * keys[0].element_size() if control else None
        return {"mismatched_rows": (self.ref.mismatched_rows(keys, values, out_keys, out_values,
                                                             counts, key_bits=bits), limit)}
