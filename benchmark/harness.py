"""One run of one cell of ``BENCHMARK.json``: set-up, the timed window, the
judgement of the window's outputs against the plain reference, and the
cell's metrics.

Where each piece lives, by the name ``BENCHMARK.json`` gives it:

- a configuration: the file its entry names; its ``driver`` is the module
  ``benchmark/drivers/<driver>.py`` that makes the inputs, drives the
  program and judges the outputs (each judged number with its limit);
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a query: ``benchmark/queries/<name>.json``;
- a metric: ``benchmark/metrics/<name>.py``, whose ``read(record)``
  returns its value or None (nothing to read: the metric is left out), and
  whose optional ``instrument(record)`` is a context manager held around a
  traced window;
- the device peaks: ``benchmark/peaks.json``, by the device's name.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from benchmark import trace as T

ROOT = Path(__file__).resolve().parent.parent
# top-level module names no run may load: the JAX package, its libraries,
# and the scripts that drive it
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "radix_sort_tpu", "chip_smoke", "bench",
                       "__graft_entry__"})


class Forbidden(RuntimeError):
    """A forbidden module was loaded in the process."""


class Registry:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def _entry(self, key, name):
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"]).read_text())

    def data(self, kind: str, name: str) -> dict:
        """``benchmark/<kind>/<name>.json``: a traffic mix or a query."""
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, name: str):
        """The module of ``benchmark/metrics/<name>.py``."""
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def peaks(self, kind: str):
        return json.loads((self.dir / "peaks.json").read_text()).get(kind)


@dataclass
class Record:
    """What one run saw. ``items`` counts the work of the completed steps
    in the driver's unit (rows sorted, queries answered); ``latencies``
    holds (label, seconds) of every step, ``plan_s`` the seconds the host
    spent compiling each query; drivers and instruments add ``counters``."""

    cell: str
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    completed: int = 0
    items: int = 0
    latencies: list = field(default_factory=list)
    plan_s: list = field(default_factory=list)
    peak_bytes: int = 0
    counters: dict = field(default_factory=dict)
    trace: T.Trace | None = None
    peaks: dict | None = None


class Device:
    """The device a run uses: a CUDA card, or the CPU in the tests."""

    def __init__(self, name: str = "cuda"):
        import torch

        self.torch = torch
        self.t = torch.device(name)
        self.cuda = self.t.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.t)

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.t)

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.t) if self.cuda else 0

    def kind(self) -> str:
        return self.torch.cuda.get_device_name(self.t) if self.cuda else "cpu"


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def window(session, rec: Record, seconds: float):
    """Step the session until ``seconds`` have passed and its cycle is whole."""
    start = time.perf_counter()
    while True:
        try:
            ok = session.step(rec)
        except Exception:  # a call that raised counts as failed; the window goes on
            if rec.failed == 0:
                traceback.print_exc()
            ok = False
        rec.attempted += 1
        if ok:
            rec.completed += 1
        else:
            rec.failed += 1
        now = time.perf_counter()
        if now - start >= seconds and rec.attempted % session.cycle == 0:
            break
    rec.window_s = now - start


def run_cell(reg: Registry, name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t0: float | None = None, split=None):
    """Run cell ``name`` once; returns (the result object, the lines that
    set each compared number beside its limit). ``split``: (phase, seconds)
    of the caller's set-up before this call, printed with the rest."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    split = list(split or [])
    cell = reg.cell(name)
    cfg = reg.config(cell["config"])
    traffic = reg.data("traffic", cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{cfg['driver']}")
    metrics = reg.per_layer(name) if traced else reg.end_to_end(name)
    readers = {m["name"]: reg.reader(m["name"]) for m in metrics}
    dev = Device(device)
    rec = Record(name, seed, peaks=reg.peaks(dev.kind()))

    t = time.perf_counter()
    split.append(("the harness and the card's name", t - t0 - sum(s for _, s in split)))
    session = driver.Session(reg, cfg, traffic, seed, dev)
    dev.sync()
    rec.setup_s = time.perf_counter() - t0
    split += getattr(session, "split", [("session", time.perf_counter() - t)])
    dev.reset_peak()
    traces = []
    with contextlib.ExitStack() as stack:
        if traced:
            for r in readers.values():
                if hasattr(r, "instrument"):
                    stack.enter_context(r.instrument(rec))
            stack.enter_context(T.capture(traces))
        with torch.profiler.record_function(T.WINDOW_SPAN):
            window(session, rec, seconds)
    rec.peak_bytes = dev.peak()
    rec.trace = traces[0] if traces else None

    session.close()
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in session.judge().items()}
    checks["failed"] = {"value": rec.failed, "limit": 0}  # a failed call is never a result
    correct = rec.completed > 0 and all(c["value"] <= c["limit"] for c in checks.values())

    out = {}
    for m in metrics:
        v = readers[m["name"]].read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    info = {"platform": "gpu" if dev.cuda else "cpu", "kind": dev.kind(),
            "count": cell["chips"], "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": out, "device": info}
    if rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s()
        info["window_s"] = rec.trace.window_s
        result["breakdown"] = T.breakdown(rec.trace)
    result["checks"] = checks
    build = sys.modules.get("radix_sort_tpu_torch._build")  # the program's nvcc timings
    lines = [f"card: {power_limit() if dev.cuda else 'cpu'}",
             f"setup_s {rec.setup_s:.3f} (nvcc in it: {getattr(build, 'BUILD_SECONDS', {})}), "
             f"window {rec.window_s:.3f} s, {rec.attempted} calls, {rec.failed} failed",
             "setup split: " + ", ".join(f"{k} {v:.3f} s" for k, v in split)]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    # last, so that the judgement and the readers are held to it too
    loaded = forbidden_modules()
    if loaded:
        raise Forbidden(f"the run loaded {', '.join(loaded)}")
    return result, lines
