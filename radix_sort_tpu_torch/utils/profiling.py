"""Observability: phase timing and bandwidth accounting.

Counterpart of ``radix_sort_tpu/utils/profiling.py``. The reference reports
only whole-sort wall clock (main.rs:32-44). Here a timed function ends in a
device synchronisation (``utils/timing.sync``) and each phase is reported
against the card's memory speed of light, so regressions are attributable.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from radix_sort_tpu_torch.utils.timing import sync

__all__ = ["PhaseTimer", "speed_of_light_s", "HBM_GBPS"]

# the memory rate of the card the port targets: one NVIDIA H100 SXM, 80 GB
# HBM3 at 3.35 TB/s (NVIDIA's data sheet)
HBM_GBPS = 3350.0


def speed_of_light_s(bytes_moved: int, hbm_gbps: float = HBM_GBPS) -> float:
    """Lower bound on wall-clock for moving ``bytes_moved`` through HBM."""
    return bytes_moved / (hbm_gbps * 1e9)


@dataclass
class PhaseTimer:
    """Accumulates named phase timings with bandwidth annotations.

    with timer.phase("extract", bytes_moved=n * 16):
        out = sync(fn(*args))
    print(timer.report())
    """

    phases: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str, bytes_moved: int = 0):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.phases.append((name, dt, bytes_moved))

    def time_fn(self, name: str, fn, *args, bytes_moved: int = 0):
        """Run ``fn`` once, device-synchronised, recording the phase."""
        with self.phase(name, bytes_moved=bytes_moved):
            out = sync(fn(*args))
        return out

    def report(self) -> str:
        total = sum(dt for _, dt, _ in self.phases)
        lines = [f"{'phase':<20} {'ms':>9} {'share':>7} {'GB/s':>8} {'vs SoL':>7}"]
        for name, dt, nbytes in self.phases:
            gbps = nbytes / dt / 1e9 if nbytes else 0.0
            sol = f"{gbps / HBM_GBPS:6.1%}" if nbytes else "      -"
            gb = f"{gbps:8.1f}" if nbytes else "       -"
            lines.append(f"{name:<20} {dt*1e3:9.2f} {dt/total:6.1%} {gb} {sol}")
        lines.append(f"{'total':<20} {total*1e3:9.2f}")
        return "\n".join(lines)

    @contextlib.contextmanager
    def trace(self, path: str):
        """Context manager: profile the block with ``torch.profiler`` (the
        card's kernels too when there is one) and write a Chrome trace to
        ``path``. Yields the profiler."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(path)
