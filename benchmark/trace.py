"""The traced window: device activity and host spans from ``torch.profiler``.

The harness wraps the timed window in :data:`WINDOW_SPAN`; :func:`capture`
reads the profiler's events once the window has closed into a
:class:`Trace`, whose times are seconds on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "bench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")
TOP = 10  # entries in each list of the breakdown
NAME_CHARS = 120  # a kernel's name is cut to this many characters in the breakdown


@dataclass
class Trace:
    """``window``: (start, end) of the traced window; ``device``: (name,
    start, end) of every device activity that overlaps it, clipped to it,
    in order of start; ``host``: (name, start, end) of the host spans on the
    window's thread, in order of start."""

    window: tuple[float, float]
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in which some device activity ran."""
        return sum(e - s for s, e in merge((s, e) for _, s, e in self.device))

    def device_s(self, pattern: str) -> tuple[float, int]:
        """(seconds, count) of the device activities whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [e - s for name, s, e in self.device if rx.search(name)]
        return sum(hits), len(hits)


def merge(intervals):
    """The union of (start, end) intervals as disjoint intervals in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_pct(trace: Trace | None):
    """The share of the window, in %, in which no device activity ran (the
    union of kernel, copy and set intervals); None where no trace or no
    device activity was recorded."""
    if trace is None or not trace.device:
        return None
    return 100 * (1 - trace.busy_s() / trace.window_s)


def idle_gaps(trace: Trace):
    """The (start, end) stretches of the window in which no device activity ran."""
    gaps, t = [], trace.window[0]
    for s, e in merge((s, e) for _, s, e in trace.device):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.window[1] > t:
        gaps.append((t, trace.window[1]))
    return gaps


def host_at(host, points):
    """The name of the innermost host span around each point (``"host"``
    where none is); ``host`` nests, as the spans of one thread do."""
    spans = sorted(host, key=lambda x: (x[1], -x[2]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    names = [None] * len(points)
    stack, j = [], 0
    for i in order:
        p = points[i]
        while j < len(spans) and spans[j][1] <= p:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        names[i] = stack[-1][0] if stack else "host"
    return names


def breakdown(trace: Trace) -> dict:
    """The device activities that took most time, by name, and the idle
    time of the device summed by what the host was doing meanwhile (the
    innermost host span at the middle of each gap), each the top
    :data:`TOP`, in seconds."""
    ops = defaultdict(float)
    for name, s, e in trace.device:
        ops[name[:NAME_CHARS]] += e - s
    gaps = idle_gaps(trace)
    idle = defaultdict(float)
    for (s, e), name in zip(gaps, host_at(trace.host, [(s + e) / 2 for s, e in gaps])):
        idle[name[:NAME_CHARS]] += e - s

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def _activity(ev):
    """The event's activity type ("kernel", "cpu_op", ...), or None where the
    profiler names none (PyTorch 2.11 does not)."""
    get = getattr(ev, "activity_type", None)
    return get() if get else None


def from_events(events) -> Trace:
    """A :class:`Trace` from the profiler's kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window, device, host = None, [], []
    for ev in events:
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name, act = ev.name(), _activity(ev)
        if ev.device_type() == cuda:
            # without activity types, leave out the device side of the
            # harness's own spans
            if act in DEVICE_ACTIVITIES or (act is None and not name.startswith("bench.")):
                device.append((name, s, e))
        elif name == WINDOW_SPAN and window is None:
            window = (s, e, ev.start_thread_id())
        elif act in HOST_ACTIVITIES or (act is None and not name.startswith("cu")):
            # without activity types, leave out the CUDA runtime calls
            host.append((name, s, e, ev.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1, tid = window
    device = sorted(((n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1),
                    key=lambda x: x[1])
    host = sorted(((n, s, e) for n, s, e, t in host if t == tid and e > w0 and s < w1),
                  key=lambda x: x[1])
    return Trace((w0, w1), device, host)


@contextlib.contextmanager
def capture(holder: list):
    """Profile the CPU and the CUDA device; on exit append the
    :class:`Trace` of the :data:`WINDOW_SPAN` span run inside."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    holder.append(from_events(prof.profiler.kineto_results.events()))

