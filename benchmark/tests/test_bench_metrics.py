"""The metric arithmetic: K2's bytes, the roofline shares, the device's busy
and idle time over overlapping intervals, the breakdown and p95."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import harness, stats
from benchmark import trace as T
from radix_sort_tpu_torch.ops.expand import Column

BW = 3.35e12


@pytest.fixture(scope="module")
def readers(reg):
    return {m["name"]: reg.reader(m["name"])
            for m in reg.spec["end_to_end"] + reg.spec["per_layer"]}


def test_every_metric_has_a_reader(readers, reg):
    assert set(readers) == {m["name"] for m in reg.spec["end_to_end"] + reg.spec["per_layer"]}
    assert all(hasattr(r, "read") for r in readers.values())


def test_k2_bytes_on_hand_built_calls(readers):
    k2 = readers["k2_roofline_pct"]
    i32 = torch.int32
    # broadcast only: 3 runs into 16 slots, one 4-byte and one 8-byte column
    ends = torch.tensor([2, 2, 7], dtype=i32)
    cols = [Column(torch.zeros(3, dtype=i32)), Column(torch.zeros(3, dtype=torch.int64))]
    assert k2.k2_bytes(ends, None, cols, 16) == 4 + 4 * 3 + 4 * (16 + 3) + 8 * (16 + 3)
    # a copied column: emits (2, 0, 5) capped by m_copy (1, 4, 9) copy 1 + 0 + 5 rows
    m_copy = torch.tensor([1, 4, 9], dtype=i32)
    cols = [Column(torch.zeros(3, dtype=i32)), Column(torch.zeros(10, dtype=torch.int64), True)]
    want = 4 + 4 * 3 + 8 * 3 + 4 * (16 + 3) + 8 * (16 + 6)
    assert k2.k2_bytes(ends, m_copy, cols, 16) == want
    assert k2.fixed_bytes(3, cols, 16) + 6 * 8 == want


def trace_of(device, window=(0.0, 10.0), host=()):
    return T.Trace(window, sorted(device, key=lambda x: x[1]), sorted(host, key=lambda x: x[1]))


def test_busy_and_idle_over_overlapping_intervals():
    t = trace_of([("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 2.5, 3.0), ("d", 6.0, 7.0),
                  ("a", 7.0, 8.0)])
    assert T.merge([(s, e) for _, s, e in t.device]) == [(1.0, 4.0), (6.0, 8.0)]
    assert t.busy_s() == 5.0
    assert T.idle_gaps(t) == [(0.0, 1.0), (4.0, 6.0), (8.0, 10.0)]
    assert t.device_s("^a$") == (3.0, 2)
    assert t.device_s("zzz") == (0.0, 0)


def test_idle_named_by_the_innermost_host_span():
    host = [("bench.window", 0.0, 10.0), ("aten::item", 4.5, 5.5), ("aten::nonzero", 4.6, 5.4),
            ("bench.sql", 8.0, 10.0)]
    t = trace_of([("k", 1.0, 4.0), ("k", 6.0, 8.0)], host=host)
    assert T.host_at(t.host, [0.5, 5.0, 9.0, 11.0]) == ["bench.window", "aten::nonzero",
                                                        "bench.sql", "host"]
    b = T.breakdown(t)
    assert b["device_ops"] == [["k", 5.0]]
    assert b["idle_gaps"] == [["aten::nonzero", 2.0], ["bench.sql", 2.0], ["bench.window", 1.0]]


def record(**kw):
    rec = harness.Record("cell", 1, peaks={"hbm_bytes_per_s": BW})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_idle_share(readers):
    rec = record(trace=trace_of([("k", 0.0, 2.5), ("k", 2.0, 7.5)]))
    for name in ("device_idle_pct.sort", "device_idle_pct.query"):
        assert readers[name].read(rec) == pytest.approx(25.0)
        assert readers[name].read(record(trace=trace_of([]))) is None


def test_sort_roofline_share(readers):
    # 250M (u64, u64) rows sorted 10 times, the device busy 0.5 s of it
    rec = record(items=2_500_000_000, counters={"row_bytes": 16},
                 trace=trace_of([("sort", 0.0, 0.5)], window=(0.0, 0.6)))
    want = 100 * 32 * 2_500_000_000 / BW / 0.5
    assert readers["sort_roofline_pct"].read(rec) == pytest.approx(want)
    assert readers["sort_roofline_pct"].read(record(items=1)) is None  # no trace


def test_k2_roofline_share(readers):
    rec = record(counters={"k2_bytes": 3.35e9, "k2_launches": 2},
                 trace=trace_of([("expand_rows(int const*, int)", 0.0, 0.002),
                                 ("other", 0.002, 0.003),
                                 ("expand_rows(int const*, int)", 0.003, 0.005)]))
    assert readers["k2_roofline_pct"].read(rec) == pytest.approx(25.0)
    assert readers["k2_roofline_pct"].read(record(counters={"k2_bytes": 0, "k2_launches": 0},
                                                  trace=rec.trace)) is None


def test_kernel_time_per_query(readers):
    rec = record(completed=4, trace=trace_of([
        ("void at::native::indexFuncLargeIndex<double>(...)", 0.0, 0.2),
        ("void cub::DeviceRadixSortOnesweepKernel<...>", 0.2, 0.3),
        ("void at::native::vectorized_elementwise_kernel<...>", 0.3, 0.4)]))
    assert readers["scatter_ms"].read(rec) == pytest.approx(50.0)
    assert readers["sort_kernel_ms.query"].read(rec) == pytest.approx(25.0)


def test_host_clock_metrics(readers):
    lat = [("Q", s / 1000) for s in range(1, 201)]  # 1..200 ms
    rec = record(window_s=20.0, completed=200, items=200, latencies=lat,
                 plan_s=[0.001, 0.003], setup_s=7.5, peak_bytes=3 * 2**30)
    assert readers["query_ms"].read(rec) == pytest.approx(100.0)
    assert readers["query_ms_p95"].read(rec) == pytest.approx(190.0)
    assert readers["plan_ms"].read(rec) == pytest.approx(2.0)
    assert readers["setup_s"].read(rec) == 7.5
    assert readers["peak_mem_gib"].read(rec) == 3.0
    assert readers["sort_rows_per_s"].read(record(items=10**9, window_s=2.0)) == 5e8


@pytest.mark.parametrize("n", [199, 200, 222])
def test_p95_with_its_sample_count(n):
    xs = list(range(1, n + 1))
    p95 = stats.nearest_rank(xs, 0.95)
    assert sum(x > p95 for x in xs) == n - math.ceil(0.95 * n)  # 9, 10, 11 beyond
    assert sum(x <= p95 for x in xs) >= 0.95 * n


def test_nearest_rank():
    xs = list(range(1, 201))
    assert stats.nearest_rank([5.0], 0.95) == 5.0
    assert stats.nearest_rank(list(reversed(xs)), 0.5) == 100
    with pytest.raises(ValueError):
        stats.nearest_rank([], 0.95)



class Event:
    """A kineto event as the profiler hands it over; ``act`` None stands
    for a PyTorch whose events name no activity type."""

    def __init__(self, name, cuda, start, dur, act=None, tid=1):
        self._v = (name, cuda, start, dur, tid)
        if act is not None:
            self.activity_type = lambda: act

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]


@pytest.mark.parametrize("typed", [False, True])
def test_trace_from_profiler_events(typed):
    def ev(name, cuda, start, dur, act, tid=1):
        return Event(name, cuda, start, dur, act if typed else None, tid)

    events = [ev(T.WINDOW_SPAN, False, 100, 1000, "user_annotation"),
              ev(T.WINDOW_SPAN, True, 150, 900, "gpu_user_annotation"),
              ev("aten::sort", False, 120, 300, "cpu_op"),
              ev("cudaLaunchKernel", False, 130, 5, "cuda_runtime"),
              ev("aten::add", False, 500, 10, "cpu_op", tid=2),
              ev("sortKernel", True, 150, 200, "kernel"),
              ev("Memcpy DtoD (Device -> Device)", True, 400, 100, "gpu_memcpy"),
              ev("late", True, 1050, 100, "kernel")]
    t = T.from_events(events)
    assert t.window == pytest.approx((100e-9, 1100e-9))
    assert [n for n, _, _ in t.device] == ["sortKernel", "Memcpy DtoD (Device -> Device)", "late"]
    assert t.device[-1][2] == pytest.approx(1100e-9)  # clipped to the window
    assert [n for n, _, _ in t.host] == ["aten::sort"]
    assert t.busy_s() == pytest.approx(350e-9)
