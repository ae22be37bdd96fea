"""``ss_roofline_pct``: the bytes its instrument counts at each launch of the
segmented-sum kernel, the share it reads from a trace, and silence where
the program has no such kernel (the parent of the change that added it)."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark import harness
from benchmark import trace as T
from radix_sort_tpu_torch.ops import segment_sum

BW = 3.35e12


@pytest.fixture(scope="module")
def ss(reg):
    return reg.reader("ss_roofline_pct")


def _record(**kw):
    rec = harness.Record("cell", 1, peaks={"hbm_bytes_per_s": BW})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_instrument_counts_each_launch(ss, monkeypatch):
    def fake_launch(x, gid, out):  # the kernel's launch, on the CPU
        segment_sum.LAUNCHES += 1
        out.copy_(segment_sum.segment_sum_sorted_plain(x, gid))

    monkeypatch.setattr(segment_sum, "launch", fake_launch)
    rec = _record()
    x32 = torch.ones(1000, dtype=torch.float32)
    x64 = torch.ones(300, dtype=torch.float64)
    gid = torch.zeros(1000, dtype=torch.int64)
    with ss.instrument(rec):
        for x in (x32, x64):
            segment_sum.launch(x, gid[:x.shape[0]], torch.empty_like(x))
    assert segment_sum.launch is fake_launch  # unwrapped again
    assert rec.counters == {"ss_bytes": 2 * 4 * 1000 + 2 * 8 * 300, "ss_launches": 2}
    assert ss.call_bytes(x64) == 2 * 8 * 300


def test_share_of_the_roofline(ss):
    names = ["void (anonymous namespace)::segment_sum_tiles<float>(float const*, long long "
             "const*, long long, bool, float*, long long*, double*)",
             "void (anonymous namespace)::segment_sum_carries<float>(long long const*, double "
             "const*, long long, long long, float*)"]
    trace = T.Trace((0.0, 1.0), [(names[0], 0.0, 0.003), ("other", 0.003, 0.5),
                                 (names[1], 0.5, 0.501)])
    rec = _record(counters={"ss_bytes": 6.7e9, "ss_launches": 1}, trace=trace)
    assert ss.read(rec) == pytest.approx(100 * 6.7e9 / BW / 0.004)
    # nothing launched, no trace, or no such kernel in it: left out
    assert ss.read(_record(counters={"ss_bytes": 0, "ss_launches": 0}, trace=trace)) is None
    assert ss.read(_record(counters={"ss_bytes": 6.7e9, "ss_launches": 1})) is None
    other = T.Trace((0.0, 1.0), [("indexFuncLargeIndex<double>", 0.0, 0.5)])
    assert ss.read(_record(counters={"ss_bytes": 6.7e9, "ss_launches": 1}, trace=other)) is None


def test_silent_without_the_kernel(ss, monkeypatch):
    """A program with no ``ops/segment_sum`` module: the instrument counts
    nothing and raises nothing, and the metric is left out."""
    import radix_sort_tpu_torch.ops as ops

    monkeypatch.setitem(sys.modules, "radix_sort_tpu_torch.ops.segment_sum", None)
    monkeypatch.delattr(ops, "segment_sum")
    rec = _record(trace=T.Trace((0.0, 1.0), [("k", 0.0, 0.5)]))
    with ss.instrument(rec):
        pass
    assert rec.counters == {}
    assert ss.read(rec) is None
