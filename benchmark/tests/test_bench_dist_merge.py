"""``dist_merge_ms``: the device time a distributed sort spends in the
merge of its received runs, read from hand-built traces; nothing where the
program ran no merge kernel (a program that sorts the received runs
again), so that the metric is left out and nothing raises."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark import trace as T

PARTITION = "void (anonymous namespace)::merge_sorted_runs_partition<long long>(long long const*)"
MERGE = "void (anonymous namespace)::merge_sorted_runs<long long>(long long const*, int)"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>"


@pytest.fixture(scope="module")
def reader(reg):
    return reg.reader("dist_merge_ms")


def record(calls, device):
    rec = harness.Record("sort-dist-4chip", 1, peaks={"hbm_bytes_per_s": 3.35e12})
    rec.counters = {"dist_calls": calls} if calls is not None else {}
    rec.trace = T.Trace((0.0, 10.0), sorted(device, key=lambda x: x[1]), [])
    return rec


def test_the_entry_is_a_per_layer_metric_of_the_cell(reg):
    entry = next(m for m in reg.spec["per_layer"] if m["name"] == "dist_merge_ms")
    assert entry["moves"] == "sort_rows_per_s" and entry["workloads"] == ["sort-dist-4chip"]
    assert entry["layer"] == next(m["layer"] for m in reg.spec["per_layer"]
                                  if m["name"] == "dist_sort_kernel_ms")


def test_merge_time_a_call_summed_over_the_cards(reader):
    # two calls on two cards: each card's partition and merge, and a sort
    device = []
    for card_start in (0.0, 0.5):
        for call in (0.0, 2.0):
            t = card_start + call
            device += [(PARTITION, t, t + 0.001), (MERGE, t + 0.001, t + 0.005),
                       (SORT, t + 0.005, t + 0.05)]
    assert reader.read(record(2, device)) == pytest.approx(1e3 * 4 * 0.005 / 2)


@pytest.mark.parametrize("calls,device", [
    (2, [(SORT, 0.0, 0.05)]),  # the received runs sorted again: no merge kernel
    (0, [(MERGE, 0.0, 0.005)]),  # no distributed sort counted
    (None, [(MERGE, 0.0, 0.005)]),  # a program without the counter
])
def test_nothing_to_read(reader, calls, device):
    assert reader.read(record(calls, device)) is None


def test_no_trace(reader):
    rec = record(2, [])
    rec.trace = None
    assert reader.read(rec) is None
