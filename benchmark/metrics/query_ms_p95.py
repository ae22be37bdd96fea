"""The nearest-rank 95th percentile of every query's latency in the window,
each from its ``sql()`` call to its result rows on the host."""

from benchmark import stats


def read(rec):
    ms = [1e3 * s for _, s in rec.latencies]
    return stats.nearest_rank(ms, 0.95) if ms else None
