"""The device's idle share of the traced window in the sort cells
(``trace.idle_pct``). One reader a metric name: the same quantity moves a
different end-to-end metric in each kind of cell."""

from benchmark import trace as T


def read(rec):
    return T.idle_pct(rec.trace)
