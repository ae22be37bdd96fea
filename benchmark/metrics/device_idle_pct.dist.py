"""The mean card's idle share of the traced window in the distributed
cells: 100 (1 - the device activities' summed seconds / (cards x window)).
The trace holds no device index; each card runs its kernels, and the copies
it issues, on its one stream, so its activities do not overlap and their
sum over every card is the cards' summed busy time. A device event named
as a host span on the window's thread is that span's device-side range
(where the profiler names no activity type), not an activity."""


def read(rec):
    trace, cards = rec.trace, rec.counters.get("devices")
    if trace is None or not trace.device or not cards:
        return None
    ranges = {name for name, _, _ in trace.host}
    busy = sum(e - s for name, s, e in trace.device if name not in ranges)
    return 100 * (1 - busy / (cards * trace.window_s))
