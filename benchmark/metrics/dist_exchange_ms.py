"""Device milliseconds a distributed sort in copies between two cards (the
profiler's peer-to-peer memcpy), summed over the cards; a call is one the
program's ``dist_sort.CALLS`` counted over the traced window."""

COPIES = r"Memcpy PtoP"


def read(rec):
    calls = rec.counters.get("dist_calls")
    if rec.trace is None or not calls:
        return None
    s, n = rec.trace.device_s(COPIES)
    return 1e3 * s / calls if n else None
