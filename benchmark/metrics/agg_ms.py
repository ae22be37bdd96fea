"""Device milliseconds per completed query on the device side of the
program's aggregate range (``ops/query.AGG_RANGE``, one range a top-level
aggregate call), as the trace records a range where the profiler names no
activity type. None where the program has no such range."""

RANGE = r"^query aggregate$"


def read(rec):
    if rec.trace is None or not rec.completed:
        return None
    s, n = rec.trace.device_s(RANGE)
    return 1e3 * s / rec.completed if n else None
