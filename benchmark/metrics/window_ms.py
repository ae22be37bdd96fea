"""Device milliseconds per completed query on the device side of the
program's window range (``ops/window.WINDOW_RANGE``, one range a window
call), as the trace records a range where the profiler names no activity
type. None where the program has no such range."""

RANGE = r"^query window$"


def read(rec):
    if rec.trace is None or not rec.completed:
        return None
    s, n = rec.trace.device_s(RANGE)
    return 1e3 * s / rec.completed if n else None
