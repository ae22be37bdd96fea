"""Device milliseconds a distributed sort in the merge of the received runs
(the program's kernels named ``merge_sorted_runs``: the partition pass and
the merge), summed over the cards; a call is one the program's
``dist_sort.CALLS`` counted over the traced window. None where no such
kernel ran (a program that sorts the received runs again)."""

KERNELS = r"merge_sorted_runs"


def read(rec):
    calls = rec.counters.get("dist_calls")
    if rec.trace is None or not calls:
        return None
    s, n = rec.trace.device_s(KERNELS)
    return 1e3 * s / calls if n else None
