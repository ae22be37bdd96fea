"""Device milliseconds a distributed sort in its CUB radix sorts (the local
and the final sort of every slot, the splitter sketch's) and their payload
gathers, summed over the cards; a call is one the program's
``dist_sort.CALLS`` counted over the traced window."""

KERNELS = r"(?i)radixsort|fill_reverse_indices|_scatter_gather_elementwise_kernel"


def read(rec):
    calls = rec.counters.get("dist_calls")
    if rec.trace is None or not calls:
        return None
    s, n = rec.trace.device_s(KERNELS)
    return 1e3 * s / calls if n else None
