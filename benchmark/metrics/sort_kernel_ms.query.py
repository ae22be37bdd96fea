"""Device milliseconds per completed query in sort kernels, by kernel name:
CUB's radix sorts, PyTorch's index fill for a stable sort, and its own
segmented and small sorts."""

KERNELS = (r"(?i)radixsort|radix_sort|fill_reverse_indices|sortkv|sort_postprocess"
           r"|segmented_sort|bitonicsort")


def read(rec):
    if rec.trace is None or not rec.completed:
        return None
    s, n = rec.trace.device_s(KERNELS)
    return 1e3 * s / rec.completed if n else None
