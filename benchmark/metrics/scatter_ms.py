"""Device milliseconds per completed query in scatter kernels, by kernel
name: ``index_add_`` (``indexFunc*Index``), ``scatter_reduce`` and
``scatter_`` (the scatter-like instances of the scatter/gather kernel, whose
gather instances are left out) and scatters of a fill value."""

KERNELS = (r"indexFunc(Small|Large)Index|_cuda_scatter_gather_internal_kernel<true"
           r"|_cuda_scatter_fill_internal_kernel")


def read(rec):
    if rec.trace is None or not rec.completed:
        return None
    s, n = rec.trace.device_s(KERNELS)
    return 1e3 * s / rec.completed if n else None
