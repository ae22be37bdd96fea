"""SS's share of its roofline over the traced window: the bytes each launch
of the program's segmented-sum kernel (``ops/segment_sum.launch``, the
float sums of GROUP BY) must move, over the card's memory bandwidth,
against the device time of SS's two kernels (``csrc/segment_sum.cu``). A
call of n rows must read the column once and write each of its n output
rows once (the groups' sums, and +0.0 past them): 2 n bytes of the
column's width, known on the host, so the window waits for nothing.
``ops/segment_sum.LAUNCHES`` counts the launches. A program without the
kernel counts nothing, and the metric is left out."""

import contextlib

# "(anonymous namespace)::segment_sum_tiles<float>(float const*, ..."
KERNEL = r"(^|::)segment_sum_(tiles|carries)<"


def call_bytes(x):
    """The bytes one call over column ``x`` must move."""
    return 2 * x.shape[0] * x.element_size()


@contextlib.contextmanager
def instrument(rec):
    try:
        from radix_sort_tpu_torch.ops import segment_sum
    except ImportError:  # a program that sums groups otherwise
        yield
        return
    real, start = segment_sum.launch, segment_sum.LAUNCHES
    total = 0

    def counted(x, gid, out):
        nonlocal total
        total += call_bytes(x)
        return real(x, gid, out)

    segment_sum.launch = counted
    try:
        yield
    finally:
        segment_sum.launch = real
        rec.counters["ss_bytes"] = total
        rec.counters["ss_launches"] = segment_sum.LAUNCHES - start


def read(rec):
    if rec.trace is None or rec.peaks is None or not rec.counters.get("ss_launches"):
        return None
    s, n = rec.trace.device_s(KERNEL)
    return 100 * rec.counters["ss_bytes"] / rec.peaks["hbm_bytes_per_s"] / s if n else None
