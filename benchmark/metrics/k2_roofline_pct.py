"""K2's share of its roofline over the traced window: the bytes every
expansion must move, over the card's memory bandwidth, against the device
time of K2's kernel (``csrc/expand.cu``). The bytes of each call of
``ops/expand.expand_rows`` are counted at the call, on the device, so the
window waits for nothing; ``ops/expand.LAUNCHES`` counts the launches."""

import contextlib

import torch

KERNEL = r"(^|::)expand_rows\("  # "(anonymous namespace)::expand_rows(int const*, ..."


def fixed_bytes(n_runs, columns, capacity):
    """What one expansion moves whatever its run lengths: the count, the
    run ends, each copied column's (lo, m_copy) window, every output slot
    written once at its column's width, each broadcast value read once."""
    copied = any(c.copied for c in columns)
    return (4 + 4 * n_runs + (8 * n_runs if copied else 0)
            + sum(c.values.element_size() * (capacity + (0 if c.copied else n_runs))
                  for c in columns))


def copied_rows(ends, m_copy):
    """The copied rows, a device scalar: each run's emits, capped by its
    copy window."""
    emits = torch.diff(ends, prepend=ends.new_zeros((1,)))
    return torch.minimum(m_copy, emits).clamp(min=0).sum(dtype=torch.int64)


def k2_bytes(ends, m_copy, columns, capacity):
    """The bytes one expansion must move (each copied value read once too)."""
    copied = [c for c in columns if c.copied]
    rows = int(copied_rows(ends, m_copy)) if copied else 0
    return (fixed_bytes(ends.shape[0], columns, capacity)
            + rows * sum(c.values.element_size() for c in copied))


@contextlib.contextmanager
def instrument(rec):
    from radix_sort_tpu_torch.ops import expand

    real, start = expand.expand_rows, expand.LAUNCHES
    fixed, on_device = 0, []

    def counted(ends, lo, m_copy, columns, *, capacity):
        nonlocal fixed
        fixed += fixed_bytes(ends.shape[0], columns, capacity)
        width = sum(c.values.element_size() for c in columns if c.copied)
        if width:
            on_device.append(copied_rows(ends, m_copy) * width)
        return real(ends, lo, m_copy, columns, capacity=capacity)

    expand.expand_rows = counted
    try:
        yield
    finally:
        expand.expand_rows = real
        rec.counters["k2_bytes"] = fixed + sum(int(b) for b in on_device)
        rec.counters["k2_launches"] = expand.LAUNCHES - start


def read(rec):
    if rec.trace is None or rec.peaks is None or not rec.counters.get("k2_launches"):
        return None
    s, n = rec.trace.device_s(KERNEL)
    return 100 * rec.counters["k2_bytes"] / rec.peaks["hbm_bytes_per_s"] / s if n else None
