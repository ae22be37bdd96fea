"""Plain reference of a stable (key, payload) row sort by unsigned key."""

from __future__ import annotations

import torch

SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}


def _signed(x):
    return x.view(SIGNED[x.dtype])


def sort_rows(keys, values, key_bits=None):
    """The rows sorted stably by the keys' unsigned order; with
    ``key_bits``, by the keys' upper ``key_bits`` bits alone (the control:
    the key at a lower precision than the configuration states)."""
    w = _signed(keys)
    bits = 8 * w.element_size()
    if key_bits is None:
        order = w ^ torch.iinfo(w.dtype).min  # signed order of these = unsigned order of keys
    else:
        order = (w.to(torch.int64) >> (bits - key_bits)) & ((1 << key_bits) - 1)
    perm = torch.sort(order, stable=True).indices
    return w[perm].view(keys.dtype), _signed(values)[perm].view(values.dtype)


def mismatched(got_keys, got_values, ref_keys, ref_values) -> int:
    """Rows whose key or payload differs from the reference's at the same
    position (all rows when the lengths differ)."""
    if got_keys.shape != ref_keys.shape or got_values.shape != ref_values.shape:
        return int(ref_keys.shape[0])
    bad = (_signed(got_keys) != _signed(ref_keys)) | (_signed(got_values) != _signed(ref_values))
    return int(bad.sum())
