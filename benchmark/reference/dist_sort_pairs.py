"""Plain reference of a stable (key, payload) row sort whose rows lie on
several devices, worked out in key-range blocks so that each block fits on
one device.

The input is one row block a device, and slot-major order is the global
input order. The program's output is one block a slot whose first
``counts[s]`` rows are valid; their concatenation in slot order is to be
the global stable sort by unsigned key. The blocks' bounds are keys, so
each key's whole run of equal rows falls in one block, where
``sort_pairs.sort_rows`` sorts it stably from the rows taken in global
input order.
"""

from __future__ import annotations

import torch

from benchmark.reference.sort_pairs import SIGNED, mismatched, sort_rows

BLOCK_ROWS = 1 << 28  # rows a block holds about: 4 GiB of (u64, u64) rows
SAMPLE = 1 << 20  # keys sampled to place the blocks' bounds


def _signed(x):
    return x.view(SIGNED[x.dtype])


def _order(keys):
    """Signed words whose order is the keys' unsigned order."""
    w = _signed(keys)
    return w ^ torch.iinfo(w.dtype).min


def block_bounds(orders, block_rows, device, sample=SAMPLE):
    """Ascending bounds, host ints in the words of :func:`_order`, that cut
    the rows into blocks of about ``block_rows``: the quantiles of an
    evenly strided sample of the keys. Each quantile's key gets a block of
    its own (a bound after it too), so that a key holding more rows than a
    block holds them alone."""
    n = sum(o.shape[0] for o in orders)
    parts = -(-n // block_rows)
    if parts <= 1:
        return []
    stride = max(1, n // sample)
    s = torch.sort(torch.cat([o[::stride].to(device) for o in orders])).values
    q = s[torch.arange(1, parts, device=device) * s.shape[0] // parts].tolist()
    top = torch.iinfo(s.dtype).max
    return sorted(set(q) | {v + 1 for v in q if v < top})


def _block(orders, keys, values, lo, hi, device):
    """The rows whose key lies in [lo, hi) (None: unbounded), in global
    input order, on ``device``."""
    ks, vs = [], []
    for o, k, v in zip(orders, keys, values):
        m = torch.ones_like(o, dtype=torch.bool)
        if lo is not None:
            m &= o >= lo
        if hi is not None:
            m &= o < hi
        idx = torch.nonzero(m).reshape(-1)
        ks.append(_signed(k)[idx].to(device))
        vs.append(_signed(v)[idx].to(device))
    return torch.cat(ks).view(keys[0].dtype), torch.cat(vs).view(values[0].dtype)


def _segment(out, counts, start, end, device):
    """Positions [start, end) of the concatenated valid prefixes of the
    slots' blocks ``out``, on ``device`` (shorter where they run out)."""
    parts, at = [], 0
    for x, c in zip(out, counts):
        a, b = max(start, at), min(end, at + c)
        if a < b:
            parts.append(_signed(x)[a - at:b - at].to(device))
        at += c
    if not parts:
        return _signed(out[0])[:0].to(device).view(out[0].dtype)
    return torch.cat(parts).view(out[0].dtype)


def mismatched_rows(keys, values, out_keys, out_values, counts, *, block_rows=BLOCK_ROWS,
                    key_bits=None) -> int:
    """Rows of the program's concatenated valid prefixes that differ from
    the global stable sort of the input (a whole block's rows where its
    length differs), plus the row count N when ``counts`` do not sum to N.

    ``keys`` / ``values``: the input's blocks in global order;
    ``out_keys`` / ``out_values``: each slot's output block; ``counts``:
    host ints. With ``key_bits`` (the control), each block's rows sorted by
    the keys' upper ``key_bits`` bits stand in for the program's output."""
    device = keys[0].device
    n = sum(k.shape[0] for k in keys)
    orders = [_order(k) for k in keys]
    cuts = [None] + block_bounds(orders, block_rows, device) + [None]
    bad = 0 if sum(counts) == n else n
    start = 0
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        bk, bv = _block(orders, keys, values, lo, hi, device)
        ref = sort_rows(bk, bv)
        end = start + bk.shape[0]
        if key_bits is None:
            got = (_segment(out_keys, counts, start, end, device),
                   _segment(out_values, counts, start, end, device))
        else:
            got = sort_rows(bk, bv, key_bits=key_bits)
        bad += mismatched(*got, *ref)
        start = end
    return bad
