"""NULL-value support: per-column null masks.

Counterpart of ``radix_sort_tpu/nulls.py``. A nullable column carries a
companion bool mask (True = NULL), stored in ``Table``'s column dict under a
hidden name (``name + "\\x00null"``), with one invariant the engine relies
on: **values are 0 wherever the mask is True.** So:

  - every row-permuting operator (filter, sort payloads, top_k, limit,
    unnest, join gathers) carries the mask as one more column;
  - grouping operators (distinct, GROUP BY, set operators) add the mask as
    one key word per nullable key: all NULLs share the value 0, so NULL
    groups with NULL and nothing else;
  - ordering operators put the mask word first, so NULL sorts as
    +infinity (last ascending, first descending);
  - joins extend the never-match flag word (left padding 1, right padding
    2) with left NULL 3 and right NULL 4: NULL keys match nothing, while
    outer joins still emit them unmatched;
  - aggregates skip NULLs by substitution (sums ignore the 0-filled cells,
    min / max substitute the dtype's extremes, counts sum the non-null
    indicator), and a non-null count per group makes all-NULL groups NULL.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MaskedColumn", "NULL_SUFFIX", "mask_name", "is_mask_name", "base_name", "detect",
           "dtype_max", "dtype_min", "merge_masks"]

NULL_SUFFIX = "\x00null"


def mask_name(name: str) -> str:
    """The hidden companion-column name of ``name``'s null mask."""
    return name + NULL_SUFFIX


def is_mask_name(name: str) -> bool:
    return name.endswith(NULL_SUFFIX)


def base_name(name: str) -> str:
    """Owning column name of a mask column name."""
    return name[: -len(NULL_SUFFIX)]


class MaskedColumn:
    """A (values, null-mask) pair for passing nullable data through APIs
    that move single columns (``with_columns``, aggregate value columns,
    window value columns). ``mask`` is bool, True = NULL."""

    __slots__ = ("values", "mask")

    def __init__(self, values, mask):
        self.values = values
        self.mask = mask

    def __repr__(self):
        return f"MaskedColumn({self.values!r}, mask={self.mask!r})"


def _bool_tensor(m):
    return m.to(torch.bool) if torch.is_tensor(m) else torch.from_numpy(
        np.ascontiguousarray(m, dtype=bool))


def detect(x):
    """Recognize nullable input -> ``(values, bool mask tensor)``, or None
    when ``x`` carries no null information.

    Accepts :class:`MaskedColumn`, ``np.ma.MaskedArray``, and host lists /
    object arrays containing ``None`` entries (string data with ``None``
    becomes ``""`` + mask; numeric data becomes 0 + mask). Values come back
    as given (host data as numpy); the mask is a tensor on the values'
    device, or on the CPU for host data."""
    if isinstance(x, MaskedColumn):
        m = _bool_tensor(x.mask)
        if torch.is_tensor(x.values):
            m = m.to(x.values.device)
        return x.values, m
    if isinstance(x, np.ma.MaskedArray):
        m = np.ma.getmaskarray(x)
        data = np.ma.getdata(x).copy()
        if data.dtype.kind in ("U", "S", "O"):
            data[m] = "" if data.dtype.kind != "S" else b""
        else:
            data[m] = 0
        return data, _bool_tensor(m)
    if isinstance(x, (list, tuple)) or (isinstance(x, np.ndarray) and x.dtype.kind == "O"):
        vals = list(x)
        if not any(v is None for v in vals):
            return None
        m = _bool_tensor(np.array([v is None for v in vals], dtype=bool))
        rest = [v for v in vals if v is not None]
        if rest and all(isinstance(v, (str, bytes)) for v in rest):
            return np.asarray(["" if v is None else v for v in vals], dtype=np.str_), m
        return np.asarray([0 if v is None else v for v in vals]), m
    return None


def _extreme(dt, top):
    """A 0-dim tensor of ``dt`` holding its largest (``top``) or smallest
    value; unsigned dtypes are built on their signed view."""
    if dt.is_floating_point:
        return torch.tensor(float("inf") if top else float("-inf"), dtype=dt)
    if dt == torch.bool:
        return torch.tensor(top)
    unsigned = not dt.is_signed
    if unsigned and dt != torch.uint8:
        sdt = {torch.uint16: torch.int16, torch.uint32: torch.int32,
               torch.uint64: torch.int64}[dt]
        return torch.tensor(-1 if top else 0, dtype=sdt).view(dt)
    info = torch.iinfo(dt)
    return torch.tensor(info.max if top else info.min, dtype=dt)


def dtype_max(dt):
    """The dtype's +infinity surrogate (for NULL-skipping min)."""
    return _extreme(dt, True)


def dtype_min(dt):
    """The dtype's -infinity surrogate (for NULL-skipping max)."""
    return _extreme(dt, False)


def merge_masks(a, b):
    """OR of two optional masks (None = no nulls)."""
    if a is None:
        return b
    if b is None:
        return a
    return a | b
