"""What the TPC-H answers share: near-exact group sums, the answer's form,
the lower precision of the control, and the comparison."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

# the control's precision: the nearest below the one each column states
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
BIG = 1e300  # a gap that is not a finite number reads as this


def dtypes(lower: bool):
    """(float64, float32) as the configuration states them, or one step below."""
    return (LOWER[torch.float64], LOWER[torch.float32]) if lower else (torch.float64,
                                                                        torch.float32)


def exact_sums(x, inv, groups):
    """Per-group sums of ``x`` as near-exact float64: each value splits into
    a multiple of 2**-20, summed exactly in int64, and a remainder below
    2**-21, summed in float64. Exact to a few float64 ULP of the sum while
    the sum of |x| stays below 2**43."""
    x = x.to(torch.float64)
    q = torch.round(x * 2.0**20)
    lo = x - q / 2.0**20
    s = torch.zeros(groups, dtype=torch.int64, device=x.device).index_add_(
        0, inv, q.to(torch.int64))
    return s.to(torch.float64) / 2.0**20 + torch.zeros(
        groups, dtype=torch.float64, device=x.device).index_add_(0, inv, lo)


def sums(x, inv, groups, dtype, lower):
    """Per-group sums of ``x``: near-exact, or accumulated in ``dtype`` (the
    control)."""
    if lower:
        return torch.zeros(groups, dtype=dtype, device=x.device).index_add_(0, inv, x.to(dtype))
    return exact_sums(x, inv, groups)


def abs_sums(x, inv, groups):
    return torch.zeros(groups, dtype=torch.float64, device=x.device).index_add_(
        0, inv, x.to(torch.float64).abs())


def host(x):
    """A small result tensor on the host as numpy (unsigned through its
    signed view)."""
    signed = {torch.uint32: torch.int32, torch.uint64: torch.int64}.get(x.dtype)
    if signed is not None:
        return x.view(signed).cpu().numpy().view(str(x.dtype).replace("torch.", ""))
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.cpu().numpy()


def u32_as_i64(x):
    """uint32 keys as int64 values."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@dataclass
class Answer:
    """A query's answer, rows in order. ``columns``: name -> numpy values,
    exact ones in the dtype the result states, float aggregates as float64;
    ``dtypes``: name -> the result's numpy dtype ("str" for a decoded
    string); ``scales``: float aggregate -> per-row scale (the sum of |x|
    of the group, over its row count for a mean) and the tag of its stated
    dtype."""

    columns: dict
    dtypes: dict
    scales: dict = field(default_factory=dict)

    def as_result(self) -> dict:
        """The columns as a result of the stated dtypes (the control's)."""
        return {k: v if self.dtypes[k] == "str" else np.asarray(v).astype(self.dtypes[k])
                for k, v in self.columns.items()}


def compare(got: dict, ans: Answer):
    """(mismatches, {dtype tag: widest relative gap}) of a result against
    the answer: a mismatch is a value of an exact column that differs, a
    row too many or too few in a column, a missing or extra column, or a
    column of another dtype (its every row); a float aggregate's gap is
    |got - exact| / scale, the largest of its rows."""
    mism, gaps = 0, {}
    for name in got:
        if name not in ans.columns:
            mism += len(got[name])
    for name, want in ans.columns.items():
        if name not in got:
            mism += len(want)
            continue
        g = np.asarray(got[name])
        k = min(len(g), len(want))
        mism += abs(len(g) - len(want))
        dt = ans.dtypes[name]
        if dt != "str" and g.dtype != np.dtype(dt):
            mism += k
        elif name in ans.scales:
            scale, tag = ans.scales[name]
            err = np.abs(g[:k].astype(np.float64) - want[:k]) / scale[:k]
            err = np.nan_to_num(err, nan=BIG, posinf=BIG)
            gaps[tag] = max(gaps.get(tag, 0.0), float(err.max(initial=0.0)))
        else:
            mism += int(np.count_nonzero(g[:k] != want[:k]))
    return mism, gaps
