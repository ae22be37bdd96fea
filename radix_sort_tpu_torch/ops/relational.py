"""Relational completions over the sort: asof join, set operators, exact
quantiles.

Counterpart of ``radix_sort_tpu/ops/relational.py``, under the same names.
Each is one stable co-sort plus vectorized segment math:

  - ``join_asof``: each left key matches the nearest right key at or
    before/after it (SQL ``ASOF JOIN``, pandas ``merge_asof``). Probe ranks
    come from the merge-rank union sorts (``query.merge_rank_pair``),
    candidates from two clamped gathers.
  - ``set_union`` / ``set_intersect`` / ``set_difference``: SQL UNION /
    INTERSECT / EXCEPT over distinct keys (single or composite). One stable
    sort of the tagged union; per-group presence from a segment max over
    the origin tags.
  - ``quantiles``: exact order statistics at static quantile points.

Ragged outputs follow the engine convention: (padded tensors..., count).
Outputs are bit-identical to the reference's.
"""

from __future__ import annotations

import math

import torch

from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops._cosort import cosort
from radix_sort_tpu_torch.ops.query import (
    _clip,
    _cols_to_limbs,
    _gid,
    _i32,
    _limbs_to_cols,
    _mark_first,
    _seg_extreme,
    _signed,
    _stable_sort,
    _take,
    filter as _filter,
    merge_rank_pair,
)

__all__ = [
    "join_asof",
    "set_union",
    "set_intersect",
    "set_difference",
    "quantile_ranks",
    "quantiles",
    "ASOF_DIRECTIONS",
    "QUANTILE_METHODS",
]

ASOF_DIRECTIONS = ("backward", "forward", "nearest")
_U32 = 0xFFFFFFFF


def _full(n, fill, dtype, device):
    """``n`` copies of ``fill`` in ``dtype`` (unsigned dtypes through their
    signed view, with the fill's bits)."""
    sdt = _signed(torch.empty((0,), dtype=dtype)).dtype
    v = int(torch.tensor(fill).to(dtype).view(sdt)) if sdt != dtype else fill
    return torch.full((n,), v, dtype=sdt, device=device).view(dtype)


def _valid_positions(valid):
    """For each row of the sorted right side, the position of the last valid
    row at or before it (-1 if none) and of the first valid row at or after
    it (n if none): the reference's forward running max and reversed
    running min of the valid positions, as a lookup by valid-row rank (each
    valid row writes its own slot, so the result is deterministic)."""
    n = valid.shape[0]
    dev = valid.device
    nb = torch.cumsum(valid, 0, dtype=torch.int64)  # valid rows in [0, i]
    vpos = torch.full((n + 2,), n, dtype=torch.int32, device=dev)  # slot n+1: a dump
    vpos.scatter_(0, torch.where(valid, nb - 1, n + 1),
                  torch.arange(n, dtype=torch.int32, device=dev))
    lastv = torch.where(nb > 0, vpos[(nb - 1).clamp(min=0)], -1)
    firstv = vpos[nb - valid.to(torch.int64)]
    return lastv, firstv


def join_asof(left_keys, right_keys, right_values, *, direction: str = "backward",
              tolerance=None, fill=0, right_valid=None):
    """Nearest-key (asof) join: align each left row with one right row.

    For every ``left_keys[i]`` the match is the right row whose key is

      - ``"backward"``: the greatest key <= it (the latest tie wins, as in
        pandas ``merge_asof``);
      - ``"forward"``: the least key >= it (the earliest tie wins);
      - ``"nearest"``: whichever of those two is closer (ties go backward).

    Order is the dtype's total order; neither side needs to be sorted, and
    the outputs keep left order: ``(values, matched, right_pos)``, with
    ``values[i]`` the matched row's ``right_values`` entry (``fill`` where
    unmatched), ``matched`` the bool match mask and ``right_pos`` the
    matched row's index into ``right_keys`` (int32, -1 where unmatched).

    ``tolerance`` (optional scalar, key units) rejects matches farther than
    it. ``nearest`` and ``tolerance`` need arithmetic distances: 8/16/32-bit
    integer keys (exact, as unsigned 32-bit differences of the rank limbs)
    and float32 keys (IEEE subtraction; NaN distances reject or fall
    backward); 64-bit keys support backward/forward only. ``right_valid``
    (optional bool mask over ``right_keys``) excludes rows from candidacy:
    the match is the nearest valid row.
    """
    if direction not in ASOF_DIRECTIONS:
        raise ValueError(f"direction must be one of {ASOF_DIRECTIONS}, got {direction!r}")
    if left_keys.dtype != right_keys.dtype:
        raise ValueError("left and right keys must share a dtype")
    if right_values.shape[0] != right_keys.shape[0]:
        raise ValueError("right keys/values length mismatch")
    if isinstance(tolerance, (int, float)) and tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    kdt = left_keys.dtype
    if (direction == "nearest" or tolerance is not None) and K.num_limbs(kdt) != 1:
        raise ValueError("nearest/tolerance need arithmetic key distances — supported "
                         f"for <=32-bit keys, got {kdt}")
    n_l, n_r = left_keys.shape[0], right_keys.shape[0]
    vdt = right_values.dtype
    dev = left_keys.device
    if n_l == 0 or n_r == 0:
        return (_full(n_l, fill, vdt, dev), torch.zeros((n_l,), dtype=torch.bool, device=dev),
                torch.full((n_l,), -1, dtype=torch.int32, device=dev))

    # the right side sorted by key, carrying values and original positions
    r_limbs = K.encode_limbs(right_keys)
    nk = len(r_limbs)
    ops = [*r_limbs, right_values, torch.arange(n_r, dtype=torch.int32, device=dev)]
    if right_valid is not None:
        ops.append(right_valid)
    out = _stable_sort(ops, num_keys=nk)
    rk_s, rv_s, rp_s = out[:nk], out[nk], out[nk + 1]

    l_limbs = K.encode_limbs(left_keys)
    lo, hi = merge_rank_pair(rk_s, l_limbs)
    # backward candidate: the last right row with key <= q; forward: the first >= q
    if right_valid is None:
        idx_b, idx_f = _clip(hi - 1, 0, n_r - 1), _clip(lo, 0, n_r - 1)
        m_b, m_f = hi > 0, lo < n_r
    else:
        # the nearest VALID candidates
        lastv, firstv = _valid_positions(out[nk + 2])
        cand_b = lastv[_clip(hi - 1, 0, n_r - 1)]
        cand_f = firstv[_clip(lo, 0, n_r - 1)]
        m_b, m_f = (hi > 0) & (cand_b >= 0), (lo < n_r) & (cand_f < n_r)
        idx_b, idx_f = _clip(cand_b, 0, n_r - 1), _clip(cand_f, 0, n_r - 1)

    is_float = kdt.is_floating_point

    def _dist(idx, back):
        """Distance from query to candidate (meaningful only where matched)."""
        if is_float:
            k = K.decode_limbs([rk_s[0][idx]], kdt)
            return (left_keys - k if back else k - left_keys).abs()
        # integers: rank limbs are an order-preserving shift of the keys, so
        # their differences modulo 2**32, read unsigned, are the distances
        q, k = l_limbs[0].to(torch.int64), rk_s[0][idx].to(torch.int64)
        return (q - k if back else k - q) & _U32

    if direction == "backward":
        idx, matched = idx_b, m_b
        picked_back = torch.ones((n_l,), dtype=torch.bool, device=dev)
    elif direction == "forward":
        idx, matched = idx_f, m_f
        picked_back = torch.zeros((n_l,), dtype=torch.bool, device=dev)
    else:  # nearest: the closer matched candidate; ties go backward
        use_f = m_f & (~m_b | (_dist(idx_f, False) < _dist(idx_b, True)))
        idx = torch.where(use_f, idx_f, idx_b)
        matched = m_b | m_f
        picked_back = ~use_f

    if tolerance is not None:
        d = torch.where(picked_back, _dist(idx, True), _dist(idx, False))
        if is_float:
            tol = torch.tensor(tolerance, dtype=kdt, device=dev)
        else:  # the reference's cast to uint32
            tol = (min(int(tolerance), _U32) if isinstance(tolerance, float)
                   else int(tolerance) & _U32)
        matched = matched & (d <= tol)

    fill_v = _signed(_full(1, fill, vdt, dev))
    values = torch.where(matched, _signed(_take(rv_s, idx)), fill_v).view(vdt)
    right_pos = torch.where(matched, rp_s[idx], -1)
    return values, matched, right_pos


def _set_op(a_keys, b_keys, want, a_valid=None, b_valid=None):
    """One stable sort of the tagged union, per-group presence by a segment
    max over per-side indicator bits, the qualifying group leaders
    compacted with ``filter``. ``want(has_a, has_b) -> bool`` selects
    groups. Optional validity masks exclude padding rows: they contribute
    no presence, so a group they form alone is never selected. Returns
    ``(key_cols_or_col, count)`` padded to n_a + n_b."""
    multi = isinstance(a_keys, (list, tuple))
    if multi != isinstance(b_keys, (list, tuple)):
        raise ValueError("both sides must be single columns or column lists")
    a_cols = list(a_keys) if multi else [a_keys]
    b_cols = list(b_keys) if multi else [b_keys]
    if not a_cols or len(a_cols) != len(b_cols):
        raise ValueError("sides must have the same non-zero column count")
    if any(a.dtype != b.dtype for a, b in zip(a_cols, b_cols)):
        raise ValueError("column dtypes must match between sides")
    n_a, n_b = a_cols[0].shape[0], b_cols[0].shape[0]
    if any(c.shape[0] != n_a for c in a_cols):
        raise ValueError("left columns must have equal length")
    if any(c.shape[0] != n_b for c in b_cols):
        raise ValueError("right columns must have equal length")
    dev = a_cols[0].device
    if n_a + n_b == 0:
        z = [torch.zeros((0,), dtype=c.dtype, device=dev) for c in a_cols]
        return (z if multi else z[0]), _i32(0, dev)

    cols = [torch.cat([a, b]) for a, b in zip(a_cols, b_cols)]
    av = torch.ones((n_a,), dtype=torch.bool, device=dev) if a_valid is None else a_valid
    bv = torch.ones((n_b,), dtype=torch.bool, device=dev) if b_valid is None else b_valid
    no_a = torch.zeros((n_a,), dtype=torch.bool, device=dev)
    no_b = torch.zeros((n_b,), dtype=torch.bool, device=dev)
    ia = torch.cat([av, no_b]).to(torch.int32)
    ib = torch.cat([no_a, bv]).to(torch.int32)
    limbs, specs = _cols_to_limbs(cols)
    *sk, sia, sib = _stable_sort([*limbs, ia, ib], num_keys=len(limbs))
    first = _mark_first(sk)
    gid = _gid(first)
    has_a = _seg_extreme(sia, gid, "max")[gid] == 1
    has_b = _seg_extreme(sib, gid, "max")[gid] == 1
    *out_keys, count = _filter(first & want(has_a, has_b), *_limbs_to_cols(sk, specs))
    return (out_keys if multi else out_keys[0]), count


def set_union(a_keys, b_keys):
    """SQL ``UNION``: distinct keys present in either side, ascending under
    the total order. Keys may be single columns or equal-dtype column lists
    (composite rows, lexicographic order). Returns ``(keys, count)``: rows
    [0, count) are the result, the tail is padding."""
    return _set_op(a_keys, b_keys, lambda ha, hb: ha | hb)


def set_intersect(a_keys, b_keys):
    """SQL ``INTERSECT``: distinct keys present in both sides. Same shapes
    and contract as :func:`set_union`."""
    return _set_op(a_keys, b_keys, lambda ha, hb: ha & hb)


def set_difference(a_keys, b_keys):
    """SQL ``EXCEPT``: distinct keys present in the first side and absent
    from the second. Same shapes and contract as :func:`set_union`."""
    return _set_op(a_keys, b_keys, lambda ha, hb: ha & ~hb)


QUANTILE_METHODS = ("lower", "higher", "nearest")


def quantile_ranks(n: int, qs, method: str = "lower"):
    """Static ranks into a sorted n-row tensor for quantile points ``qs``
    (numpy ``quantile``'s index conventions for the discrete methods)."""
    if method not in QUANTILE_METHODS:
        raise ValueError(f"method must be one of {QUANTILE_METHODS}, got {method!r}")
    ranks = []
    for q in qs:
        q = float(q)
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile points must be in [0, 1], got {q}")
        x = q * (n - 1)
        if method == "lower":
            r = math.floor(x)
        elif method == "higher":
            r = math.ceil(x)
        else:
            r = math.floor(x + 0.5)
        ranks.append(min(max(r, 0), n - 1))
    return ranks


def quantiles(x: torch.Tensor, qs, *, method: str = "lower") -> torch.Tensor:
    """Exact quantiles of ``x`` as order statistics under the dtype's total
    order (floats: IEEE total_cmp, so NaNs rank at the ends instead of
    poisoning the result as in ``np.quantile``).

    ``qs`` is a static sequence of points in [0, 1]; ``method`` picks the
    discrete index convention (numpy's ``lower`` / ``higher`` /
    ``nearest``; no interpolation, so any supported dtype works and the
    results are elements of ``x``). Returns a tensor of ``len(qs)`` values.
    """
    n = x.shape[0]
    if n == 0:
        raise ValueError("quantiles of an empty array")
    idx = torch.tensor(quantile_ranks(n, qs, method), dtype=torch.int64, device=x.device)
    limbs = K.encode_limbs(x)
    return K.decode_limbs([w[idx] for w in cosort(limbs, len(limbs))], x.dtype)
