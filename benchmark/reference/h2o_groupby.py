"""Plain answers to the db-benchmark groupby questions q1-q10 over the raw
G1 columns (``benchmark.h2o_data``), in plain PyTorch on their device.

Grouping packs the key columns into at most two int64 words and sorts them
stably (``torch.sort``); group sums are near-exact (integer sums in int64,
float sums split as :func:`benchmark.reference.tpch.common.exact_sums`
does); means divide those sums; the sample deviation is two-pass; CORR is
the centred cross sum over the centred sums of squares; the median is R's,
the mean of the two middle values; q8 sorts by (id6, -v3). With ``lower``,
every float is computed one precision below the stated one (v3 and float64
results in float32, float32 results in bfloat16): the control. Nothing is
computed in blocks: at 1e8 rows the largest answer (q10) needs a few GB.

An answer states the dtype the program's result gives each column: string
keys are uint32 codes into the input's dictionaries, integer keys and sums
of int32 columns int32 (they fit), COUNT(*) int32, AVG of an int32 column
float32, everything over v3 float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from benchmark.reference.tpch.common import LOWER, exact_sums

F64, F32, I64 = torch.float64, torch.float32, torch.int64
STRING_KEYS = ("id1", "id2", "id3")


@dataclass
class Answer:
    """A question's answer, one row a group. ``columns``: name -> tensor in
    the dtype the program's result states; ``kinds``: name -> ``"exact"``
    or the float tag ``"f64"`` / ``"f32"`` of its stated dtype; ``masks``:
    nullable column -> bool tensor (True = NULL); ``scales``: float column
    -> the per-row scale its gap is measured in (the sum of |x| of the
    group, over its row count for a mean and a median)."""

    columns: dict
    kinds: dict
    masks: dict = field(default_factory=dict)
    scales: dict = field(default_factory=dict)


def as_i64(x):
    """A key column as int64 values (uint32 through its signed view)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(I64) & 0xFFFFFFFF
    return x.to(I64)


def take(x, idx):
    """``x[idx]`` for any dtype (CUDA indexes no uint32 tensor: through its
    signed view)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)[idx].view(torch.uint32)
    return x[idx]


def lexsort(words):
    """The stable permutation that orders rows by ``words`` (int64 tensors,
    most significant first)."""
    perm = None
    for w in reversed(words):
        k = w if perm is None else w[perm]
        idx = torch.sort(k, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def group(raw, keys):
    """(group id of every row, group count, {key: key value of each
    group}) for the key columns ``keys``: the groups in ascending key
    order."""
    vals = [as_i64(raw[k]) for k in keys]
    words, cur, used = [], None, 0
    for v in vals:  # pack into int64 words of at most 63 bits
        bits = max(int(v.max()).bit_length(), 1)
        if cur is not None and used + bits <= 63:
            cur, used = (cur << bits) | v, used + bits
        else:
            if cur is not None:
                words.append(cur)
            cur, used = v, bits
    words.append(cur)
    perm = lexsort(words)
    sw = [w[perm] for w in words]
    new = torch.zeros_like(perm, dtype=torch.bool)
    new[0] = True
    for w in sw:
        new[1:] |= w[1:] != w[:-1]
    gid_sorted = torch.cumsum(new, 0) - 1
    inv = torch.empty_like(gid_sorted)
    inv[perm] = gid_sorted
    firsts = perm[new]
    return inv, int(new.sum()), {k: take(raw[k], firsts) for k in keys}


def _zeros(g, dt, dev):
    return torch.zeros(g, dtype=dt, device=dev)


def count(inv, g):
    return _zeros(g, I64, inv.device).index_add_(0, inv, torch.ones_like(inv))


def int_sum(x, inv, g):
    return _zeros(g, I64, x.device).index_add_(0, inv, x.to(I64))


def abs_sum(x, inv, g):
    return _zeros(g, F64, x.device).index_add_(0, inv, x.to(F64).abs())


def float_sum(x, inv, g, dt, lower):
    """Group sums of ``x`` stated in ``dt``: near-exact, or accumulated one
    precision below (the control)."""
    if lower:
        lo = LOWER[dt]
        return _zeros(g, lo, x.device).index_add_(0, inv, x.to(lo)).to(F64)
    return exact_sums(x, inv, g)


def mean(x, inv, g, n, dt, lower):
    if lower:
        lo = LOWER[dt]
        return (float_sum(x, inv, g, dt, True).to(lo) / n.to(lo)).to(F64)
    return exact_sums(x, inv, g) / n.to(F64)


def _v3(raw, lower):
    return raw["v3"].to(F32) if lower else raw["v3"]


def _keys_answer(keyvals):
    return {k: v for k, v in keyvals.items()}, {k: "exact" for k in keyvals}


def _sum_answer(raw, keys, ints, floats, lower):
    """SUM of the int32 columns ``ints`` and of the float64 columns
    ``floats`` by ``keys``."""
    inv, g, kv = group(raw, keys)
    cols, kinds = _keys_answer(kv)
    scales = {}
    for c in ints:
        cols[c] = int_sum(raw[c], inv, g).to(torch.int32)
        kinds[c] = "exact"
    for c in floats:
        x = _v3(raw, lower) if c == "v3" else raw[c]
        cols[c] = float_sum(x, inv, g, F64, lower)
        kinds[c], scales[c] = "f64", abs_sum(raw[c], inv, g)
    return Answer(cols, kinds, scales=scales)


def q1(raw, lower=False):
    return _sum_answer(raw, ["id1"], ["v1"], [], lower)


def q2(raw, lower=False):
    return _sum_answer(raw, ["id1", "id2"], ["v1"], [], lower)


def q3(raw, lower=False):
    inv, g, kv = group(raw, ["id3"])
    n = count(inv, g)
    cols, kinds = _keys_answer(kv)
    cols["v1"], kinds["v1"] = int_sum(raw["v1"], inv, g).to(torch.int32), "exact"
    cols["v3"] = mean(_v3(raw, lower), inv, g, n, F64, lower)
    kinds["v3"] = "f64"
    return Answer(cols, kinds, scales={"v3": abs_sum(raw["v3"], inv, g) / n})


def q4(raw, lower=False):
    inv, g, kv = group(raw, ["id4"])
    n = count(inv, g)
    cols, kinds = _keys_answer(kv)
    scales = {}
    for c, dt in (("v1", F32), ("v2", F32), ("v3", F64)):
        x = _v3(raw, lower) if c == "v3" else raw[c]
        if lower or dt == F64:
            cols[c] = mean(x, inv, g, n, dt, lower)
        else:  # an exact integer sum over the count
            cols[c] = int_sum(x, inv, g).to(F64) / n.to(F64)
        kinds[c], scales[c] = ("f32" if dt == F32 else "f64"), abs_sum(raw[c], inv, g) / n
    return Answer(cols, kinds, scales=scales)


def q5(raw, lower=False):
    return _sum_answer(raw, ["id6"], ["v1", "v2"], ["v3"], lower)


def q6(raw, lower=False):
    """PERCENTILE_CONT(v3, 0.5), R's median; STDDEV_SAMP(v3), R's sd."""
    inv, g, kv = group(raw, ["id4", "id5"])
    n = count(inv, g)
    x = _v3(raw, lower)
    dt = x.dtype
    # the values of each group in order: by v3, then stably by group
    order = torch.sort(x, stable=True).indices
    order = order[torch.sort(inv[order], stable=True).indices]
    sv = x[order]
    start = torch.cumsum(n, 0) - n
    lo, hi = sv[start + (n - 1) // 2], sv[start + n // 2]
    med = (lo.to(F64) + hi.to(F64)) / 2 if not lower else ((lo + hi) / 2).to(F64)
    m = (exact_sums(x, inv, g) / n.to(F64)).to(dt) if not lower else \
        (_zeros(g, dt, x.device).index_add_(0, inv, x) / n.to(dt))
    d = x - m[inv]
    ss = _zeros(g, dt, x.device).index_add_(0, inv, d * d)
    sd = torch.sqrt(ss / (n - 1).clamp(min=1).to(dt)).to(F64)
    null = n < 2
    cols, kinds = _keys_answer(kv)
    scale = abs_sum(raw["v3"], inv, g) / n
    cols.update(median_v3=med, sd_v3=torch.where(null, 0.0, sd))
    kinds.update(median_v3="f64", sd_v3="f64")
    return Answer(cols, kinds, masks={"sd_v3": null},
                  scales={"median_v3": scale, "sd_v3": scale})


def q7(raw, lower=False):
    """MAX(v1) - MIN(v2) by id3."""
    inv, g, kv = group(raw, ["id3"])
    dev = inv.device
    mx = torch.full((g,), -(1 << 40), dtype=I64, device=dev).scatter_reduce_(
        0, inv, raw["v1"].to(I64), "amax")
    mn = torch.full((g,), 1 << 40, dtype=I64, device=dev).scatter_reduce_(
        0, inv, raw["v2"].to(I64), "amin")
    cols, kinds = _keys_answer(kv)
    cols["range_v1_v2"], kinds["range_v1_v2"] = (mx - mn).to(torch.int32), "exact"
    return Answer(cols, kinds)


def q8(raw, lower=False):
    """The two largest v3 of each id6 (ties: any of the equal values)."""
    x = _v3(raw, lower).to(F64)
    order = torch.sort(-x, stable=True).indices
    order = order[torch.sort(as_i64(raw["id6"])[order], stable=True).indices]
    key = raw["id6"][order]
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    pos = torch.arange(key.shape[0], device=key.device)
    start = torch.nonzero(new).squeeze(1)[torch.cumsum(new, 0) - 1]  # each row's group start
    keep = pos - start < 2
    return Answer({"id6": key[keep], "largest2_v3": x[order][keep]},
                  {"id6": "exact", "largest2_v3": "exact"})


def q9(raw, lower=False):
    """POW(CORR(v1, v2), 2) by (id2, id4): centred sums in float64."""
    inv, g, kv = group(raw, ["id2", "id4"])
    n = count(inv, g)
    dt = F32 if lower else F64
    dev = inv.device
    centred = []
    for c in ("v1", "v2"):
        x = raw[c].to(dt)
        m = (int_sum(raw[c], inv, g).to(F64) / n.to(F64)).to(dt)
        centred.append(x - m[inv])
    dx, dy = centred

    def ssum(v):
        return _zeros(g, dt, dev).index_add_(0, inv, v)

    sxx, syy, sxy = ssum(dx * dx), ssum(dy * dy), ssum(dx * dy)
    r = (sxy / torch.sqrt(sxx * syy)).to(F64)
    null = (n < 2) | (sxx == 0) | (syy == 0)
    cols, kinds = _keys_answer(kv)
    cols["r2"], kinds["r2"] = torch.where(null, 0.0, r * r), "f64"
    return Answer(cols, kinds, masks={"r2": null},
                  scales={"r2": torch.ones(g, dtype=F64, device=dev)})


def q10(raw, lower=False):
    keys = ["id1", "id2", "id3", "id4", "id5", "id6"]
    inv, g, kv = group(raw, keys)
    cols, kinds = _keys_answer(kv)
    cols["v3"] = float_sum(_v3(raw, lower), inv, g, F64, lower)
    cols["count"] = count(inv, g).to(torch.int32)
    kinds.update(v3="f64", count="exact")
    return Answer(cols, kinds, scales={"v3": abs_sum(raw["v3"], inv, g)})


def answer(raw, name, lower=False) -> Answer:
    """The answer to question ``name`` (``"q1"`` ... ``"q10"``)."""
    return globals()[name](raw, lower)
