"""Public sort API.

Counterpart of ``radix_sort_tpu/ops/sort.py``: the reference's extension
traits on slices (``RadixSort::radix_sort``, mod.rs:18-20, and the
``RadixSortCopyOnly`` variant ladder, mod.rs:22-38) as functions on tensors:

    sort(keys)                 -- stable total-order sort, any supported dtype
    argsort(keys)              -- stable sorting permutation (int64)
    sort_pairs(keys, values)   -- stable key/payload row sort (tuple semantics)
    sort_limbs(key_words, ...) -- stable co-sort by multi-limb keys
    lexsort(columns)           -- stable permutation over several key columns
    sort_segments(keys, offs)  -- stable sort inside each contiguous segment
    top_k(keys, k, *arrays)    -- the k largest (or smallest) rows, stable ties
    sort128 / argsort128 / sort_pairs128 -- 128-bit (hi, lo) keys
    counting_sort(x)           -- single-pass counting sort for uint8

``implementation`` selects an engine: "comparator" and "oracle" run the
stable ``torch.sort``; "xla_argsort" and "xla_rank" run the LSD ladder of
ops/xla_radix.py in stock tensor ops (a stable argsort per digit, or a
one-hot histogram, scan and scatter per digit: pedagogical sizes); "pallas"
runs the sample sort on the hand-written CUDA kernel (ops/pallas_sort.py);
"auto" follows the active config. All engines produce bit-identical output. Results stay on the input's device.
"""

from __future__ import annotations

import torch

from radix_sort_tpu_torch import config
from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import pallas_sort, sample_sort, xla_radix
from radix_sort_tpu_torch.ops._cosort import cosort
from radix_sort_tpu_torch.ops.query import (
    _cols_to_limbs,
    _limbs_to_cols,
    _stable_sort,
    _take,
)

__all__ = [
    "sort",
    "argsort",
    "sort_pairs",
    "sort_limbs",
    "lexsort",
    "top_k",
    "sort_segments",
    "sort128",
    "argsort128",
    "sort_pairs128",
    "counting_sort",
    "IMPLEMENTATIONS",
]

_ENGINES = {
    # name -> (sort_words, argsort_words). Keys-only sorts need no stability
    # (equal words are indistinguishable); argsort keeps it (the
    # permutation is observable).
    "comparator": (
        lambda w: torch.sort(w).values,
        lambda w: torch.argsort(w, stable=True),
    ),
    "oracle": (
        lambda w: torch.sort(w, stable=True).values,
        lambda w: torch.argsort(w, stable=True),
    ),
    "xla_argsort": (
        xla_radix.radix_sort_words_argsort,
        xla_radix.radix_argsort_words_argsort,
    ),
    "xla_rank": (
        xla_radix.radix_sort_words_rank,
        xla_radix.radix_argsort_words_rank,
    ),
    "pallas": (pallas_sort.sort_words, pallas_sort.argsort_words),
}

IMPLEMENTATIONS = (
    "auto", "comparator", "oracle", "xla_argsort", "xla_rank", "pallas",
)


def _resolve(implementation: str) -> str:
    if implementation == "auto":
        return config.get().default_implementation
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(
            f"implementation must be one of {IMPLEMENTATIONS}, got {implementation!r}"
        )
    return implementation


def _dir(words: torch.Tensor, descending: bool) -> torch.Tensor:
    """Complement rank words to reverse the order.

    Bitwise NOT reverses signed order exactly, so sorting ``~w`` stably
    ascending == sorting ``w`` descending with equal keys still in input
    order (stable-descending semantics)."""
    return ~words if descending else words


def sort(keys: torch.Tensor, *, descending: bool = False,
         implementation: str = "auto") -> torch.Tensor:
    """Stable sort under the dtype's total order (ascending by default).

    Floats order by IEEE total_cmp (including -0.0 < +0.0, NaNs by sign and
    payload), signed ints by value. ``descending=True`` reverses the order.
    """
    if implementation == "auto" and keys.element_size() == 1:
        # byte-wide keys: the single-pass counting sort (mod.rs:40-59) over
        # the rank word's unsigned offset
        w = _dir(K.encode(keys), descending)
        u = xla_radix.counting_sort_u8((w ^ -128).view(torch.uint8))
        return K.decode(_dir(u.view(torch.int8) ^ -128, descending), keys.dtype)
    sort_words, _ = _ENGINES[_resolve(implementation)]
    w = _dir(sort_words(_dir(K.encode(keys), descending)), descending)
    return K.decode(w, keys.dtype)


def argsort(keys: torch.Tensor, *, descending: bool = False,
            implementation: str = "auto") -> torch.Tensor:
    """Indices (int64) of the stable total-order sort."""
    _, argsort_words = _ENGINES[_resolve(implementation)]
    return argsort_words(_dir(K.encode(keys), descending))


def sort_pairs(keys: torch.Tensor, values: torch.Tensor, *,
               descending: bool = False, implementation: str = "auto"):
    """Stable sort of (key, payload) rows by key.

    The payload never influences the order; equal keys keep input payload
    order (the reference's tuple sort, radix_digits.rs:126-136).
    """
    if values.shape[:1] != keys.shape[:1]:
        raise ValueError(
            f"keys and values must share the leading axis, got {tuple(keys.shape)} "
            f"vs {tuple(values.shape)}"
        )
    impl = _resolve(implementation)
    if impl == "pallas":
        words, out_vals = pallas_sort.sort_pairs_words(
            _dir(K.encode(keys), descending), values
        )
        return K.decode(_dir(words, descending), keys.dtype), out_vals
    if impl == "comparator":
        srt = torch.sort(_dir(K.encode(keys), descending), stable=True)
        return K.decode(_dir(srt.values, descending), keys.dtype), _take(values, srt.indices)
    perm = argsort(keys, descending=descending, implementation=impl)
    return _take(keys, perm), _take(values, perm)


def counting_sort(x: torch.Tensor) -> torch.Tensor:
    """Single-pass counting sort for uint8 (reference mod.rs:40-59)."""
    return xla_radix.counting_sort_u8(x)


def sort_limbs(key_words, value_words=(), *, descending: bool = False,
               implementation: str = "auto"):
    """Stable co-sort by a multi-limb key.

    ``key_words``: most-significant-first int32 rank limbs (``keys.encode_limbs``
    gives them for any column; any count). ``value_words``: more int32
    tensors carried along. Returns the co-sorted lists
    ``(key_words, value_words)``.
    """
    key_words = list(key_words)
    value_words = list(value_words)
    if not key_words:
        raise ValueError("sort_limbs needs at least one key word")
    n = key_words[0].shape[0]
    for a in key_words + value_words:
        if a.shape[0] != n or a.dtype != torch.int32:
            raise ValueError("all limbs must be int32 tensors of equal length")
    impl = _resolve(implementation)
    nk = len(key_words)
    if descending:
        # complementing every limb reverses the lexicographic order exactly
        key_words = [~w for w in key_words]
    if impl == "pallas" and n >= config.get().min_pipeline_n:
        out = sample_sort.sample_sort_words(key_words + value_words, nk)
    else:
        out = cosort(key_words + value_words, nk)
    kw_out = [~w for w in out[:nk]] if descending else list(out[:nk])
    return kw_out, list(out[nk:])


def lexsort(columns, *, descending: bool = False,
            implementation: str = "auto") -> torch.Tensor:
    """Stable sorting permutation (int64) over several key columns.

    ``columns`` are equal-length tensors of any supported dtype mix; the
    FIRST column is the primary key (numpy's ``lexsort`` takes it last).
    Ties across all columns keep input order. Each column becomes its rank
    limbs and the concatenation sorts through :func:`sort_limbs`, so
    ``implementation="pallas"`` reaches the sample sort and its kernel.
    """
    columns = list(columns)
    if not columns:
        raise ValueError("lexsort needs at least one column")
    n = columns[0].shape[0]
    limbs = []
    for c in columns:
        if c.shape[0] != n:
            raise ValueError("all columns must have equal length")
        limbs.extend(K.encode_limbs(c))
    idx = torch.arange(n, dtype=torch.int32, device=columns[0].device)
    _, vals = sort_limbs(limbs, [idx], descending=descending,
                         implementation=implementation)
    return vals[0].to(torch.int64)


def sort_segments(keys: torch.Tensor, offsets: torch.Tensor, values=(), *,
                  descending: bool = False, implementation: str = "auto"):
    """Independently sort each contiguous segment of ``keys`` (stably).

    ``offsets`` is the (S+1,)-element boundary tensor of the CUB
    ``DeviceSegmentedRadixSort`` convention: segment ``s`` is rows
    ``[offsets[s], offsets[s+1])``, ``offsets[0] == 0`` and ``offsets[-1] ==
    len(keys)`` (empty segments allowed). Returns ``(keys_sorted,
    [values_sorted...])`` with every segment in place and sorted inside;
    equal keys keep input order (``descending`` reverses key order within
    each segment only).

    One stable co-sort by (segment id, key): segment ids never decrease
    over rows, so the sort leaves segments in place. Segment ids are a
    running sum over the interior boundaries, marked by a scatter-add.
    """
    values = list(values)
    n = keys.shape[0]
    for v in values:
        if v.shape[0] != n:
            raise ValueError("all value arrays must match the keys length")
    if n == 0:
        return keys, values
    marks = torch.zeros((n,), dtype=torch.int32, device=keys.device)
    interior = offsets[1:-1].to(torch.int32)
    if interior.shape[0]:
        # duplicates (empty segments) just skip ids; out-of-range ones add 0
        inside = ((interior >= 0) & (interior < n)).to(torch.int32)
        marks.index_add_(0, interior.clamp(0, n - 1).to(torch.int64), inside)
    seg = torch.cumsum(marks, 0, dtype=torch.int32)
    key_limbs = [_dir(w, descending) for w in K.encode_limbs(keys)]
    _resolve(implementation)  # validate; one co-sort whatever the engine
    nk = 1 + len(key_limbs)
    out = _stable_sort([seg, *key_limbs, *values], num_keys=nk)
    out_keys = K.decode_limbs([_dir(w, descending) for w in out[1:nk]], keys.dtype)
    return out_keys, list(out[nk:])


def top_k(keys, k: int, *arrays: torch.Tensor, largest: bool = True):
    """Top ``k`` rows by key under the dtype's total order.

    Returns ``(top_keys, *top_arrays)``: the selected rows sorted
    (descending for ``largest=True``, ascending otherwise), ties broken by
    input position, lower first (the tie order of the JAX package's
    ``lax.top_k``). Payload ``arrays`` are co-selected by gathers of the k
    rows. ``keys`` may be a list of equal-length columns (composite ORDER BY
    ... LIMIT k, by the lexicographic column tuple); ``top_keys`` is then a
    column list.

    The selection is one stable sort of the (complemented, for
    ``largest``) rank limbs: PyTorch's ``topk`` promises no tie order, and
    the stable sort gives the same rows on the CPU and on the card.
    """
    multi = isinstance(keys, (list, tuple))
    cols = list(keys) if multi else [keys]
    n = cols[0].shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"k must be in [0, {n}], got {k}")
    for a in list(cols[1:]) + list(arrays):
        if a.shape[0] != n:
            raise ValueError("all arrays must match the keys length")
    if multi:
        limbs, specs = _cols_to_limbs(cols)
    else:
        limbs = [K.encode(keys)]
    # stable ascending over the complement == descending, ties in input order
    sel = [~w for w in limbs] if largest else limbs
    idx = torch.arange(n, dtype=torch.int64, device=cols[0].device)
    *srt, idx = _stable_sort([*sel, idx], num_keys=len(sel))
    top = [(~w if largest else w)[:k] for w in srt]
    idx = idx[:k]
    top_keys = _limbs_to_cols(top, specs) if multi else K.decode(top[0], keys.dtype)
    return (top_keys, *[_take(a, idx) for a in arrays])


def sort128(hi, lo, *, signed: bool = False, implementation: str = "auto"):
    """Stable sort of 128-bit keys held as (hi, lo) 64-bit words.

    The reference's u128/i128 key types (radix_digits.rs:37-53, 87-93):
    keys travel as 4 big-endian int32 rank limbs (:func:`keys.encode128`)
    through :func:`sort_limbs`. ``signed`` selects i128 (``hi`` int64).
    Returns the sorted (hi, lo) pair.
    """
    out, _ = sort_limbs(K.encode128(hi, lo, signed=signed), implementation=implementation)
    return K.decode128(out, signed=signed)


def argsort128(hi, lo, *, signed: bool = False, implementation: str = "auto"):
    """Indices (int64) of the stable 128-bit total-order sort."""
    idx = torch.arange(hi.shape[0], dtype=torch.int32, device=hi.device)
    _, vals = sort_limbs(K.encode128(hi, lo, signed=signed), [idx],
                         implementation=implementation)
    return vals[0].to(torch.int64)


def sort_pairs128(hi, lo, values, *, signed: bool = False,
                  implementation: str = "auto"):
    """Stable 128-bit key / uint32-payload row sort (tuple semantics,
    radix_digits.rs:126-136). Returns ``((hi, lo), values)``."""
    if values.dtype != torch.uint32:
        raise TypeError(f"values must be uint32 words, got {values.dtype}")
    out, vals = sort_limbs(K.encode128(hi, lo, signed=signed), [values.view(torch.int32)],
                           implementation=implementation)
    return K.decode128(out, signed=signed), vals[0].view(torch.uint32)
