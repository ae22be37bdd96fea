"""Dictionary-encoded string columns.

Counterpart of ``radix_sort_tpu/strings.py``: the port's own copy of that
pure-numpy module (it imports nothing of the JAX package). The device
never sees a character. A string column is a ``uint32`` code tensor on the
device plus a host-side sorted vocabulary (the dictionary). Because the
vocabulary is sorted, codes are ORDER-PRESERVING: every engine operator
(sort, group-by, join, distinct, min/max, windows) works on the codes
unchanged and produces lexicographically correct results. Cross-table
operators (join, set ops, concat) first unify the two dictionaries on the
host and remap codes with one small device gather, so the shared code
space stays order-preserving.

Vocabularies are interned by ``np.unique`` and merged by the native C++
loader's two-pointer merge of sorted vocabularies (``native/csvio.py``) when
it builds, by ``np.union1d`` without a compiler; the codes and vocabularies
are the same either way. (The loader's native intern, ``csvio.intern_rows``,
lost to ``np.unique`` on 6M mostly distinct strings on an H100 machine's
host CPU, chip_smoke.py phase 13d, so ``encode`` does not use it.)

Conventions:
  - every vocabulary contains ``""`` at index 0 ("" is the lexicographic
    minimum, so forcing it keeps the vocabulary sorted). Zero-filled cells
    (e.g. unmatched join rows) therefore decode to ``""``.
  - ``NOT_FOUND`` (0xFFFFFFFF) is the code for a value absent from a
    vocabulary; it compares unequal to every real code.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "NOT_FOUND",
    "is_string_data",
    "encode",
    "decode",
    "unify",
    "lookup",
    "like_mask",
    "DictColumn",
    "revocab",
    "STR_FNS",
    "STR_NUM_FNS",
    "STR_BOOL_FNS",
]

NOT_FOUND = np.uint32(0xFFFFFFFF)


def is_string_data(x) -> bool:
    """True for host-side string data: a numpy array of unicode/bytes/
    object-of-str, or a list/tuple of str/bytes."""
    if isinstance(x, np.ndarray):
        if x.dtype.kind in ("U", "S"):
            return True
        if x.dtype.kind == "O":
            return all(isinstance(v, (str, bytes)) for v in x.ravel())
        return False
    if isinstance(x, (list, tuple)):
        return len(x) > 0 and all(isinstance(v, (str, bytes)) for v in x)
    return False


def _as_str_array(x) -> np.ndarray:
    arr = np.asarray(x)
    if arr.dtype.kind == "S":
        arr = arr.astype(np.str_)
    elif arr.dtype.kind == "O":
        arr = np.array([v.decode() if isinstance(v, bytes) else str(v)
                        for v in arr], dtype=np.str_)
    return arr.astype(np.str_)


def encode(x):
    """Encode host string data into ``(codes, vocab)``: ``codes`` is a
    ``uint32`` numpy array, ``vocab`` a sorted numpy unicode array with
    ``""`` at index 0. ``vocab[codes]`` reproduces the input."""
    arr = _as_str_array(x)
    vocab, inv = np.unique(arr, return_inverse=True)
    if vocab.shape[0] == 0 or vocab[0] != "":
        vocab = np.concatenate([np.array([""], dtype=vocab.dtype), vocab])
        inv = inv + 1
    return inv.astype(np.uint32), vocab


def decode(codes, vocab) -> np.ndarray:
    """Decode a code array against a vocabulary. ``NOT_FOUND`` and any
    out-of-range code decode to ``""`` (index 0)."""
    codes = np.asarray(codes)
    bad = codes >= np.uint32(vocab.shape[0])
    return vocab[np.where(bad, 0, codes)]


def unify(vocab_a: np.ndarray, vocab_b: np.ndarray):
    """Merge two vocabularies into one sorted union and return
    ``(union, remap_a, remap_b)`` where ``remap_x[old_code] = new_code``
    (uint32 numpy arrays, applied on the device as one small gather).

    Vocabularies are sorted by invariant, so the union is a native linear
    two-pointer merge (csv_loader.cpp); np.union1d's re-sort of both runs
    only without a compiler."""
    from radix_sort_tpu_torch.native import csvio

    native = csvio.merge_sorted(vocab_a, vocab_b)
    if native is not None:
        remap_a, remap_b, src, idx, n_u = native
        dt = vocab_a.dtype if vocab_a.dtype.itemsize >= vocab_b.dtype.itemsize else vocab_b.dtype
        union = np.empty(n_u, dt)
        ma = src == 0
        union[ma] = vocab_a[idx[ma]]
        union[~ma] = vocab_b[idx[~ma]]
        return union, remap_a, remap_b
    union = np.union1d(vocab_a, vocab_b)  # sorted; "" stays at index 0
    remap_a = np.searchsorted(union, vocab_a).astype(np.uint32)
    remap_b = np.searchsorted(union, vocab_b).astype(np.uint32)
    return union, remap_a, remap_b


def _like_segments(pattern: str):
    """Split a LIKE pattern on unescaped ``%`` into literal segments, or
    None when the pattern uses ``_`` (single-char wildcard) — only the
    all-literal shapes take the vectorized path."""
    segs, cur, i = [], [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            cur.append(pattern[i + 1])
            i += 2
            continue
        if ch == "%":
            segs.append("".join(cur))
            cur = []
        elif ch == "_":
            return None
        else:
            cur.append(ch)
        i += 1
    segs.append("".join(cur))
    return segs


def like_mask(vocab: np.ndarray, pattern: str) -> np.ndarray:
    """Boolean mask over ``vocab`` matching a SQL LIKE pattern.

    ``%`` matches any run (including empty), ``_`` any single character;
    ``\\%`` / ``\\_`` / ``\\\\`` escape literals. The pattern evaluates
    once against the host-side vocabulary — the device-side test is then
    a single gather of this mask by code, so LIKE costs the same as any
    other predicate regardless of ROW count.

    The common ``_``-free shapes (exact, ``lit%``, ``%lit``, ``%lit%``,
    ``a%b``, and any single-``%``-chain ``a%m1%...%b``) evaluate as
    vectorized numpy.char ops — O(vocab) C loops, which is what keeps
    high-cardinality vocabularies workable. Patterns using ``_`` fall back
    to the per-entry regex loop — fine for small vocabularies, the slow
    path for huge ones."""
    segs = _like_segments(pattern)
    if segs is not None:
        v = np.asarray(vocab, dtype=np.str_)
        first, last, mids = segs[0], segs[-1], segs[1:-1]
        if not mids and len(segs) == 1:
            return v == first  # no % at all: exact match
        lens = np.char.str_len(v)
        need = len(first) + len(last) + sum(len(m) for m in mids)
        mask = lens >= need
        pos = np.full(v.shape, len(first), np.int64)
        if first:
            mask &= np.char.startswith(v, first)
        if last:
            mask &= np.char.endswith(v, last)
        # middle segments must appear in order between prefix and suffix:
        # chain np.char.find from the previous segment's end
        end_limit = lens - len(last)
        for m in mids:
            if not m:
                continue
            f = np.char.find(v, m, pos, None)
            ok = (f >= 0) & (f + len(m) <= end_limit)
            mask &= ok
            pos = np.where(ok, f + len(m), pos)
        return mask
    import re

    parts, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            parts.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            parts.append(".*")
        elif ch == "_":
            parts.append(".")
        else:
            parts.append(re.escape(ch))
        i += 1
    rx = re.compile("".join(parts), re.DOTALL)
    return np.array(
        [rx.fullmatch(str(v)) is not None for v in vocab], bool
    )


def lookup(vocab: np.ndarray, values):
    """Codes for ``values`` under ``vocab``; absent values get
    ``NOT_FOUND`` (which equals no real code). Scalar in, scalar out."""
    scalar = isinstance(values, (str, bytes))
    arr = _as_str_array([values] if scalar else values)
    idx = np.searchsorted(vocab, arr)
    idx_c = np.minimum(idx, vocab.shape[0] - 1)
    codes = np.where(vocab[idx_c] == arr, idx_c, NOT_FOUND).astype(np.uint32)
    return codes[0] if scalar else codes


class DictColumn:
    """A computed dictionary-encoded column: ``uint32`` codes (a tensor or
    host array) plus
    the host vocabulary they index (and an optional null mask). This is
    what a string-valued expression (``UPPER(name)``, ``a || '-suffix'``)
    evaluates to, so ``Table.with_columns`` can attach the output
    dictionary instead of leaving bare codes behind."""

    __slots__ = ("codes", "vocab", "mask")

    def __init__(self, codes, vocab, mask=None):
        self.codes = codes
        self.vocab = np.asarray(vocab)
        self.mask = mask


def revocab(vals: np.ndarray):
    """Re-dictionary positional per-code string values into a sorted
    vocabulary: ``(vocab, mapping)`` with ``""`` forced at index 0 and
    ``mapping[old_code] = new_code`` (``uint32``). The sort keeps the
    order-preserving code invariant after a value transform (``UPPER``
    etc. permutes and merges vocabulary entries arbitrarily)."""
    vals = np.asarray(vals, dtype=np.str_)
    vocab, inv = np.unique(vals, return_inverse=True)
    if vocab.shape[0] == 0 or vocab[0] != "":
        vocab = np.concatenate([np.array([""], dtype=vocab.dtype), vocab])
        inv = inv + 1
    return vocab, inv.astype(np.uint32)


# ---------------------------------------------------------------------------
# scalar string functions — host transforms over per-code values
#
# Each callable maps an np unicode array (one entry per dictionary code)
# to the per-code RESULT; the device-side cost of any of these is a single
# gather by code, independent of row count (same trick as like_mask).
# SQL semantics: SUBSTR/STRPOS are 1-based; STRPOS returns 0 when absent;
# LPAD/RPAD truncate to the target width.
# ---------------------------------------------------------------------------


def _substr(vals, start, length=None):
    s = int(start)
    if s < 1:
        raise ValueError(f"SUBSTR start is 1-based, got {start}")
    e = None if length is None else s - 1 + max(int(length), 0)
    return np.array([v[s - 1:e] for v in vals], dtype=np.str_)


def _left(vals, n):
    # LEFT(v, n): first n chars; negative n drops the last |n| (SQL)
    n = int(n)
    return np.array(
        [v[:n] if n >= 0 else v[:max(len(v) + n, 0)] for v in vals],
        dtype=np.str_,
    )


def _right(vals, n):
    # RIGHT(v, n): last n chars; negative n drops the first |n| (SQL)
    n = int(n)
    return np.array(
        [v[max(len(v) - n, 0):] if n >= 0 else v[-n:] for v in vals],
        dtype=np.str_,
    )


def _pad(vals, width, fill, left):
    w, f = int(width), str(fill)
    if not f:
        raise ValueError("pad fill string must be non-empty")
    out = []
    for v in vals:
        if len(v) >= w:
            out.append(v[:w])
        else:
            pad = (f * w)[: w - len(v)]
            out.append(pad + v if left else v + pad)
    return np.array(out, dtype=np.str_)


# string -> string (result feeds revocab)
STR_FNS = {
    "upper": lambda vals: np.char.upper(vals),
    "lower": lambda vals: np.char.lower(vals),
    "trim": lambda vals, chars=" ": np.char.strip(vals, chars),
    "ltrim": lambda vals, chars=" ": np.char.lstrip(vals, chars),
    "rtrim": lambda vals, chars=" ": np.char.rstrip(vals, chars),
    "substr": _substr,
    "replace": lambda vals, old, new: np.char.replace(
        vals, str(old), str(new)),
    "left": _left,
    "right": _right,
    "reverse": lambda vals: np.array([v[::-1] for v in vals],
                                     dtype=np.str_),
    "lpad": lambda vals, width, fill=" ": _pad(vals, width, fill, True),
    "rpad": lambda vals, width, fill=" ": _pad(vals, width, fill, False),
}

# string -> int32
STR_NUM_FNS = {
    "length": lambda vals: np.char.str_len(vals).astype(np.int32),
    "strpos": lambda vals, sub: (
        np.char.find(vals, str(sub)) + 1).astype(np.int32),
}

# string -> bool
STR_BOOL_FNS = {
    "starts_with": lambda vals, pre: np.char.startswith(vals, str(pre)),
    "ends_with": lambda vals, suf: np.char.endswith(vals, str(suf)),
    "contains": lambda vals, sub: np.char.find(vals, str(sub)) >= 0,
}
