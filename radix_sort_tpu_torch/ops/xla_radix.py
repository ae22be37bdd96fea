"""Plain-PyTorch LSD radix sort variants (the pedagogical ladder) and the
byte-wide counting sort.

Counterpart of ``radix_sort_tpu/ops/xla_radix.py``. The reference crate keeps
an optimization ladder ``radix_sort0..5`` documenting how its production
design was reached (src/radix_sort/mod.rs:178-571); these are formulations of
the multi-pass LSD pipeline (histogram -> exclusive scan -> stable scatter)
in stock tensor ops. None is a fast path: they document the pass structure
and serve as cross-checks on any device. No kernel of the port runs here.

The port's rank words are signed (``keys.encode``): signed order is the
keys' order. An LSD pass needs the digits of the UNSIGNED rank, which is the
word with its sign bit flipped; each variant flips it once, then takes
``digit_bits`` per pass: shift the signed word, then mask (the mask removes
the sign extension, so the digit is the unsigned word's).
"""

from __future__ import annotations

import torch

from radix_sort_tpu_torch import keys as K

__all__ = [
    "radix_sort_words_argsort",
    "radix_sort_words_rank",
    "radix_argsort_words_argsort",
    "radix_argsort_words_rank",
    "counting_sort_u8",
]


def _unsigned_rank(words: torch.Tensor) -> torch.Tensor:
    """The words with the sign bit flipped: their unsigned digit order is the
    signed words' order."""
    return words ^ torch.iinfo(words.dtype).min


def _digit(u: torch.Tensor, shift: int, nbits: int) -> torch.Tensor:
    """The pass digit (vectorized get_digit, radix_digits.rs) as int64 (the
    widening sign-extends; bits below the word's width are unchanged)."""
    return (u.to(torch.int64) >> shift) & ((1 << nbits) - 1)


def _passes(words: torch.Tensor, digit_bits: int):
    bits = K.num_digit_bits(words.dtype)
    for shift in range(0, bits, digit_bits):
        yield shift, min(digit_bits, bits - shift)


def _argsort_pass_perms(words: torch.Tensor, digit_bits: int):
    """Yield each pass's stable argsort of its digit, applied to the words."""
    u = _unsigned_rank(words)
    for shift, nbits in _passes(words, digit_bits):
        perm = torch.argsort(_digit(u, shift, nbits), stable=True)
        u = u[perm]
        yield perm


def _rank_pass_dests(words: torch.Tensor, digit_bits: int):
    """Yield each pass's scatter destinations: histogram (mod.rs:95-99),
    exclusive scan (mod.rs:110-120), rank within bin (mod.rs:130-154). The
    one-hot is laid out (bins, N), so its running count scans the
    contiguous axis (a scan down 16 strided columns runs one thread each)."""
    nbins = 1 << digit_bits
    u = _unsigned_rank(words)
    bins = torch.arange(nbins, dtype=torch.int64, device=words.device)
    rows = torch.arange(words.shape[0], dtype=torch.int64, device=words.device)
    for shift, nbits in _passes(words, digit_bits):
        d = _digit(u, shift, nbits)
        onehot = (bins[:, None] == d[None, :]).to(torch.int32)
        counts = onehot.sum(dim=1, dtype=torch.int64)
        offsets = torch.cumsum(counts, 0) - counts
        # rank within bin = # earlier rows with the same digit: the scatter
        # is a stable partition
        rank = (torch.cumsum(onehot, 1, dtype=torch.int32) - onehot)[d, rows]
        dest = offsets[d] + rank
        u = torch.empty_like(u).index_copy_(0, dest, u)
        yield dest


def radix_sort_words_argsort(words: torch.Tensor, digit_bits: int = 8) -> torch.Tensor:
    """Variant 0: LSD passes, each a stable argsort of the pass digit. LSD
    over stable per-digit partitions yields a total sort (the invariant of
    mod.rs:84's outer ``for digit`` loop)."""
    out = words
    for perm in _argsort_pass_perms(words, digit_bits):
        out = out[perm]
    return out


def radix_sort_words_rank(words: torch.Tensor, digit_bits: int = 4) -> torch.Tensor:
    """Variant 1: LSD passes with an explicit histogram, scan, rank and
    scatter: a per-pass (2**digit_bits, N) one-hot digit matrix,
    destination = bin offset + rank within the bin. O(N * 2**digit_bits)
    memory: pedagogical sizes only."""
    out = words
    for dest in _rank_pass_dests(words, digit_bits):
        out = torch.empty_like(out).index_copy_(0, dest, out)
    return out


def radix_argsort_words_argsort(words: torch.Tensor, digit_bits: int = 8) -> torch.Tensor:
    """Permutation-returning form of variant 0 (int64)."""
    total = torch.arange(words.shape[0], dtype=torch.int64, device=words.device)
    for perm in _argsort_pass_perms(words, digit_bits):
        total = total[perm]
    return total


def radix_argsort_words_rank(words: torch.Tensor, digit_bits: int = 4) -> torch.Tensor:
    """Permutation-returning form of variant 1 (int64)."""
    total = torch.arange(words.shape[0], dtype=torch.int64, device=words.device)
    for dest in _rank_pass_dests(words, digit_bits):
        total = torch.empty_like(total).index_copy_(0, dest, total)
    return total


def counting_sort_u8(x: torch.Tensor) -> torch.Tensor:
    """Single-pass counting sort for uint8 (reference ``counting_sort``,
    mod.rs:40-59): histogram, then emit each value count[v] times."""
    if x.dtype != torch.uint8:
        raise TypeError(f"counting_sort_u8 takes uint8, got {x.dtype}")
    counts = torch.bincount(x.reshape(-1).to(torch.int64), minlength=256)
    vals = torch.arange(256, dtype=torch.uint8, device=x.device)
    return torch.repeat_interleave(vals, counts, output_size=x.numel())
