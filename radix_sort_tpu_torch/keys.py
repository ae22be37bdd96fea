"""Order-preserving key bit-transforms (the key-abstraction layer).

Counterpart of ``radix_sort_tpu/keys.py``. Every supported dtype maps into a
SIGNED "rank word" of the same width, so that

    signed_compare(encode(a), encode(b))  ==  total_order_compare(a, b)

The JAX package's rank words are unsigned; here they are the same bits with
the sign bit flipped (the reference word ``^ MIN``, viewed as signed), so
signed order equals the reference's unsigned order. Signed words are used
because PyTorch's CPU kernels do not implement ``<``, ``>>``,
``searchsorted`` or ``gather`` for uint32/uint64. Transforms:

  * unsigned ints  -- flip the sign bit        (x ^ MIN, viewed signed)
  * signed ints    -- identity
  * floats         -- negative values flip every bit but the sign, positive
                      values stay: IEEE total_cmp order, including
                      -0.0 < +0.0 and NaNs ordered by sign and payload.

Unsigned and float inputs are reinterpreted with ``.view`` at the boundary;
no value conversion happens. 64-bit words split into (hi, lo) int32 limbs
(:func:`split64`) whose lexicographic signed order equals the word's order;
the pipeline runs on such 32-bit limbs.
"""

from __future__ import annotations

import torch

__all__ = [
    "encode",
    "decode",
    "encoded_dtype",
    "num_digit_bits",
    "split64",
    "merge64",
    "encode_limbs",
    "decode_limbs",
    "num_limbs",
    "widen_limb",
    "narrow_limb",
    "encode128",
    "decode128",
    "SUPPORTED_DTYPES",
]

# dtype -> (signed rank-word dtype, bit width)
_UNSIGNED = {
    torch.uint8: (torch.int8, 8),
    torch.uint16: (torch.int16, 16),
    torch.uint32: (torch.int32, 32),
    torch.uint64: (torch.int64, 64),
}
_SIGNED = {
    torch.int8: (torch.int8, 8),
    torch.int16: (torch.int16, 16),
    torch.int32: (torch.int32, 32),
    torch.int64: (torch.int64, 64),
}
_FLOAT = {
    torch.float32: (torch.int32, 32),
    torch.float64: (torch.int64, 64),
}

SUPPORTED_DTYPES = tuple(_UNSIGNED) + tuple(_SIGNED) + tuple(_FLOAT)

_INT32_MIN = -(1 << 31)


def _lookup(dtype):
    for table in (_UNSIGNED, _SIGNED, _FLOAT):
        if dtype in table:
            return table[dtype]
    raise TypeError(f"unsupported key dtype: {dtype}")


def _min(bits: int) -> int:
    return -(1 << (bits - 1))


def _max(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def encoded_dtype(dtype) -> torch.dtype:
    """Signed rank-word dtype that ``encode`` produces for ``dtype``."""
    return _lookup(dtype)[0]


def num_digit_bits(dtype) -> int:
    """Total key width in bits (8 * reference NUMBER_OF_DIGITS)."""
    return _lookup(dtype)[1]


def encode(keys: torch.Tensor) -> torch.Tensor:
    """Map keys to signed words whose signed order is the keys' total order."""
    sdt, bits = _lookup(keys.dtype)
    if keys.dtype in _UNSIGNED:
        return keys.view(sdt) ^ _min(bits)
    if keys.dtype in _SIGNED:
        return keys
    i = keys.view(sdt)
    # negative -> flip every bit but the sign; non-negative -> unchanged
    return i ^ ((i >> (bits - 1)) & _max(bits))


def decode(words: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`encode`: signed rank words -> original dtype."""
    sdt, bits = _lookup(dtype)
    if words.dtype != sdt:
        raise TypeError(f"{dtype} decodes from {sdt} words, got {words.dtype}")
    if dtype in _UNSIGNED:
        return (words ^ _min(bits)).view(dtype)
    if dtype in _SIGNED:
        return words
    # the float transform keeps the sign bit, so it is its own inverse
    return (words ^ ((words >> (bits - 1)) & _max(bits))).view(dtype)


def split64(words: torch.Tensor):
    """int64 rank words -> (hi, lo) int32 rank limbs.

    Lexicographic signed order on (hi, lo) equals signed order on the word.
    """
    if words.dtype != torch.int64:
        raise TypeError(f"split64 takes int64 words, got {words.dtype}")
    hi = (words >> 32).to(torch.int32)
    lo = words.to(torch.int32) ^ _INT32_MIN  # .to truncates to the low half
    return hi, lo


def merge64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 limbs -> int64 words. Inverse of :func:`split64`."""
    return (hi.to(torch.int64) << 32) | ((lo ^ _INT32_MIN).to(torch.int64) & 0xFFFFFFFF)


def widen_limb(w: torch.Tensor) -> torch.Tensor:
    """A rank word of 8, 16 or 32 bits -> one int32 limb of the same order.

    Bit-identical to the JAX package's zero-extended unsigned limb under the
    sign-flip convention: the rank moves to an unsigned offset, then the
    32-bit sign bit flips."""
    bits = w.element_size() * 8
    if bits == 32:
        return w
    return (w.to(torch.int32) - _min(bits)) ^ _INT32_MIN


def narrow_limb(limb: torch.Tensor, sdt: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`widen_limb` into the rank-word dtype ``sdt``."""
    bits = torch.iinfo(sdt).bits
    if bits == 32:
        return limb
    return ((limb ^ _INT32_MIN) + _min(bits)).to(sdt)


def encode128(hi: torch.Tensor, lo: torch.Tensor, *, signed: bool = False):
    """128-bit keys held as (hi, lo) 64-bit words -> 4 big-endian int32 rank
    limbs for :func:`radix_sort_tpu_torch.sort_limbs`.

    The reference's u128/i128 key types (radix_digits.rs:37-53, 87-93).
    ``hi`` is uint64, or int64 when ``signed`` (i128): the sign flip of the
    whole 128-bit value is the sign flip :func:`encode` gives the high word.
    ``lo`` is always the unsigned uint64 low word.
    """
    if signed:
        if hi.dtype != torch.int64:
            raise TypeError(f"signed=True needs an int64 hi word, got {hi.dtype}")
    elif hi.dtype != torch.uint64:
        raise TypeError(f"signed=False needs a uint64 hi word, got {hi.dtype}")
    if lo.dtype != torch.uint64:
        raise TypeError(f"lo must be uint64 (the unsigned low word), got {lo.dtype}")
    return [*split64(encode(hi)), *split64(encode(lo))]


def decode128(limbs, *, signed: bool = False):
    """Inverse of :func:`encode128`: 4 big-endian int32 limbs -> (hi, lo)
    64-bit words (hi is int64 when ``signed``, else uint64)."""
    w0, w1, w2, w3 = limbs
    hi = decode(merge64(w0, w1), torch.int64 if signed else torch.uint64)
    return hi, decode(merge64(w2, w3), torch.uint64)


def encode_limbs(col: torch.Tensor):
    """One key column -> its big-endian int32 rank limbs.

    64-bit dtypes produce two limbs (:func:`split64`), narrower dtypes one;
    lexicographic signed order over the limbs equals the column's order.
    """
    w = encode(col)
    if w.element_size() == 8:
        return list(split64(w))
    return [widen_limb(w)]


def decode_limbs(limbs, dtype) -> torch.Tensor:
    """Inverse of :func:`encode_limbs` for one column."""
    if len(limbs) == 2:
        return decode(merge64(limbs[0], limbs[1]), dtype)
    (w,) = limbs
    return decode(narrow_limb(w, encoded_dtype(dtype)), dtype)


def num_limbs(dtype) -> int:
    """Limb count :func:`encode_limbs` produces for ``dtype``."""
    return 2 if num_digit_bits(dtype) == 64 else 1
