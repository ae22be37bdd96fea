"""Input-distribution generators, made on the device from a ``torch.Generator``.

Counterparts of the JAX package's ``utils/distributions.py`` samplers that
the reference's src/distr.rs defines:

  key_uniform   -- uniform keys over the full dtype range (KeyUniform,
                   distr.rs:40-52)
  step_uniform  -- num_steps equally spaced distinct values s*(1+i),
                   s = MAX/(num_steps+1), duplicate-heavy (StepUniform,
                   distr.rs:78-106, 132-160)
  zipf          -- Zipf(s) over [1, MAX] by inverse CDF of the bounded
                   continuous power law (ZipfU32/ZipfU64, distr.rs:54-76,
                   108-130)
  geometric     -- Geometric(lambda), failures before the first success
                   (MyExp, distr.rs:4-38)

and the genuine 64-bit samplers as (hi, lo) int32 rank limbs
(``key_uniform_limbs``, ``zipf_limbs``, ``geometric_limbs``,
``step_uniform_limbs``; the limbs ``keys.split64`` gives a u64 key).

The generator's device decides where the data is made; a CUDA generator
makes it directly in device memory. PyTorch's random bits differ from the
JAX package's, so tests compare distributions, not values; the
deterministic parts (``_mul32x32``, the bit placement of
``_pow2_to_limbs``, the value sets of the step samplers) are the JAX
package's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "key_uniform",
    "zipf",
    "geometric",
    "step_uniform",
    "make_pairs",
    "key_uniform_limbs",
    "zipf_limbs",
    "geometric_limbs",
    "step_uniform_limbs",
]

_M32 = 0xFFFFFFFF

_SIGNED_OF = {
    torch.uint8: torch.int8, torch.uint16: torch.int16,
    torch.uint32: torch.int32, torch.uint64: torch.int64,
    torch.int8: torch.int8, torch.int16: torch.int16,
    torch.int32: torch.int32, torch.int64: torch.int64,
}


def _bits32(gen, n):
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         generator=gen, device=gen.device)


def _uniform_bits(gen, n, sdt):
    """n uniform words of the signed dtype ``sdt`` (every bit uniform)."""
    if sdt == torch.int64:
        hi = _bits32(gen, n).to(torch.int64)
        lo = _bits32(gen, n).to(torch.int64) & 0xFFFFFFFF
        return (hi << 32) | lo
    return _bits32(gen, n).to(sdt)  # narrowing keeps the low bits


def key_uniform(gen: torch.Generator, n: int, dtype=torch.uint32) -> torch.Tensor:
    """Uniform keys over the full range of an integer dtype (distr.rs:42-51)."""
    return _uniform_bits(gen, n, _SIGNED_OF[dtype]).view(dtype)


def key_uniform_limbs(gen: torch.Generator, n: int):
    """Uniform u64 keys as (hi, lo) int32 rank limbs (distr.rs:47-51)."""
    return _bits32(gen, n), _bits32(gen, n)


def step_uniform(gen: torch.Generator, n: int, num_steps: int,
                 dtype=torch.uint32) -> torch.Tensor:
    """Uniform choice among ``num_steps`` values s*(1+i), s = MAX/(num_steps+1)
    (distr.rs:83-92, 137-146)."""
    sdt = _SIGNED_OF[dtype]
    bits = torch.iinfo(sdt).bits
    umax = torch.iinfo(dtype).max if dtype.is_signed else (1 << bits) - 1
    step = umax // (num_steps + 1)
    # the distinct values, exactly, as the bit patterns of the signed dtype
    vals = [(step * (i + 1)) & ((1 << bits) - 1) for i in range(num_steps)]
    vals = [v - (1 << bits) if v >= 1 << (bits - 1) else v for v in vals]
    table = torch.tensor(vals, dtype=sdt, device=gen.device)
    i = torch.randint(0, num_steps, (n,), generator=gen, device=gen.device)
    return table[i].view(dtype)


def zipf(gen: torch.Generator, n: int, dtype=torch.uint32, s: float = 1.1) -> torch.Tensor:
    """Zipf(s)-distributed keys over [1, MAX] (distr.rs:60-63, 114-117):
    heavy mass on small keys, controlled by s."""
    sdt = _SIGNED_OF[dtype]
    bits = torch.iinfo(sdt).bits
    m = float(torch.iinfo(dtype).max if dtype.is_signed else (1 << bits) - 1)
    u = torch.rand((n,), generator=gen, device=gen.device, dtype=torch.float64)
    u = u * (1.0 - 1e-7) + 1e-7
    if abs(s - 1.0) < 1e-6:
        x = torch.exp(u * torch.log(torch.tensor(m, dtype=torch.float64)))
    else:
        t = 1.0 - s
        x = (1.0 + u * (m**t - 1.0)) ** (1.0 / t)
    # the largest float64 below 2**64 keeps the conversion in range
    x = torch.clamp(x, 1.0, min(m, 18446744073709549568.0))
    if bits == 64 and not dtype.is_signed:
        x = torch.where(x >= 2.0**63, x - 2.0**64, x)  # wrap into int64 bits
    return x.to(torch.int64).to(sdt).view(dtype)


def geometric(gen: torch.Generator, n: int, lam: float = 0.01,
              dtype=torch.uint32) -> torch.Tensor:
    """Geometric(lambda): failures before the first success, floor(ln U /
    ln(1 - lambda)) clamped to the dtype's max (distr.rs:17-19)."""
    sdt = _SIGNED_OF[dtype]
    bits = torch.iinfo(sdt).bits
    m = float(torch.iinfo(dtype).max if dtype.is_signed else (1 << bits) - 1)
    u = _uniform_f32(gen, n, 1e-37)
    g = torch.floor(torch.log(u) / math.log1p(-lam)).to(torch.float64)
    g = torch.clamp(g, max=min(m, 18446744073709549568.0))
    if bits == 64 and not dtype.is_signed:
        g = torch.where(g >= 2.0**63, g - 2.0**64, g)  # wrap into int64 bits
    return g.to(torch.int64).to(sdt).view(dtype)


def make_pairs(keys: torch.Tensor):
    """(key, payload=0) rows, the reference's tuple Distribution impls
    (e.g. distr.rs:47-51): the payload is a zero word of the key width."""
    sdt = _SIGNED_OF.get(keys.dtype, keys.dtype)  # unsigned zeros through the signed view
    return keys, torch.zeros_like(keys.view(sdt)).view(keys.dtype)


# ---------------------------------------------------------------------------
# Genuine 64-bit samplers as (hi, lo) int32 rank limbs.
#
# The reference's ZipfU64 samples Zipf<f32> over [1, u64::MAX]
# (distr.rs:108-130): f32 mantissa precision over the full 64-bit exponent
# range. The inverse-CDF value is decomposed as 2**y = mant24 * 2**(k-23),
# y in float32, so the skew shapes the whole 64-bit value; the bits below
# the 24-bit mantissa are filled with uniform jitter. Unsigned 32-bit limbs
# are held in int64 tensors (every value in [0, 2**32)) until
# :func:`_rank_limb` turns them into the port's signed rank limbs.


def _uniform_f32(gen, n, lo):
    """n float32 draws from [lo, 1), as ``jax.random.uniform(minval=lo)``."""
    u = torch.rand((n,), generator=gen, device=gen.device, dtype=torch.float32)
    return u * (1.0 - lo) + lo


def _u32(gen, n):
    """n uniform unsigned 32-bit words, held in int64."""
    return _bits32(gen, n).to(torch.int64) & _M32


def _rank_limb(u):
    """An unsigned 32-bit limb (int64 in [0, 2**32)) -> its int32 rank limb
    (the sign bit flipped, as ``keys.split64``)."""
    return (u ^ (1 << 31)).to(torch.int32)


def _pow2_to_limbs(y, gen):
    """floor(2**y) for float32 y in [0, 64) -> unsigned (hi, lo) 32-bit
    limbs in int64, the bits below the 24-bit mantissa jittered from
    ``gen``."""
    k = torch.clamp(torch.floor(y), 0.0, 63.0)
    f = torch.clamp(y - k, 0.0, 1.0)
    k = k.to(torch.int64)
    m24 = torch.clamp(torch.floor(torch.exp2(f) * float(1 << 23)).to(torch.int64),
                      1 << 23, (1 << 24) - 1)
    sh = k - 23  # value = m24 * 2**sh, sh in [-23, 40]: the int64 shift wraps mod 2**64
    v = torch.where(sh >= 0, m24 << sh.clamp(min=0), m24 >> (-sh).clamp(min=0))
    # jitter the sh zero bits below the mantissa
    rh, rl = _u32(gen, y.shape[0]), _u32(gen, y.shape[0])
    v = v | (((rh << 32) | rl) & ((1 << sh.clamp(min=0)) - 1))
    return (v >> 32) & _M32, v & _M32


def zipf_limbs(gen: torch.Generator, n: int, s: float = 1.1):
    """Zipf(s) over [1, 2**64) as (hi, lo) int32 rank limbs (ZipfU64,
    distr.rs:108-130)."""
    u = _uniform_f32(gen, n, 1e-7)
    if abs(s - 1.0) < 1e-6:
        y = u * 64.0
    else:
        t = 1.0 - s
        a = float(2.0 ** (64.0 * t))  # M**t in log2 space, f32-safe for |64t| < 126
        y = torch.log2(1.0 + u * (a - 1.0)) / t
    hi, lo = _pow2_to_limbs(torch.clamp(y, 0.0, 63.999), gen)
    return _rank_limb(hi), _rank_limb(lo)


def geometric_limbs(gen: torch.Generator, n: int, lam: float = 1e-12):
    """Geometric(lambda) as (hi, lo) int32 rank limbs (MyExp over u64,
    distr.rs:27-31): floor(ln U / ln(1-lambda)), the full 64-bit range for a
    tiny lambda."""
    u = _uniform_f32(gen, n, 1e-37)
    c = -math.log1p(-lam)
    y = torch.log2(-torch.log(u)) - float(np.float32(math.log2(c)))
    hi, lo = _pow2_to_limbs(torch.clamp(y, 0.0, 63.999), gen)
    neg = y < 0.0  # values in [0, 1) floor to 0
    return _rank_limb(torch.where(neg, 0, hi)), _rank_limb(torch.where(neg, 0, lo))


def _mul32x32(a, b_const: int):
    """Exact (a * b) mod 2**64 for unsigned 32-bit ``a`` (int64 tensor) and a
    64-bit Python constant ``b`` -> unsigned (hi, lo) 32-bit limbs in int64:
    one int64 product, which wraps mod 2**64."""
    b = b_const & ((1 << 64) - 1)
    p = a * (b - (1 << 64) if b >> 63 else b)
    return (p >> 32) & _M32, p & _M32


def step_uniform_limbs(gen: torch.Generator, n: int, num_steps: int):
    """``num_steps`` equally spaced u64 values step*(1+i) as (hi, lo) int32
    rank limbs, exact integers (StepUniformU64, distr.rs:132-160)."""
    step = (2**64 - 1) // (num_steps + 1)
    i = torch.randint(0, num_steps, (n,), generator=gen, device=gen.device)
    hi, lo = _mul32x32(i + 1, step)
    return _rank_limb(hi), _rank_limb(lo)
