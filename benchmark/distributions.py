"""Key samplers of the reference crate's ``src/distr.rs``, made on the device
from a ``torch.Generator``.

Frozen copies of ``radix_sort_tpu_torch/utils/distributions.py``
(``key_uniform``, ``zipf``, ``zipf_limbs``, ``step_uniform``), kept here so
that a change to the program cannot move the benchmark's inputs. The 64-bit
samplers return the u64 value whole instead of its rank limbs.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}


def _bits32(gen, n):
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, generator=gen,
                         device=gen.device)


def uniform(gen: torch.Generator, n: int, dtype) -> torch.Tensor:
    """Uniform words over the full range of uint32 or uint64 (KeyUniform,
    distr.rs:40-52)."""
    if dtype == torch.uint64:
        hi = _bits32(gen, n).to(torch.int64)
        lo = _bits32(gen, n).to(torch.int64) & _M32
        return ((hi << 32) | lo).view(torch.uint64)
    return _bits32(gen, n).view(torch.uint32)


def _zipf_u64(gen, n, s):
    """ZipfU64 (distr.rs:108-130): Zipf<f32> over [1, 2**64), the inverse
    CDF's value decomposed as 2**y = mant24 * 2**(k-23), y in float32, the
    bits below the 24-bit mantissa uniform jitter."""
    u = torch.rand((n,), generator=gen, device=gen.device, dtype=torch.float32)
    u = u * (1.0 - 1e-7) + 1e-7
    if abs(s - 1.0) < 1e-6:
        y = u * 64.0
    else:
        t = 1.0 - s
        a = float(2.0 ** (64.0 * t))  # M**t in log2 space, f32-safe for |64t| < 126
        y = torch.log2(1.0 + u * (a - 1.0)) / t
    y = torch.clamp(y, 0.0, 63.999)
    k = torch.clamp(torch.floor(y), 0.0, 63.0)
    f = torch.clamp(y - k, 0.0, 1.0)
    k = k.to(torch.int64)
    m24 = torch.clamp(torch.floor(torch.exp2(f) * float(1 << 23)).to(torch.int64),
                      1 << 23, (1 << 24) - 1)
    sh = k - 23  # value = m24 * 2**sh, sh in [-23, 40]: the int64 shift wraps mod 2**64
    v = torch.where(sh >= 0, m24 << sh.clamp(min=0), m24 >> (-sh).clamp(min=0))
    rh = _bits32(gen, n).to(torch.int64) & _M32
    rl = _bits32(gen, n).to(torch.int64) & _M32
    v = v | (((rh << 32) | rl) & ((1 << sh.clamp(min=0)) - 1))
    return v.view(torch.uint64)


def zipf(gen: torch.Generator, n: int, dtype, s: float = 1.1) -> torch.Tensor:
    """Zipf(s) keys over [1, MAX] (ZipfU32 by the float64 inverse CDF of the
    bounded power law, distr.rs:54-76; ZipfU64 as :func:`_zipf_u64`)."""
    if dtype == torch.uint64:
        return _zipf_u64(gen, n, s)
    m = float(_M32)
    u = torch.rand((n,), generator=gen, device=gen.device, dtype=torch.float64)
    u = u * (1.0 - 1e-7) + 1e-7
    if abs(s - 1.0) < 1e-6:
        x = torch.exp(u * torch.log(torch.tensor(m, dtype=torch.float64)))
    else:
        t = 1.0 - s
        x = (1.0 + u * (m**t - 1.0)) ** (1.0 / t)
    return torch.clamp(x, 1.0, m).to(torch.int64).to(torch.int32).view(torch.uint32)


def step_uniform(gen: torch.Generator, n: int, dtype, steps: int) -> torch.Tensor:
    """A uniform choice among ``steps`` values s*(1+i), s = MAX/(steps+1),
    exact integers (StepUniform, distr.rs:78-106, 132-160)."""
    bits = 64 if dtype == torch.uint64 else 32
    step = ((1 << bits) - 1) // (steps + 1)
    i = torch.randint(0, steps, (n,), generator=gen, device=gen.device)
    if bits == 64:  # (i + 1) * step mod 2**64: one int64 product, which wraps
        return ((i + 1) * (step - (1 << 64) if step >> 63 else step)).view(torch.uint64)
    return ((i + 1) * step).to(torch.int32).view(torch.uint32)
