"""Kernel-engine wiring: the word-level sort entry points on the sample sort.

Counterpart of ``radix_sort_tpu/ops/pallas_sort.py`` (the file keeps its
name so the counterpart is found). Here it wires the hand-written CUDA
engine: ops/sample_sort.py, whose data movement is the bucket-extraction
kernel in ``csrc/extract.cu``. 64-bit rank words travel as (hi, lo) int32
limb pairs (``keys.split64``).

``sort_pairs_limbs`` (the benchmark's path: u64 key / u64 payload rows as
limb quadruples) follows the config's default engine under "auto", which
is the comparator; ``engine="sample"`` selects the kernel pipeline.
"""

from __future__ import annotations

import torch

from radix_sort_tpu_torch import config
from radix_sort_tpu_torch import keys as K
from radix_sort_tpu_torch.ops import sample_sort
from radix_sort_tpu_torch.ops._cosort import cosort

__all__ = [
    "sort_words",
    "argsort_words",
    "sort_pairs_words",
    "sort_pairs_limbs",
]

_SIGNED_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _min_pipeline_n():
    """Below this the pipeline's chunk padding dominates; use the comparator.
    Read at call time so config.override retunes it."""
    return config.get().min_pipeline_n


def _word_ops(words):
    """Rank words -> (list of int32 limbs, number of key limbs)."""
    if words.element_size() == 8:
        return list(K.split64(words)), 2
    return [K.widen_limb(words)], 1


def _restore(ops, dtype):
    if torch.iinfo(dtype).bits == 64:
        return K.merge64(ops[0], ops[1])
    return K.narrow_limb(ops[0], dtype)


def sort_words(words: torch.Tensor) -> torch.Tensor:
    if words.shape[0] < _min_pipeline_n():
        return torch.sort(words, stable=True).values
    ops, nk = _word_ops(words)
    out = sample_sort.sample_sort_words(ops, nk)
    return _restore(out, words.dtype)


def argsort_words(words: torch.Tensor) -> torch.Tensor:
    if words.shape[0] < _min_pipeline_n():
        return torch.argsort(words, stable=True)
    ops, nk = _word_ops(words)
    idx = torch.arange(words.shape[0], dtype=torch.int32, device=words.device)
    out = sample_sort.sample_sort_words(ops + [idx], nk)
    return out[nk].to(torch.int64)


def _payload_ops(values):
    """Any payload -> int32 words that carry its bits exactly."""
    size = values.element_size()
    w = values.view(_SIGNED_OF_SIZE[size])
    if size == 8:
        return list(K.split64(w))
    return [w.to(torch.int32)]  # narrower payloads sign-extend; narrowing undoes it


def _payload_restore(vout, dtype, size):
    if size == 8:
        return K.merge64(vout[0], vout[1]).view(dtype)
    return vout[0].to(_SIGNED_OF_SIZE[size]).view(dtype)


def sort_pairs_words(words: torch.Tensor, values: torch.Tensor):
    if words.shape[0] < _min_pipeline_n():
        srt = torch.sort(words, stable=True)
        # unsigned payloads gather as their signed view (CUDA indexes no UInt32)
        size = values.element_size()
        return srt.values, values.view(_SIGNED_OF_SIZE[size])[srt.indices].view(values.dtype)
    ops, nk = _word_ops(words)
    vops = _payload_ops(values)
    out = sample_sort.sample_sort_words(ops + vops, nk)
    return (_restore(out[:nk], words.dtype),
            _payload_restore(out[nk:], values.dtype, values.element_size()))


def sort_pairs_limbs(khi, klo, vhi, vlo, engine: str = "auto"):
    """Stable sort of u64 key/payload rows held as int32 limb quadruples.

    Lexicographic (hi, lo) order == the u64 order (keys.split64).
    ``engine``: "comparator" (stable ``torch.sort``), "sample" (the kernel
    pipeline), or "auto" (the active config's default engine).
    """
    if engine == "auto":
        default = config.get().default_implementation
        engine = "sample" if default in ("pallas", "sample") else "comparator"
    if engine == "sample":
        return tuple(sample_sort.sample_sort_words([khi, klo, vhi, vlo], 2))
    return tuple(cosort([khi, klo, vhi, vlo], 2))
