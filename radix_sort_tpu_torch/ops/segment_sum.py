"""The sum of each group of key-sorted rows: the float sums of GROUP BY.

After the aggregates' key sort the rows of a group lie together, and
``gid`` (``query._gid``, a running count of group starts) numbers the
groups 0, 1, ... in row order: dense ids, each row's the row before's or
one more.
:func:`segment_sum_sorted` gives every group's sum, accumulated in float64
in a fixed order and rounded once to the column's type (as ``Tensor.to``
rounds a float64: through float32 for the 16-bit types). The result is the
same bits on every run, and a float32 group of millions of rows reads its
correctly rounded sum, where a float32 accumulator swallows its addends.

On a CUDA tensor it launches the hand-written kernel SS in
``csrc/segment_sum.cu`` (built at first use, see ``_build.py``). It
replaces no TPU kernel: the JAX package sums groups with
``jax.ops.segment_sum``, a scatter that XLA emits. The port used
``index_add_``, whose float atomics all land on one address when the
groups are few. On a CPU tensor it runs :func:`segment_sum_sorted_plain`,
the plain PyTorch version of the same function, which the tests and
``chip_smoke.py`` hold the kernel against. Any other device raises.

The kernel is bound by bytes moved: the column read once and every output
row written once; ``gid`` is read at the tiles' ends, and whole only in
tiles that hold more than one group. The source note in
``csrc/segment_sum.cu`` says how its design keeps to that.
"""

from __future__ import annotations

import ctypes

import torch

from radix_sort_tpu_torch import _build

__all__ = ["launch", "segment_sum_sorted", "segment_sum_sorted_plain", "LAUNCHES", "TILE"]

# Calls of :func:`launch` that reached the CUDA kernel (one per call with
# rows: the tiles' pass and the carries' pass).
LAUNCHES = 0
TILE = 4096  # rows a block of the kernel sums
_DTYPES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2, torch.float64: 3}


def _check(x, gid):
    if x.dim() != 1 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be a 1-D float16, bfloat16, float32 or float64 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if gid.dtype != torch.int64 or tuple(gid.shape) != tuple(x.shape) or gid.device != x.device:
        raise ValueError(f"gid must be int64 of shape {tuple(x.shape)} on {x.device}, got "
                         f"{gid.dtype} {tuple(gid.shape)} on {gid.device}")


def segment_sum_sorted_plain(x, gid):
    """Plain PyTorch version of :func:`segment_sum_sorted` (same contract):
    one float64 scatter-add, rounded once."""
    _check(x, gid)
    s = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    return s.index_add_(0, gid, x.double()).to(x.dtype)


_FN = None


def _kernel():
    """The C entry point of csrc/segment_sum.cu, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = _build.load("segment_sum").rst_segment_sum_sorted
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, vp, ctypes.c_longlong, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(x, gid, out):
    """Run the CUDA kernel into a caller-given ``out`` of x's type and
    shape, every row of which it writes. Every tensor must be contiguous
    on one card. The carries, two a tile, go to scratch allocated here."""
    global LAUNCHES
    _check(x, gid)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the segment-sum kernel runs on CUDA tensors, got {dev}")
    if out.dtype != x.dtype or out.shape != x.shape or out.device != dev:
        raise ValueError(f"out must be {x.dtype} of shape {tuple(x.shape)} on {dev}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if not all(a.is_contiguous() for a in (x, gid, out)):
        raise ValueError("x, gid and out must be contiguous")
    n = x.shape[0]
    if not n:
        return
    carries = 2 * -(-n // TILE)
    ckey = torch.empty((carries,), dtype=torch.int64, device=dev)
    cval = torch.empty((carries,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = _kernel()(x.data_ptr(), _DTYPES[x.dtype], gid.data_ptr(), n, out.data_ptr(),
                        ckey.data_ptr(), cval.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"segment-sum kernel launch failed: CUDA error {err}")
    LAUNCHES += 1


def segment_sum_sorted(x, gid):
    """Each group's sum, groups numbered by key-sorted rows.

    x: (n,) float16, bfloat16, float32 or float64.
    gid: (n,) int64, dense group ids: 0 at the first row, and each row's
      the row before's or one more, as ``cumsum(group starts) - 1`` gives
      them (``query._gid``). It is not checked on the card (that would
      cost a host sync); other ids are outside the contract there.
    Returns ``out``, (n,) of x's type: ``out[g]`` is the sum of the rows
    whose ``gid`` is g, accumulated in float64 from +0.0 (a group of -0.0
    rows reads +0.0) and rounded once; rows [G, n) past the last group
    G - 1 hold +0.0. On a CUDA tensor one kernel launch (two kernels), no
    atomics: the same bits on every run.
    """
    dev = x.device
    if dev.type == "cpu":
        return segment_sum_sorted_plain(x, gid)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_sorted runs on CPU or CUDA tensors, got {dev}")
    x, gid = x.contiguous(), gid.contiguous()
    out = torch.empty_like(x)
    launch(x, gid, out)
    return out
