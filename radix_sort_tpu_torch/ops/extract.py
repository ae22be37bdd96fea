"""Bucket extraction: the stable run scatter at the heart of the sample sort.

Counterpart of ``radix_sort_tpu/ops/extract.py``. Chunks arrive grouped (a
stable row sort plays the role of the reference's per-chunk histogram and
rank, src/radix_sort/mod.rs:90-109), and each chunk's per-bucket run is
appended into a packed per-bucket region, in chunk order, like the
reference's buffered stable scatter (mod.rs:121-168).

On a CUDA tensor :func:`bucket_extract` launches the hand-written kernel in
``csrc/extract.cu`` (built at first use, see ``_build.py``); it replaces the
Pallas kernel ``radix_sort_tpu/ops/extract.py:bucket_extract``. On a CPU
tensor it runs :func:`bucket_extract_plain`, the plain PyTorch version of
the same contract, which the tests and ``chip_smoke.py`` hold the kernel
against. Any other device raises.

The kernel is bound by bytes moved: each valid word is read once and each
output word (valid word or sentinel) written once, by the kernel itself;
the source note in ``csrc/extract.cu`` says how the design keeps to that.
The compactor (concatenate the valid prefixes of padded regions) is the
K=1 case of the same kernel.
"""

from __future__ import annotations

import ctypes

import torch

from radix_sort_tpu_torch import _build

__all__ = [
    "bucket_extract",
    "bucket_extract_plain",
    "compact_regions",
    "launch",
    "MAX_WORD",
    "LAUNCHES",
]

# the unsigned all-ones sentinel of the JAX package, as a signed rank word
MAX_WORD = (1 << 31) - 1
LANES = 128
FLUSH_EROWS = 8  # output capacities stay multiples of 8 rows, as in the reference

# Calls of :func:`launch` that reached the CUDA kernel (one per call,
# however many raw kernel launches the call makes).
LAUNCHES = 0


def _geometry(ops, bounds, K, chunks_per_bucket, nbuckets):
    """Validate the operands; return (nchunks, m) with m = words per chunk."""
    if not ops:
        raise ValueError("bucket_extract needs at least one operand")
    nchunks = bounds.shape[0]
    if bounds.dtype != torch.int32 or tuple(bounds.shape) != (nchunks, K + 1):
        raise ValueError(f"bounds must be int32 of shape (nchunks, {K + 1}), got "
                         f"{bounds.dtype} {tuple(bounds.shape)}")
    if nchunks != chunks_per_bucket * nbuckets:
        raise ValueError(f"{nchunks} chunks != {chunks_per_bucket} per bucket "
                         f"x {nbuckets} buckets")
    shape = tuple(ops[0].shape)
    for o in ops:
        if o.dtype != torch.int32 or tuple(o.shape) != shape or o.device != bounds.device:
            raise ValueError("operands must be int32 tensors of one shape, on the "
                             "device of bounds")
    if len(shape) != 2 or shape[1] != LANES or shape[0] % nchunks:
        raise ValueError(f"operands must be (nchunks*cr, {LANES}), got {shape}")
    return nchunks, shape[0] // nchunks * LANES


def bucket_extract_plain(ops, bounds, *, K, cap_rows, chunks_per_bucket, nbuckets):
    """Plain PyTorch version of :func:`bucket_extract` (same contract)."""
    nchunks, m = _geometry(ops, bounds, K, chunks_per_bucket, nbuckets)
    dev = bounds.device
    cap = cap_rows * LANES
    b64 = bounds.to(torch.int64)
    per = (b64[:, 1:] - b64[:, :-1]).reshape(nbuckets, chunks_per_bucket, K)
    counts = per.sum(1).reshape(-1).to(torch.int32)
    offs = (per.cumsum(1) - per).reshape(nchunks, K)  # exclusive, chunk order
    j = torch.arange(m, device=dev).expand(nchunks, m)
    valid = (j >= b64[:, :1]) & (j < b64[:, K:])
    d = torch.searchsorted(b64[:, :K].contiguous(), j.contiguous(), right=True) - 1
    d = d.clamp(0, K - 1)  # the last run that starts at or before j
    dst = offs.gather(1, d) + (j - b64.gather(1, d))
    valid &= (dst >= 0) & (dst < cap)  # writes past a region's capacity drop
    region = (torch.arange(nchunks, device=dev) // chunks_per_bucket)[:, None] * K + d
    where = (region * cap + dst)[valid]
    outs = []
    for o in ops:
        out = torch.full((nbuckets * K * cap,), MAX_WORD, dtype=torch.int32, device=dev)
        out[where] = o.reshape(nchunks, m)[valid]
        outs.append(out.reshape(-1, LANES))
    return outs, counts


_FN = None


def _kernel():
    """(C entry point, chunks per scan tile) of csrc/extract.cu, built and
    bound at first use."""
    global _FN
    if _FN is None:
        lib = _build.load("extract")
        fn = lib.rst_bucket_extract
        pp, vp, i = ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [pp, pp, i, vp, vp, vp, vp, i, i, i, i, ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
        lib.rst_extract_scan_tile.argtypes = []
        lib.rst_extract_scan_tile.restype = ctypes.c_int
        _FN = (fn, lib.rst_extract_scan_tile())
    return _FN


def launch(ops, bounds, outs, counts, *, K, cap_rows, chunks_per_bucket, nbuckets):
    """Run the CUDA kernel into caller-given outputs.

    ``outs``: one contiguous, 16-byte aligned int32 tensor of
    ``nbuckets*K*cap_rows*128`` words per operand; the kernel writes every
    word, the sentinel :data:`MAX_WORD` at or past each region's count.
    ``counts``: int32 of ``nbuckets*K``. Bounds must be non-decreasing
    within ``[0, words per chunk]``, as :func:`bucket_extract` takes them.
    """
    global LAUNCHES
    nchunks, m = _geometry(ops, bounds, K, chunks_per_bucket, nbuckets)
    dev = bounds.device
    if dev.type != "cuda":
        raise ValueError(f"the extract kernel runs on CUDA tensors, got {dev}")
    if nchunks * m >= 1 << 31:
        raise ValueError("the extract kernel takes fewer than 2**31 words per operand")
    out_words = nbuckets * K * cap_rows * LANES
    for o in outs:
        if (o.dtype != torch.int32 or o.device != dev or not o.is_contiguous()
                or o.numel() != out_words or o.data_ptr() % 16):
            raise ValueError(f"outputs must be contiguous, 16-byte aligned int32 of "
                             f"{out_words} words on {dev}")
    if (counts.dtype != torch.int32 or counts.device != dev or not counts.is_contiguous()
            or counts.numel() != nbuckets * K):
        raise ValueError(f"counts must be contiguous int32 of {nbuckets * K} on {dev}")
    if len(outs) != len(ops):
        raise ValueError("one output per operand")
    fn, scan_tile = _kernel()
    # the kernel loads each chunk as 16-byte vectors
    ops = [o.contiguous() for o in ops]
    ops = [o if o.data_ptr() % 16 == 0 else o.clone() for o in ops]
    bounds = bounds.contiguous()
    # int32 scratch: each scan tile's run totals, then each run's offset
    n_tsum = nbuckets * -(-chunks_per_bucket // scan_tile) * K
    scratch = torch.empty((n_tsum + nchunks * K,), dtype=torch.int32, device=dev)
    n = len(ops)
    ins = (ctypes.c_void_p * n)(*[o.data_ptr() for o in ops])
    dsts = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(ins, dsts, n, bounds.data_ptr(), scratch.data_ptr(),
                 scratch.data_ptr() + 4 * n_tsum, counts.data_ptr(), nchunks, K, m,
                 chunks_per_bucket, cap_rows * LANES, stream)
    if err:
        raise RuntimeError(f"extract kernel launch failed: CUDA error {err}")
    LAUNCHES += 1


def bucket_extract(ops, bounds, *, K, cap_rows, chunks_per_bucket, nbuckets):
    """Extract per-(chunk, bucket) runs into packed per-bucket regions.

    ops: list of int32 tensors, each (nchunks*cr, 128) -- chunk c grouped so
        that its bucket-d run occupies [bounds[c,d], bounds[c,d+1]).
    bounds: (nchunks, K+1) int32, non-decreasing, bounds[c,K] = valid length.
    Returns (outs, counts): one (nbuckets*K*cap_rows, 128) tensor per operand
    (region r's valid prefix is counts[r] words, the rest MAX_WORD) and
    counts (nbuckets*K,) int32, uncapped.
    """
    dev = bounds.device
    if dev.type == "cpu":
        return bucket_extract_plain(ops, bounds, K=K, cap_rows=cap_rows,
                                    chunks_per_bucket=chunks_per_bucket,
                                    nbuckets=nbuckets)
    if dev.type != "cuda":
        raise ValueError(f"bucket_extract runs on CPU or CUDA tensors, got {dev}")
    rows = nbuckets * K * cap_rows
    outs = [torch.empty((rows, LANES), dtype=torch.int32, device=dev) for _ in ops]
    counts = torch.empty((nbuckets * K,), dtype=torch.int32, device=dev)
    launch(ops, bounds, outs, counts, K=K, cap_rows=cap_rows,
           chunks_per_bucket=chunks_per_bucket, nbuckets=nbuckets)
    return outs, counts


def compact_regions(ops, counts, *, cap_rows):
    """Concatenate the valid prefixes of equal-capacity regions densely.

    ops: list of (nregions*cap_rows, 128) int32; counts: (nregions,) int32.
    Returns (outs, total): per-operand dense tensors (valid prefix = total)
    with a few rows of slack capacity.
    """
    nregions = counts.shape[0]
    # overflowed regions report counts beyond their capacity; clamp before
    # using them as run bounds (callers discard an overflowed result anyway)
    counts = torch.clamp(counts, max=cap_rows * LANES)
    bounds = torch.stack([torch.zeros_like(counts), counts], dim=1)
    # the reference pads the region count to a multiple of 8 with empty
    # regions; they move nothing, so only its output size is kept here,
    # which lets whole output arrays compare
    nreg_padded = -(-nregions // 8) * 8
    out_cap = nreg_padded * cap_rows + 5 * FLUSH_EROWS
    out_cap = -(-out_cap // FLUSH_EROWS) * FLUSH_EROWS
    return bucket_extract(ops, bounds, K=1, cap_rows=out_cap,
                          chunks_per_bucket=nregions, nbuckets=1)
