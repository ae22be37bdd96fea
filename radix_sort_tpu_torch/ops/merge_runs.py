"""A stable merge of P sorted runs: the distributed sort's final step.

After the exchange, a slot of the distributed sort holds its rows as P
runs back to back, one from each source slot in source order, each sorted
by its rank word. :func:`merge_runs` puts them in order: ties go to the
lower run, so the result is the stable sort of the whole, bit for bit, at
the cost of reading and writing each row once.

On a CUDA tensor :func:`merge_runs` launches the hand-written kernel in
``csrc/merge_runs.cu`` (built at first use, see ``_build.py``). It replaces
no TPU kernel: the JAX package's distributed sort sorts the received rows
again with ``lax.sort``. On a CPU tensor it runs :func:`merge_runs_plain`,
the plain PyTorch version of the same function, which the tests and
``chip_smoke.py`` hold the kernel against. Any other device raises.

The kernel is bound by bytes moved: every operand read once and written
once, 32 bytes a row at 16-byte (key, payload) rows. The source note in
``csrc/merge_runs.cu`` says how its design keeps to that.
"""

from __future__ import annotations

import ctypes

import torch

from radix_sort_tpu_torch import _build

__all__ = ["launch", "merge_runs", "merge_runs_plain", "LAUNCHES", "MAX_RUNS"]

# Calls of :func:`launch` that reached the CUDA kernel (a partition pass and
# the merge; one per call of up to MAX_COLS columns).
LAUNCHES = 0
MAX_RUNS = 64  # the kernel's runs a call
MAX_COLS = 64  # the kernel's columns a launch
GROUP = 8  # samples a tile
TILE_ROWS = 2048  # the most rows a tile may hold: (GROUP + P) samples' spacing
KEY_DTYPES = (torch.int32, torch.int64)


def _check(word, lengths, cols, fills=None):
    """Validate the arguments shared by both versions; returns the run
    edges (``len(lengths) + 1`` row offsets)."""
    if word.dim() != 1 or word.dtype not in KEY_DTYPES:
        raise ValueError(f"word must be a 1-D int32 or int64 tensor, got {word.dtype} "
                         f"{tuple(word.shape)}")
    if not lengths or any(int(x) < 0 for x in lengths):
        raise ValueError(f"lengths must be a non-empty list of run sizes, got {lengths}")
    edges = [0]
    for x in lengths:
        edges.append(edges[-1] + int(x))
    n = edges[-1]
    if word.shape[0] < n:
        raise ValueError(f"word holds {word.shape[0]} rows, the runs {n}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] < n or c.device != word.device:
            raise ValueError(f"every column must be 1-D with at least {n} rows on {word.device}, "
                             f"got {c.dtype} {tuple(c.shape)} on {c.device}")
    if fills is not None and len(fills) != len(cols):
        raise ValueError(f"{len(fills)} fills for {len(cols)} columns")
    return edges


def merge_runs_plain(word, lengths, cols, fills, capacity):
    """Plain PyTorch version of :func:`merge_runs` (same contract): each
    row's place is its index in its run plus its rank in every other run
    (``searchsorted``, right of equal keys in a lower run, left of them in
    a higher one), then one indexed store a column."""
    edges = _check(word, lengths, cols, fills)
    n = edges[-1]
    if capacity < n:
        raise ValueError(f"capacity ({capacity}) must hold the {n} rows")
    runs = [word[a:b] for a, b in zip(edges[:-1], edges[1:])]
    place = torch.empty((n,), dtype=torch.int64, device=word.device)
    for s, run in enumerate(runs):
        p = torch.arange(run.shape[0], dtype=torch.int64, device=word.device)
        for r, other in enumerate(runs):
            if r != s:
                p += torch.searchsorted(other, run, right=r < s)
        place[edges[s]:edges[s + 1]] = p
    outs = []
    for c, f in zip(cols, fills):
        out = torch.empty((capacity,), dtype=c.dtype, device=c.device)
        out[place] = c[:n]
        out[n:] = f
        outs.append(out)
    return outs


_FN = None


def _kernel():
    """The C entry point of csrc/merge_runs.cu, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = _build.load("merge_runs").rst_merge_sorted_runs
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, i32, vp, i32, vp, vp, vp, i32, i32, i64, i32, vp, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _spacing(p):
    """Rows between a run's samples: the largest power of two up to 256
    with (GROUP + p) of them in :data:`TILE_ROWS`."""
    s = 256
    while s > 1 and (GROUP + p) * s > TILE_ROWS:
        s //= 2
    return s


def launch(word, lengths, cols, outs):
    """Run the CUDA kernel: rows ``[0, n)`` of every ``outs[i]`` get
    ``cols[i]``'s rows in the merged order, n = ``sum(lengths)``; nothing
    else of ``outs`` is written. Every tensor must be contiguous, on one
    card, each column of 1, 2, 4 or 8 bytes a row beside an output of the
    same width."""
    global LAUNCHES
    edges = _check(word, lengths, cols)
    dev = word.device
    if dev.type != "cuda":
        raise ValueError(f"the merge kernel runs on CUDA tensors, got {dev}")
    p = len(lengths)
    if p > MAX_RUNS:
        raise ValueError(f"the merge kernel takes at most {MAX_RUNS} runs, got {p}")
    if len(outs) != len(cols):
        raise ValueError(f"{len(outs)} outputs for {len(cols)} columns")
    for c, o in zip(cols, outs):
        if c.element_size() not in (1, 2, 4, 8) or c.is_complex() or o.is_complex():
            raise ValueError(f"columns must be 1, 2, 4 or 8-byte real types, got {c.dtype}")
        if o.dim() != 1 or o.element_size() != c.element_size() or o.shape[0] < edges[-1] \
                or o.device != dev:
            raise ValueError(f"each output must be 1-D, {c.element_size()} bytes a row, with at "
                             f"least {edges[-1]} rows on {dev}, got {o.dtype} {tuple(o.shape)}")
    if not all(x.is_contiguous() for x in (word, *cols, *outs)):
        raise ValueError("word, columns and outputs must be contiguous")
    for x in (word, *cols, *outs):
        if x.data_ptr() % x.element_size():
            raise ValueError(f"a {x.dtype} operand is not aligned to its width")
    spacing = _spacing(p)
    samples = sum(-(-int(x) // spacing) for x in lengths)
    if not samples:
        return
    bounds = torch.empty(((-(-samples // GROUP) + 1) * p,), dtype=torch.int64, device=dev)
    lens = (ctypes.c_longlong * p)(*(int(x) for x in lengths))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for at in range(0, len(cols), MAX_COLS):
        chunk = range(at, min(at + MAX_COLS, len(cols)))
        key_col = next((i - at for i in chunk if cols[i].data_ptr() == word.data_ptr()
                        and cols[i].element_size() == word.element_size()), -1)
        k = len(chunk)
        src = (ctypes.c_void_p * k)(*(cols[i].data_ptr() for i in chunk))
        dst = (ctypes.c_void_p * k)(*(outs[i].data_ptr() for i in chunk))
        width = (ctypes.c_int * k)(*(cols[i].element_size() for i in chunk))
        with torch.cuda.device(dev):
            err = _kernel()(word.data_ptr(), word.element_size(), lens, p, src, dst, width, k,
                            key_col, spacing, GROUP, bounds.data_ptr(), stream)
        if err:
            raise RuntimeError(f"merge kernel launch failed: CUDA error {err}")
        LAUNCHES += 1


def merge_runs(word, lengths, cols, fills, capacity):
    """The stable merge of P sorted runs, every column moved with its key.

    word: (>= n,) int32 or int64 -- the rank word of each row; rows
      ``[0, n)`` are P runs back to back, run r of ``lengths[r]`` rows,
      each sorted ascending.
    lengths: P host ints.
    cols: 1-D tensors of at least n rows (any dtype of 1, 2, 4 or 8 bytes
      on CUDA; ``word`` itself may be one of them).
    fills: one value a column for its rows past n.
    capacity: rows of each output (>= n).
    Returns one ``capacity``-row tensor a column: rows ``[0, n)`` in the
    order of a stable sort of the runs' concatenation by ``word`` (ties
    to the lower run, then the lower row), the rest ``fills``. On a CUDA
    tensor a single kernel launch (two kernels) plus the tail fills.
    """
    dev = word.device
    if dev.type == "cpu":
        return merge_runs_plain(word, lengths, cols, fills, capacity)
    if dev.type != "cuda":
        raise ValueError(f"merge_runs runs on CPU or CUDA tensors, got {dev}")
    if len(fills) != len(cols):
        raise ValueError(f"{len(fills)} fills for {len(cols)} columns")
    n = sum(int(x) for x in lengths)
    if capacity < n:
        raise ValueError(f"capacity ({capacity}) must hold the {n} rows")
    outs = [torch.empty((capacity,), dtype=c.dtype, device=dev) for c in cols]
    launch(word, lengths, cols, outs)
    for o, f in zip(outs, fills):
        o[n:].fill_(f)
    return outs
