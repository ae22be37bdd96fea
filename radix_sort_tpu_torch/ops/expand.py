"""Run expansion: the materialization step of the sort-merge join and of
UNNEST.

Counterpart of ``radix_sort_tpu/ops/expand.py``. Output slots are cut into
runs: run r owns the slots ``[ends[r-1], ends[r])`` (``ends`` the inclusive
prefix sum of the runs' emits). :func:`expand_rows` fills a whole output
row in one call: any number of :class:`Column` s, each either broadcast
(run r's slots get ``values[r]``) or copied (slot j of run r gets
``values[lo[r] + j]`` for ``j < m_copy[r]``, else 0), each moved at its own
width and with its own tail bits in the slots at or past the total. A left
join's unmatched rows are fill runs (``m_copy = 0``), and ``repeat`` is all
broadcast columns.

:func:`expand_join_runs` keeps the JAX kernel's contract (descriptor rows
``[key, left value, lo, m_copy, m_emit, ...]``, three int32 outputs with the
all-ones tail) as the case of two broadcast words and one copied word.

On a CUDA tensor :func:`expand_rows` launches the hand-written kernel in
``csrc/expand.cu`` (built at first use, see ``_build.py``); it replaces the
Pallas kernel ``radix_sort_tpu/ops/expand.py:expand_join_runs``. On a CPU
tensor it runs :func:`expand_rows_plain`, the plain PyTorch version of the
same contract, which the tests and ``chip_smoke.py`` hold the kernel
against. Any other device raises.

The kernel is bound by bytes moved: each output slot written once at its
column's width, each per-run value and each copied value read once. The
source note in ``csrc/expand.cu`` says how its design keeps to that.

:func:`expand_offsets` (``radix_sort_tpu/ops/query.py:241`` in the JAX
package) lives here; ``query`` re-exports it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from radix_sort_tpu_torch import _build

__all__ = [
    "Column",
    "expand_join_runs",
    "expand_join_runs_plain",
    "expand_offsets",
    "expand_rows",
    "expand_rows_plain",
    "launch",
    "DESC_COLS",
    "LAUNCHES",
]

DESC_COLS = 8  # key, left value, lo, m_copy, m_emit, 3 pad columns
TAIL = -1  # the reference's all-ones 0xFFFFFFFF tail word, as int32
_SIGNED_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

# Calls of :func:`launch` that reached the CUDA kernel (one per call).
LAUNCHES = 0


class Column(NamedTuple):
    """One output column of :func:`expand_rows`: ``values`` (1-D, any dtype
    of 1, 2, 4 or 8 bytes), whether it is copied (else broadcast), and its
    tail bits as an integer (taken modulo the width: -1 is all ones)."""

    values: torch.Tensor
    copied: bool = False
    tail: int = 0


def expand_offsets(starts: torch.Tensor, capacity: int) -> torch.Tensor:
    """Map output slot t in [0, capacity) to the last row whose (sorted)
    output offset ``starts[row]`` is <= t: scatter each row index at its
    start slot (max resolves duplicate offsets from zero-match rows to the
    later row) and forward-fill with a running max. Offsets outside
    [0, capacity) after the reference's negative-index wrap are dropped;
    slots before the first start get -1. Returns int32."""
    dev = starts.device
    n = starts.shape[0]
    seed = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    if capacity == 0:
        return seed
    s = starts.to(torch.int64)
    s = torch.where(s < 0, s + capacity, s)  # jnp .at[] wraps negative indices once
    keep = (s >= 0) & (s < capacity)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    seed.scatter_reduce_(0, torch.where(keep, s, 0), torch.where(keep, rows, -1), "amax")
    return torch.cummax(seed, 0).values


def _signed_tail(tail, nbytes):
    """``tail`` reduced to the two's-complement value of ``nbytes`` bytes."""
    bits = 8 * nbytes
    t = int(tail) & ((1 << bits) - 1)
    return t - (1 << bits) if t >> (bits - 1) else t


def _check_rows(ends, lo, m_copy, columns, capacity):
    if ends.dtype != torch.int32 or ends.dim() != 1:
        raise ValueError(f"ends must be a 1-D int32 tensor, got {ends.dtype} "
                         f"{tuple(ends.shape)}")
    if not 0 <= capacity < 1 << 31:
        raise ValueError(f"capacity must be in [0, 2**31), got {capacity}")
    n_runs, dev = ends.shape[0], ends.device
    n_src = None
    for c in columns:
        v = c.values
        if v.dim() != 1 or v.element_size() not in _SIGNED_OF_SIZE or v.is_complex():
            raise ValueError(f"columns must be 1-D of 1, 2, 4 or 8 bytes, got {v.dtype} "
                             f"{tuple(v.shape)}")
        if v.device != dev:
            raise ValueError("columns must lie on the device of ends")
        if not c.copied and v.shape[0] != n_runs:
            raise ValueError(f"a broadcast column holds one value per run ({n_runs}), "
                             f"got {v.shape[0]}")
        if c.copied:
            if n_src is not None and v.shape[0] != n_src:
                raise ValueError("copied columns must have one length")
            n_src = v.shape[0]
    if n_src is not None:
        if not 0 < n_src < 1 << 31:
            raise ValueError(f"copied columns must hold 1 to 2**31 - 1 values, got {n_src}")
        for name, a in (("lo", lo), ("m_copy", m_copy)):
            if a is None or a.dtype != torch.int32 or tuple(a.shape) != (n_runs,) \
                    or a.device != dev:
                raise ValueError(f"{name} must be int32 of shape ({n_runs},) on {dev} "
                                 f"when a column is copied")
    return n_src or 0


def expand_rows_plain(ends, lo, m_copy, columns, *, capacity):
    """Plain PyTorch version of :func:`expand_rows` (same contract): each
    slot's run by ``searchsorted`` over ``ends``, then gathers."""
    n_src = _check_rows(ends, lo, m_copy, columns, capacity)
    dev = ends.device
    n = ends.shape[0]
    count = ends[-1].clone() if n else torch.zeros((), dtype=torch.int32, device=dev)
    outs = []
    e = ends.to(torch.int64)
    t = torch.arange(capacity, dtype=torch.int64, device=dev)
    live = t < count.to(torch.int64)
    if n:
        r = torch.searchsorted(e, t, right=True).clamp(max=n - 1)  # first end above t
        j = t - torch.cat([e.new_zeros((1,)), e[:-1]])[r]
    for c in columns:
        sdt = _SIGNED_OF_SIZE[c.values.element_size()]
        tail = _signed_tail(c.tail, c.values.element_size())
        if not n:
            outs.append(torch.full((capacity,), tail, dtype=sdt, device=dev)
                        .view(c.values.dtype))
            continue
        s = c.values.view(sdt)
        if c.copied:
            src = (lo.to(torch.int64)[r] + j).clamp(0, n_src - 1)
            x = torch.where(j < m_copy.to(torch.int64)[r], s[src], 0)
        else:
            x = s[r]
        outs.append(torch.where(live, x, tail).view(c.values.dtype))
    return outs, count


_FN = None


def _kernel():
    """(C entry point, columns per launch) of csrc/expand.cu, built and
    bound at first use."""
    global _FN
    if _FN is None:
        lib = _build.load("expand")
        fn = lib.rst_expand_rows
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, ctypes.POINTER(vp), ctypes.POINTER(vp),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i),
                       ctypes.POINTER(i), i, vp, i, vp]
        fn.restype = ctypes.c_int
        lib.rst_expand_max_cols.argtypes = []
        lib.rst_expand_max_cols.restype = ctypes.c_int
        _FN = (fn, lib.rst_expand_max_cols())
    return _FN


def launch(ends, lo, m_copy, columns, outs, count, *, capacity):
    """Run the CUDA kernel into caller-given outputs: ``outs``, one
    contiguous, 16-byte aligned tensor of ``capacity`` slots per column, of
    the column's width (every slot is written, tail included), and
    ``count``, one contiguous int32."""
    global LAUNCHES
    n_src = _check_rows(ends, lo, m_copy, columns, capacity)
    dev = ends.device
    if dev.type != "cuda":
        raise ValueError(f"the expand kernel runs on CUDA tensors, got {dev}")
    if len(outs) != len(columns):
        raise ValueError("one output per column")
    for o, c in zip(outs, columns):
        if (o.element_size() != c.values.element_size() or o.device != dev
                or o.numel() != capacity or not o.is_contiguous() or o.data_ptr() % 16):
            raise ValueError(f"outputs must be contiguous, 16-byte aligned tensors of "
                             f"{capacity} slots of their column's width on {dev}")
    if count.dtype != torch.int32 or count.device != dev or count.numel() != 1:
        raise ValueError(f"count must be one int32 on {dev}")
    fn, max_cols = _kernel()
    ends = ends.contiguous()
    if n_src:
        lo, m_copy = lo.contiguous(), m_copy.contiguous()
    srcs = [c.values.contiguous() for c in columns]
    stream = torch.cuda.current_stream(dev).cuda_stream
    vp = ctypes.c_void_p
    for k0 in range(0, max(len(columns), 1), max_cols):
        group = range(k0, min(k0 + max_cols, len(columns)))
        n = len(group)
        with torch.cuda.device(dev):
            err = fn(ends.data_ptr(), lo.data_ptr() if n_src else None,
                     m_copy.data_ptr() if n_src else None, ends.shape[0], n_src,
                     (vp * n)(*[srcs[k].data_ptr() for k in group]),
                     (vp * n)(*[outs[k].data_ptr() for k in group]),
                     (ctypes.c_longlong * n)(*[_signed_tail(columns[k].tail,
                                                            srcs[k].element_size())
                                               for k in group]),
                     (ctypes.c_int * n)(*[columns[k].values.element_size() for k in group]),
                     (ctypes.c_int * n)(*[int(columns[k].copied) for k in group]),
                     n, count.data_ptr(), capacity, stream)
        if err:
            raise RuntimeError(f"expand kernel launch failed: CUDA error {err}")
    LAUNCHES += 1


def expand_rows(ends, lo, m_copy, columns, *, capacity):
    """Expand runs into a whole output row.

    ends: (n_runs,) int32, non-decreasing: the inclusive prefix sum of the
        runs' emits, clamped at ``capacity`` by the caller; run r owns the
        slots ``[ends[r-1], ends[r])``. A zero-emit run owns no slot.
    lo, m_copy: (n_runs,) int32, each copied column's window per run (None
        when no column is copied).
    columns: :class:`Column` s. A broadcast column holds one value per run;
        copied columns hold one common number (>= 1) of values.
    Returns ``(outs, count)``: one tensor of ``capacity`` slots per column,
    in the column's dtype (slots at or past the total hold its tail bits),
    and the total ``ends[-1]`` (0-dim int32, left on the device).
    """
    dev = ends.device
    if dev.type == "cpu":
        return expand_rows_plain(ends, lo, m_copy, columns, capacity=capacity)
    if dev.type != "cuda":
        raise ValueError(f"expand_rows runs on CPU or CUDA tensors, got {dev}")
    outs = [torch.empty((capacity,), dtype=c.values.dtype, device=dev) for c in columns]
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    launch(ends, lo, m_copy, columns, outs, count, capacity=capacity)
    return outs, count[0]


def _check(rvs, desc, capacity):
    if rvs.dtype != torch.int32 or rvs.dim() != 1 or rvs.numel() == 0:
        raise ValueError(f"rvs must be a non-empty 1-D int32 tensor, got "
                         f"{rvs.dtype} {tuple(rvs.shape)}")
    if desc.dtype != torch.int32 or desc.dim() != 2 or desc.shape[1] != DESC_COLS:
        raise ValueError(f"desc must be int32 of shape (n_runs, {DESC_COLS}), got "
                         f"{desc.dtype} {tuple(desc.shape)}")
    if max(rvs.shape[0], desc.shape[0]) >= 1 << 31:
        raise ValueError("rvs and desc take fewer than 2**31 rows")
    if desc.device != rvs.device:
        raise ValueError("rvs and desc must lie on one device")
    if not 0 <= capacity < 1 << 31:
        raise ValueError(f"capacity must be in [0, 2**31), got {capacity}")


def _join_runs(rvs, desc):
    """The reference contract as :func:`expand_rows` arguments: ends from
    the emits, two broadcast words and one copied word, all-ones tails."""
    ends = torch.cumsum(desc[:, 4], 0, dtype=torch.int32)
    cols = [Column(desc[:, 0], tail=TAIL), Column(desc[:, 1], tail=TAIL),
            Column(rvs, copied=True, tail=TAIL)]
    return ends, desc[:, 2], desc[:, 3], cols


def expand_join_runs_plain(rvs, desc, *, capacity):
    """Plain PyTorch version of :func:`expand_join_runs` (same contract)."""
    _check(rvs, desc, capacity)
    ends, lo, m_copy, cols = _join_runs(rvs, desc)
    (k, lv, rv), count = expand_rows_plain(ends, lo, m_copy, cols, capacity=capacity)
    return k, lv, rv, count


def expand_join_runs(rvs, desc, *, capacity):
    """Materialize join output runs (the JAX kernel's contract).

    rvs: (n_r,) int32 -- right values in sorted-key order (raw 32-bit words).
    desc: (n_runs, DESC_COLS) int32 -- per run, in output order:
        ``[key_word, left_value_word, lo, m_copy, m_emit, -, -, -]``.
        ``m_emit`` must be pre-clamped so that ``sum(m_emit) <= capacity``;
        ``0 <= m_copy <= m_emit``; ``m_emit - m_copy`` rows emit rv = 0.
        Column 5, where the reference stores each run's cursor, is ignored:
        the cursors are computed here.
    Returns ``(out_key_words, out_lv, out_rv, count)``: int32 tensors of
    length ``capacity`` (the tail beyond ``count`` is the all-ones word, -1)
    and the total emitted count (0-dim int32, left on the device). One
    :func:`expand_rows` call: a single kernel launch on a CUDA tensor.
    """
    if desc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expand_join_runs runs on CPU or CUDA tensors, got {desc.device}")
    _check(rvs, desc, capacity)
    ends, lo, m_copy, cols = _join_runs(rvs, desc)
    (k, lv, rv), count = expand_rows(ends, lo, m_copy, cols, capacity=capacity)
    return k, lv, rv, count
