"""Join-run expansion: the materialization step of the sort-merge join and
of UNNEST.

Counterpart of ``radix_sort_tpu/ops/expand.py``. For each descriptor row r,
in order, :func:`expand_join_runs` writes ``m_emit[r]`` output rows at the
run's cursor (the exclusive prefix sum of the emits): the key word and the
left-value word broadcast, and the right value ``rvs[lo[r] + j]`` for
``j < m_copy[r]``, else 0. A left join's unmatched rows are fill runs
(``m_copy = 0``), and ``repeat`` is all fill runs.

On a CUDA tensor :func:`expand_join_runs` launches the hand-written kernel
in ``csrc/expand.cu`` (built at first use, see ``_build.py``); it replaces
the Pallas kernel ``radix_sort_tpu/ops/expand.py:expand_join_runs``. On a
CPU tensor it runs :func:`expand_join_runs_plain`, the plain PyTorch
version of the same contract, which the tests and ``chip_smoke.py`` hold
the kernel against. Any other device raises.

The kernel is bound by bytes moved: 12 bytes written per output slot, 4
read per copied right value, one descriptor row read per run. The source
note in ``csrc/expand.cu`` says how its design keeps to that.

:func:`expand_offsets` (``radix_sort_tpu/ops/query.py:241`` in the JAX
package) lives here, beside the plain version that uses it; ``query``
re-exports it.
"""

from __future__ import annotations

import ctypes

import torch

from radix_sort_tpu_torch import _build

__all__ = [
    "expand_join_runs",
    "expand_join_runs_plain",
    "expand_offsets",
    "launch",
    "DESC_COLS",
    "LAUNCHES",
]

DESC_COLS = 8  # key, left value, lo, m_copy, m_emit, 3 pad columns
TAIL = -1  # the reference's all-ones 0xFFFFFFFF tail word, as int32

# Calls of :func:`expand_join_runs` that reached the CUDA kernel (one per
# call, however many raw kernel launches the call makes).
LAUNCHES = 0


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


def expand_join_runs_plain(rvs, desc, *, capacity):
    """Plain PyTorch version of :func:`expand_join_runs` (same contract):
    the gather formulation of the JAX package's join expansion."""
    _check(rvs, desc, capacity)
    dev = desc.device
    emits = desc[:, 4].to(torch.int64)
    ends = torch.cumsum(emits, 0)
    cum = ends - emits
    total = ends[-1] if desc.shape[0] else torch.zeros((), dtype=torch.int64, device=dev)
    if desc.shape[0] == 0:
        tail = torch.full((capacity,), TAIL, dtype=torch.int32, device=dev)
        return tail, tail.clone(), tail.clone(), total.to(torch.int32)
    t = torch.arange(capacity, dtype=torch.int64, device=dev)
    live = t < total
    r = expand_offsets(cum, capacity).to(torch.int64).clamp(min=0)
    j = t - cum[r]
    src = (desc[:, 2].to(torch.int64)[r] + j).clamp(0, rvs.shape[0] - 1)
    rv = torch.where(j < desc[:, 3][r], rvs[src], 0)
    outs = [torch.where(live, w, TAIL) for w in (desc[:, 0][r], desc[:, 1][r], rv)]
    return outs[0], outs[1], outs[2], total.to(torch.int32)


_FN = None


def _kernel():
    """(C entry point, output slots per tile) of csrc/expand.cu, built and
    bound at first use."""
    global _FN
    if _FN is None:
        lib = _build.load("expand")
        fn = lib.rst_expand_join_runs
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, i, vp, vp, vp, vp, vp, i, vp]
        fn.restype = ctypes.c_int
        lib.rst_expand_tile.argtypes = []
        lib.rst_expand_tile.restype = ctypes.c_int
        _FN = (fn, lib.rst_expand_tile())
    return _FN


def launch(rvs, desc, outs, count, *, capacity):
    """Run the CUDA kernel into caller-given outputs: ``outs``, three
    contiguous int32 tensors of ``capacity`` words (every word is written),
    and ``count``, one contiguous int32."""
    global LAUNCHES
    _check(rvs, desc, capacity)
    dev = desc.device
    if dev.type != "cuda":
        raise ValueError(f"the expand kernel runs on CUDA tensors, got {dev}")
    if len(outs) != 3 or any(o.dtype != torch.int32 or o.device != dev or o.numel() != capacity
                             or not o.is_contiguous() for o in outs):
        raise ValueError(f"outputs must be three contiguous int32 tensors of {capacity} "
                         f"words on {dev}")
    if count.dtype != torch.int32 or count.device != dev or count.numel() != 1:
        raise ValueError(f"count must be one int32 on {dev}")
    fn, tile = _kernel()
    rvs = rvs.contiguous()
    desc = desc.contiguous()
    if desc.data_ptr() % 16:
        desc = desc.clone()  # the kernel reads descriptor rows as 16-byte vectors
    # inclusive prefix sum of the emits; int32 is exact while the contract
    # (total <= capacity < 2**31) holds
    ends = torch.cumsum(desc[:, 4], 0, dtype=torch.int32)
    first = torch.empty((-(-capacity // tile) + 1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(rvs.data_ptr(), rvs.shape[0], desc.data_ptr(), ends.data_ptr(),
                 desc.shape[0], first.data_ptr(), count.data_ptr(),
                 *[o.data_ptr() for o in outs], capacity, stream)
    if err:
        raise RuntimeError(f"expand kernel launch failed: CUDA error {err}")
    LAUNCHES += 1


def expand_join_runs(rvs, desc, *, capacity):
    """Materialize join output runs.

    rvs: (n_r,) int32 -- right values in sorted-key order (raw 32-bit words).
    desc: (n_runs, DESC_COLS) int32 -- per run, in output order:
        ``[key_word, left_value_word, lo, m_copy, m_emit, -, -, -]``.
        ``m_emit`` must be pre-clamped so that ``sum(m_emit) <= capacity``;
        ``0 <= m_copy <= m_emit``; ``m_emit - m_copy`` rows emit rv = 0.
        Column 5, where the reference stores each run's cursor, is ignored:
        the cursors are computed here.
    Returns ``(out_key_words, out_lv, out_rv, count)``: int32 tensors of
    length ``capacity`` (the tail beyond ``count`` is the all-ones word, -1)
    and the total emitted count (0-dim int32, left on the device).
    """
    dev = desc.device
    if dev.type == "cpu":
        return expand_join_runs_plain(rvs, desc, capacity=capacity)
    if dev.type != "cuda":
        raise ValueError(f"expand_join_runs runs on CPU or CUDA tensors, got {dev}")
    outs = [torch.empty((capacity,), dtype=torch.int32, device=dev) for _ in range(3)]
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    launch(rvs, desc, outs, count, capacity=capacity)
    return outs[0], outs[1], outs[2], count[0]
