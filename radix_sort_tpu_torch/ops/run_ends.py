"""Each equal-key run's value at its last row: the right rank of
``query.merge_rank_pair``.

A sorted union is cut into runs of equal keys (``run_start``; ``run_id``
numbers them from 0). :func:`run_end_values` gives, for each run, the
value at its last row. ``merge_rank_pair`` passes its non-decreasing data
count, so this is each run's max, which it used to take with an atomic
``scatter_reduce_(..., "amax")``: that sends every row of a run to one
address, and a join's output padded to its capacity is one run of tens of
millions of equal keys. Here each run end is stored once, so the cost
follows the rows, whatever the run lengths.

On a CUDA tensor :func:`run_end_values` launches the hand-written kernel in
``csrc/run_ends.cu`` (built at first use, see ``_build.py``). It replaces no
TPU kernel: the JAX package fills the rank backwards with a reversed
running min, an XLA scan. On a CPU tensor it runs
:func:`run_end_values_plain`, the plain PyTorch version of the same
function, which the tests and ``chip_smoke.py`` hold the kernel against.
Any other device raises.

The kernel is bound by bytes moved: ``run_start`` read once (1 byte a
row), ``run_id`` and ``values`` at the run ends only, one int32 written a
run. The source note in ``csrc/run_ends.cu`` says how its design keeps to
that.
"""

from __future__ import annotations

import ctypes

import torch

from radix_sort_tpu_torch import _build

__all__ = ["launch", "run_end_values", "run_end_values_plain", "LAUNCHES"]

# Calls of :func:`launch` that reached the CUDA kernel (one per call).
LAUNCHES = 0


def _check(run_start, run_id, values):
    if run_start.dtype != torch.bool or run_start.dim() != 1:
        raise ValueError(f"run_start must be a 1-D bool tensor, got {run_start.dtype} "
                         f"{tuple(run_start.shape)}")
    n, dev = run_start.shape[0], run_start.device
    for name, a, dtype in (("run_id", run_id, torch.int64), ("values", values, torch.int32)):
        if a.dtype != dtype or tuple(a.shape) != (n,) or a.device != dev:
            raise ValueError(f"{name} must be {dtype} of shape ({n},) on {dev}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    return n


def run_end_values_plain(run_start, run_id, values):
    """Plain PyTorch version of :func:`run_end_values` (same contract): the
    run ends by a mask, then one indexed store."""
    n = _check(run_start, run_id, values)
    out = torch.empty((n,), dtype=torch.int32, device=run_start.device)
    if n:
        end = torch.cat([run_start[1:], run_start.new_ones((1,))])
        out[run_id[end]] = values[end]
    return out


_FN = None


def _kernel():
    """The C entry point of csrc/run_ends.cu, built and bound at first use."""
    global _FN
    if _FN is None:
        fn = _build.load("run_ends").rst_run_end_values
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def launch(run_start, run_id, values, out):
    """Run the CUDA kernel into a caller-given ``out``: one contiguous int32
    tensor of ``n`` entries, of which only the runs' entries are written.
    The inputs must be contiguous, ``run_start`` 16-byte aligned."""
    global LAUNCHES
    n = _check(run_start, run_id, values)
    dev = run_start.device
    if dev.type != "cuda":
        raise ValueError(f"the run-ends kernel runs on CUDA tensors, got {dev}")
    if out.dtype != torch.int32 or tuple(out.shape) != (n,) or out.device != dev:
        raise ValueError(f"out must be int32 of shape ({n},) on {dev}")
    if not all(a.is_contiguous() for a in (run_start, run_id, values, out)):
        raise ValueError("run_start, run_id, values and out must be contiguous")
    if run_start.data_ptr() % 16:
        raise ValueError("run_start must be 16-byte aligned")
    with torch.cuda.device(dev):
        err = _kernel()(run_start.data_ptr(), run_id.data_ptr(), values.data_ptr(),
                        out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"run-ends kernel launch failed: CUDA error {err}")
    LAUNCHES += 1


def run_end_values(run_start, run_id, values):
    """Each run's value at its last row.

    run_start: (n,) bool -- row i starts a run of equal keys (row 0 does).
    run_id: (n,) int64 -- the run of each row, ``cumsum(run_start) - 1``.
    values: (n,) int32.
    Returns ``out``, (n,) int32: ``out[r]`` is ``values`` at run r's last
    row for r < the number of runs; the entries past the runs are not set.
    A single kernel launch on a CUDA tensor.
    """
    dev = run_start.device
    if dev.type == "cpu":
        return run_end_values_plain(run_start, run_id, values)
    if dev.type != "cuda":
        raise ValueError(f"run_end_values runs on CPU or CUDA tensors, got {dev}")
    out = torch.empty_like(values)  # launch checks the inputs
    launch(run_start, run_id, values, out)
    return out
