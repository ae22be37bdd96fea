"""ctypes bindings for the native host radix sort (``host_radix.cpp``).

Counterpart of ``radix_sort_tpu/native/host.py``, over the port's own copy
of the C++ source. The shared library is compiled on first use with g++
(``_gxx.py``: plain C ABI + ctypes). If no compiler is available the
wrappers fall back to numpy's stable sort, with identical results, so the
host API always works.

Key dtypes are mapped into unsigned rank space with the reference's bit
transforms (its RadixDigits impls, src/radix_sort/radix_digits.rs): the
native kernel only ever sees uint32/uint64 words. These are numpy arrays
on the host; the device path's transforms are ``keys.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from radix_sort_tpu_torch.native._gxx import HostLibrary

__all__ = ["host_sort", "host_sort_pairs", "native_available", "num_threads"]


def _bind(lib):
    i64, i32 = ctypes.c_int64, ctypes.c_int
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rst_sort_u32.argtypes = [u32p, u32p, i64, i32]
    lib.rst_sort_u64.argtypes = [u64p, u64p, i64, i32]
    lib.rst_sort_pairs_u32.argtypes = [u32p, u32p, u32p, u32p, i64, i32]
    lib.rst_sort_pairs_u64.argtypes = [u64p, u64p, u64p, u64p, i64, i32]
    for fn in ("rst_sort_u32", "rst_sort_u64", "rst_sort_pairs_u32", "rst_sort_pairs_u64"):
        getattr(lib, fn).restype = None
    lib.rst_num_threads.argtypes = []
    lib.rst_num_threads.restype = i32


LIBRARY = HostLibrary("rst_host", "host_radix.cpp", _bind)


def native_available() -> bool:
    """True if the C++ kernel compiled (or was cached) successfully."""
    return LIBRARY.load() is not None


def num_threads() -> int:
    """The thread count the C++ sort uses by default (0 without it)."""
    lib = LIBRARY.load()
    return int(lib.rst_num_threads()) if lib is not None else 0


# ---- numpy-side order-preserving bit transforms (host mirror of keys.py)

def _encode_np(x: np.ndarray) -> tuple[np.ndarray, np.dtype]:
    dt = x.dtype
    if dt.kind == "u":
        return x, dt
    if dt.kind == "i":
        u = np.dtype(f"u{dt.itemsize}")
        return (x.view(u) ^ np.asarray(np.iinfo(dt).min, dt).view(u)), dt
    if dt.kind == "f":
        i = np.dtype(f"i{dt.itemsize}")
        u = np.dtype(f"u{dt.itemsize}")
        b = x.view(i)
        mask = (b >> (dt.itemsize * 8 - 1)) | np.iinfo(i).min
        return (b ^ mask).view(u), dt
    raise TypeError(f"unsupported key dtype: {dt}")


def _decode_np(w: np.ndarray, dt: np.dtype) -> np.ndarray:
    if dt.kind == "u":
        return w
    if dt.kind == "i":
        u = w.dtype
        return (w ^ np.asarray(np.iinfo(dt).min, dt).view(u)).view(dt)
    i = np.dtype(f"i{dt.itemsize}")
    e = w.view(i)
    mask = (~e >> (dt.itemsize * 8 - 1)) | np.iinfo(i).min
    return (e ^ mask).view(dt)


def _widen(w: np.ndarray) -> np.ndarray:
    """Sub-32-bit words sort through the u32 kernel (order-preserving)."""
    if w.dtype.itemsize < 4:
        return w.astype(np.uint32)
    return w


def _ptr(a, fn, i):
    return ctypes.cast(np.ctypeslib.as_ctypes(a), fn.argtypes[i])


def host_sort(keys: np.ndarray, threads: int | None = None) -> np.ndarray:
    """Stable total-order host sort (C++ LSD radix; numpy fallback)."""
    w, _ = _encode_np(np.ascontiguousarray(keys))
    orig_w_dtype = w.dtype
    w = _widen(w).copy()
    lib = LIBRARY.load()
    if lib is None:
        w.sort(kind="stable")
    else:
        fn = lib.rst_sort_u32 if w.dtype == np.uint32 else lib.rst_sort_u64
        tmp = np.empty_like(w)
        fn(_ptr(w, fn, 0), _ptr(tmp, fn, 1), w.shape[0], threads or lib.rst_num_threads())
    return _decode_np(w.astype(orig_w_dtype), keys.dtype)


def host_sort_pairs(keys: np.ndarray, values: np.ndarray, threads: int | None = None):
    """Stable host key/payload sort. Payload must be 32- or 64-bit."""
    if values.shape[0] != keys.shape[0]:
        raise ValueError("keys and values must have the same length")
    w, _ = _encode_np(np.ascontiguousarray(keys))
    orig_w_dtype = w.dtype
    w = _widen(w).copy()
    v = np.ascontiguousarray(values)
    vv = v.view(np.dtype(f"u{v.dtype.itemsize}")).copy()
    lib = LIBRARY.load()
    if lib is None or vv.dtype.itemsize != w.dtype.itemsize:
        perm = np.argsort(w, kind="stable")
        w, vv = w[perm], vv[perm]
    else:
        fn = lib.rst_sort_pairs_u32 if w.dtype == np.uint32 else lib.rst_sort_pairs_u64
        tk, tv = np.empty_like(w), np.empty_like(vv)
        fn(_ptr(w, fn, 0), _ptr(vv, fn, 1), _ptr(tk, fn, 2), _ptr(tv, fn, 3),
           w.shape[0], threads or lib.rst_num_threads())
    return _decode_np(w.astype(orig_w_dtype), keys.dtype), vv.view(values.dtype)
