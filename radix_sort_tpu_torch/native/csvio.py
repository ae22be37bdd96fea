"""ctypes bindings for the native CSV loader (``csv_loader.cpp``).

Counterpart of ``radix_sort_tpu/native/csvio.py``, over the port's own copy
of the C++ source, compiled on first use with g++ (``_gxx.py``).
``parse_csv`` returns the engine-native column forms: numeric columns as
int64/float64 arrays (with an optional null mask for empty fields), string
columns ALREADY dictionary-encoded -- uint32 codes + the order-preserving
sorted vocabulary (strings.py convention: index 0 is always "") -- so
Table construction does no per-row string work. Callers fall back to the
numpy path (utils/io.read_csv) when no compiler is available. Everything
here is host numpy; ``Table.from_csv`` moves the columns to the device.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from radix_sort_tpu_torch.native._gxx import HostLibrary

__all__ = ["parse_csv", "csv_native_available", "intern_rows", "merge_sorted"]


def _bind(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rst_csv_parse.restype = p
    lib.rst_csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_char]
    lib.rst_csv_last_error.restype = ctypes.c_char_p
    lib.rst_csv_last_error.argtypes = []
    lib.rst_csv_nrows.restype = i64
    lib.rst_csv_nrows.argtypes = [p]
    lib.rst_csv_ncols.restype = i32
    lib.rst_csv_ncols.argtypes = [p]
    lib.rst_csv_col_name.restype = ctypes.c_char_p
    lib.rst_csv_col_name.argtypes = [p, i32]
    lib.rst_csv_col_type.restype = i32
    lib.rst_csv_col_type.argtypes = [p, i32]
    lib.rst_csv_col_has_null.restype = i32
    lib.rst_csv_col_has_null.argtypes = [p, i32]
    for fn, ct in (("rst_csv_col_i64", ctypes.c_longlong),
                   ("rst_csv_col_f64", ctypes.c_double),
                   ("rst_csv_col_codes", ctypes.c_uint),
                   ("rst_csv_col_mask", ctypes.c_ubyte)):
        getattr(lib, fn).argtypes = [p, i32, ctypes.POINTER(ct)]
        getattr(lib, fn).restype = None
    lib.rst_csv_vocab_count.restype = i64
    lib.rst_csv_vocab_count.argtypes = [p, i32]
    lib.rst_csv_vocab_bytes.restype = i64
    lib.rst_csv_vocab_bytes.argtypes = [p, i32]
    lib.rst_csv_vocab.restype = None
    lib.rst_csv_vocab.argtypes = [p, i32, ctypes.c_char_p, ctypes.POINTER(i64)]
    lib.rst_csv_free.argtypes = [p]
    lib.rst_csv_free.restype = None
    lib.rst_intern_rows.restype = p
    lib.rst_intern_rows.argtypes = [ctypes.c_char_p, i64, i64, ctypes.POINTER(ctypes.c_uint)]
    lib.rst_intern_count.restype = i64
    lib.rst_intern_count.argtypes = [p]
    lib.rst_intern_firsts.restype = None
    lib.rst_intern_firsts.argtypes = [p, ctypes.POINTER(i64)]
    lib.rst_intern_free.argtypes = [p]
    lib.rst_intern_free.restype = None
    lib.rst_merge_sorted_u32.restype = i64
    lib.rst_merge_sorted_u32.argtypes = [
        ctypes.c_char_p, i64, i64, ctypes.c_char_p, i64, i64,
        ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_uint),
    ]


LIBRARY = HostLibrary("rst_csv", "csv_loader.cpp", _bind)


def csv_native_available() -> bool:
    """True if the C++ loader compiled (or was cached) successfully."""
    return LIBRARY.load() is not None


def intern_rows(arr: np.ndarray):
    """Native first-seen interning of a numpy unicode array: returns
    ``(codes_first_seen, first_row_indices)`` (uint32 / int64) in ONE
    linear C++ scan over the fixed-width UTF-32 records, or None when
    the native library is unavailable. A sorted vocabulary follows from an
    argsort of ``arr[firsts]``, the DISTINCT values. ``strings.encode`` uses
    np.unique instead: on 6M mostly distinct 10-43 character strings the
    intern took 2.6 times as long (an H100 machine's host CPU,
    chip_smoke.py phase 13d)."""
    lib = LIBRARY.load()
    if lib is None or arr.size == 0 or arr.dtype.kind != "U":
        return None
    arr = np.ascontiguousarray(arr)
    codes = np.empty(arr.shape[0], np.uint32)
    h = lib.rst_intern_rows(
        arr.ctypes.data_as(ctypes.c_char_p),
        arr.shape[0], arr.dtype.itemsize,
        _as_ptr(codes, ctypes.c_uint),
    )
    try:
        nv = int(lib.rst_intern_count(h))
        firsts = np.empty(nv, np.int64)
        lib.rst_intern_firsts(h, _as_ptr(firsts, ctypes.c_longlong))
    finally:
        lib.rst_intern_free(h)
    return codes, firsts


def _as_ptr(arr, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def merge_sorted(vocab_a: np.ndarray, vocab_b: np.ndarray):
    """Native two-pointer merge of two SORTED numpy unicode arrays:
    returns ``(remap_a, remap_b, src, idx, n_union)`` — remaps map old
    codes to union codes, ``(src, idx)`` say union entry k comes from
    array ``src[k]`` (0/1) at position ``idx[k]``. None when the native
    library is unavailable (callers fall back to np.union1d)."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    a = np.ascontiguousarray(vocab_a, dtype=np.str_)
    b = np.ascontiguousarray(vocab_b, dtype=np.str_)
    na, nb = a.shape[0], b.shape[0]
    remap_a = np.empty(na, np.uint32)
    remap_b = np.empty(nb, np.uint32)
    src = np.empty(na + nb, np.uint8)
    idx = np.empty(na + nb, np.uint32)
    n_u = int(lib.rst_merge_sorted_u32(
        a.ctypes.data_as(ctypes.c_char_p), na, a.dtype.itemsize // 4,
        b.ctypes.data_as(ctypes.c_char_p), nb, b.dtype.itemsize // 4,
        _as_ptr(remap_a, ctypes.c_uint), _as_ptr(remap_b, ctypes.c_uint),
        _as_ptr(src, ctypes.c_ubyte), _as_ptr(idx, ctypes.c_uint),
    ))
    return remap_a, remap_b, src[:n_u], idx[:n_u], n_u


def parse_csv(path: str, delimiter: str = ","):
    """Parse a headered CSV natively.

    Returns ``(columns, dictionaries, null_masks)``:
      - numeric columns as int64 / float64 numpy arrays;
      - ISO date / timestamp columns as ``datetime64[D]`` /
        ``datetime64[us]`` arrays (Table construction stores them in the
        engine's Arrow forms — no manual CAST needed; mixed date/garbage
        columns stay strings, per the csv_loader.cpp lattice);
      - string columns as uint32 CODE arrays, with their sorted
        order-preserving vocabulary (index 0 = "") in ``dictionaries``;
      - ``null_masks``: bool arrays for columns with empty fields.
    Raises RuntimeError when the native loader is unavailable or the
    file is malformed (callers fall back to the numpy path).
    """
    lib = LIBRARY.load()
    if lib is None:
        raise RuntimeError("native CSV loader unavailable (no g++)")
    h = lib.rst_csv_parse(
        os.fspath(path).encode(), delimiter.encode()[:1] or b","
    )
    if not h:
        raise RuntimeError(
            f"CSV parse failed: {lib.rst_csv_last_error().decode()}"
        )
    try:
        n = int(lib.rst_csv_nrows(h))
        cols, dicts, masks = {}, {}, {}
        for j in range(int(lib.rst_csv_ncols(h))):
            name = lib.rst_csv_col_name(h, j).decode()
            t = int(lib.rst_csv_col_type(h, j))
            if t == 0:
                a = np.empty(n, np.int64)
                lib.rst_csv_col_i64(h, j, _as_ptr(a, ctypes.c_longlong))
            elif t in (3, 4):
                # date32 (epoch days) / timestamp (epoch microseconds):
                # surface as numpy datetime64 so Table construction takes
                # the dates.py Arrow-storage path with no manual CAST
                a = np.empty(n, np.int64)
                lib.rst_csv_col_i64(h, j, _as_ptr(a, ctypes.c_longlong))
                a = a.astype("datetime64[D]" if t == 3
                             else "datetime64[us]")
            elif t == 1:
                a = np.empty(n, np.float64)
                lib.rst_csv_col_f64(h, j, _as_ptr(a, ctypes.c_double))
            else:
                codes = np.empty(n, np.uint32)
                lib.rst_csv_col_codes(h, j, _as_ptr(codes, ctypes.c_uint))
                nv = int(lib.rst_csv_vocab_count(h, j))
                nb = int(lib.rst_csv_vocab_bytes(h, j))
                blob = ctypes.create_string_buffer(max(nb, 1))
                offs = np.empty(nv + 1, np.int64)
                lib.rst_csv_vocab(h, j, blob, _as_ptr(offs, ctypes.c_longlong))
                raw = blob.raw[:nb]
                first_seen = np.array(
                    [raw[offs[i]:offs[i + 1]].decode("utf-8")
                     for i in range(nv)],
                    dtype=np.str_,
                ) if nv else np.array([], dtype="U1")
                # -> the engine's dictionary convention: sorted vocab with
                # "" at index 0, codes remapped (one small host gather)
                vocab = np.unique(np.concatenate(
                    [np.array([""], first_seen.dtype
                              if nv else "U1"), first_seen]
                ))
                remap = np.searchsorted(vocab, first_seen)
                a = (remap.astype(np.uint32)[codes] if nv
                     else np.zeros(n, np.uint32))
                dicts[name] = vocab
            if lib.rst_csv_col_has_null(h, j):
                m = np.empty(n, np.uint8)
                lib.rst_csv_col_mask(h, j, _as_ptr(m, ctypes.c_ubyte))
                mb = m.astype(bool)
                masks[name] = mb
                if t == 2:
                    a = np.where(mb, np.uint32(0), a)  # NULL -> code ""
            cols[name] = a
        return cols, dicts, masks
    finally:
        lib.rst_csv_free(h)
