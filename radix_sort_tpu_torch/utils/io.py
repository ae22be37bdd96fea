"""Benchmark dataset persistence (raw binary files) and CSV reading.

Counterpart of ``radix_sort_tpu/utils/io.py``. The reference's offline data
path (src/main.rs:83-99 gen_data writes sampled keys as raw bytes;
src/main.rs:47-81 bench_sorts_data reads them back via transmute):
datasets are written once and re-read bit-exactly, so repeated runs sort
identical data. The file format and its sidecar header (magic
``radix_sort_tpu.raw.v1``) are the JAX package's, so a dataset written by
either package reads back bit-identically in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["write_raw", "read_raw", "gen_data", "read_csv", "read_csv_encoded"]

_MAGIC = "radix_sort_tpu.raw.v1"


def write_raw(path: str, arr: np.ndarray) -> None:
    """Write an array as raw little-endian bytes + a sidecar dtype header."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        arr.astype(arr.dtype.newbyteorder("<")).tofile(f)
    with open(path + ".json", "w") as f:
        json.dump({"magic": _MAGIC, "dtype": arr.dtype.str, "shape": list(arr.shape)}, f)


def read_raw(path: str, dtype=None) -> np.ndarray:
    """Read an array written by :func:`write_raw` (the transmute read of
    main.rs:59-62, minus the undefined behavior). ``dtype`` overrides the
    sidecar header for headerless files."""
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{path}.json is not a {_MAGIC} header")
    if dtype is None:
        if meta is None:
            raise ValueError(f"no sidecar header for {path}; pass dtype=")
        dtype = np.dtype(meta["dtype"])
    arr = np.fromfile(path, dtype=dtype)
    if meta is not None:
        arr = arr.reshape(meta["shape"])
    return arr


def gen_data(path: str, n: int, dtype=np.uint32, dist: str = "uniform",
             seed: int = 0, device="cuda", **dist_kwargs) -> np.ndarray:
    """Sample ``n`` keys from a named distribution on ``device`` (a
    ``torch.Generator`` seeded with ``seed``) and persist them (main.rs:83-99
    equivalent). Returns the generated array."""
    from radix_sort_tpu_torch.utils import distributions as D

    gens = {
        "uniform": D.key_uniform,
        "zipf": D.zipf,
        "geometric": D.geometric,
        "step_uniform": D.step_uniform,
    }
    if dist not in gens:
        raise ValueError(f"dist must be one of {sorted(gens)}, got {dist!r}")
    tdt = getattr(torch, np.dtype(dtype).name)
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = gens[dist](gen, n, dtype=tdt, **dist_kwargs)
    arr = keys.view(D._SIGNED_OF[tdt]).cpu().numpy().view(np.dtype(dtype))
    write_raw(path, arr)
    return arr


def read_csv(path: str, *, delimiter: str = ",", dtypes=None):
    """Parse a headered CSV into a dict of 1-D numpy column arrays.

    The native C++ loader (native/csv_loader.cpp: one-pass tokenizer,
    whole-column type inference, RFC4180 quoting) parses when available;
    columns with empty fields come back as ``np.ma`` masked arrays (SQL
    NULLs -- the Table constructor keeps the masks). Without a compiler
    this falls back to numpy ``genfromtxt(dtype=None)``. ``dtypes``
    (name -> dtype) overrides inference per column. Text columns come
    back as unicode arrays -- ``Table(read_csv(p))`` dictionary-encodes
    them (strings.py; ``Table.from_csv`` skips the round-trip and takes
    the loader's codes directly)."""
    try:
        cols_d, dicts, masks = read_csv_encoded(path, delimiter=delimiter)
    except RuntimeError:
        pass
    else:
        cols = {}
        for name, c in cols_d.items():
            if name in dicts:
                c = dicts[name][c]  # codes -> unicode values
            if dtypes and name in dtypes:
                c = c.astype(dtypes[name])
            if name in masks:
                c = np.ma.masked_array(c, masks[name])
            cols[name] = c
        return cols
    raw = np.genfromtxt(path, delimiter=delimiter, names=True, dtype=None,
                        encoding="utf-8", autostrip=True)
    if raw.dtype.names is None:
        raise ValueError(f"{path} has no header row / parsed as a scalar")
    raw = np.atleast_1d(raw)
    cols = {}
    for name in raw.dtype.names:
        c = raw[name]
        if dtypes and name in dtypes:
            c = c.astype(dtypes[name])
        cols[name] = c
    return cols


def read_csv_encoded(path: str, *, delimiter: str = ","):
    """Native CSV parse into ENGINE-NATIVE column forms: numeric numpy
    arrays plus string columns as (uint32 codes, sorted vocabulary) --
    no per-row Python string work. Returns ``(columns, dictionaries,
    null_masks)``; raises RuntimeError when the native loader is
    unavailable (callers fall back to :func:`read_csv`'s numpy path)."""
    from radix_sort_tpu_torch.native.csvio import parse_csv

    return parse_csv(path, delimiter)
