"""Build-at-first-use loader for the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface. On first use (or
all together, one ``nvcc`` each, through :func:`build`) it is compiled with the CUDA toolkit's ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``_build/`` (git-ignored), named by a hash of its
source and flags so an edited source rebuilds, and loaded with ``ctypes``.
A failed build raises: no caller falls back to another path. This also
answers, for the port, the question the JAX package's
``expand.mosaic_compile_ok`` probe asked ("does the kernel path build
here?").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "load", "BUILD_DIR", "LOG", "BUILD_SECONDS"]

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
LOG: dict[str, str] = {}  # name -> compiler output of this process's build
BUILD_SECONDS: dict[str, float] = {}  # name -> nvcc wall time in this process


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use with the "
        "CUDA toolkit's nvcc (put it on PATH or set CUDA_HOME)"
    )


def _target(name: str):
    """(source, shared library) of ``csrc/<name>.cu`` under its current
    source and flags."""
    src = SRC_DIR / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{tag}.so"


def build(names) -> None:
    """Compile every named source that has no current build: one ``nvcc``
    per source, all started together. Raises if any build fails."""
    jobs = []
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, src, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, so, tmp, proc, t0 in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src}:\n{out}{err}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        BUILD_SECONDS[name] = time.perf_counter() - t0
        LOG[name] = out + err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, building it first
    if no build of the current source exists."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib
