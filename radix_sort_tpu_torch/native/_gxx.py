"""Build-at-first-use of the host C++ libraries (``g++``, plain C ABI, ctypes).

Each library is compiled from its source in this directory into the
git-ignored ``radix_sort_tpu_torch/_build/``, named by a tag of the host CPU
and a hash of its source and flags: ``-march=native`` code built on one CPU
is never loaded on another (it could die there with SIGILL), and an edited
source rebuilds. The compiler writes to a temporary name that is moved into
place with ``os.replace``, so a process loading at the same time never maps
a half-written file. When the build fails (no compiler), an older build of
the same library on the same host is loaded: a stale but working library
beats none. When there is none, :meth:`HostLibrary.load` returns None and
the callers take their numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

__all__ = ["HostLibrary", "cpu_tag", "BUILD_DIR"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")


def cpu_tag() -> str:
    """A short tag of this host's CPU: its architecture and feature flags."""
    flags = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith(("flags", "Features"))), flags)
    except OSError:
        pass
    return hashlib.sha256(f"{platform.machine()} {flags}".encode()).hexdigest()[:12]


class HostLibrary:
    """One C++ source of this directory, built with ``cxx`` at first use and
    loaded with ctypes; ``bind(lib)`` declares its functions' types."""

    def __init__(self, stem: str, source: str, bind, *, build_dir=BUILD_DIR, cxx="g++"):
        self.stem = stem
        self.source = _HERE / source
        self.bind = bind
        self.build_dir = Path(build_dir)
        self.cxx = cxx
        self._lock = threading.Lock()
        self._lib = None
        self._failed = False

    def path(self) -> Path:
        """The library file of the current source and flags on this host."""
        h = hashlib.sha256(self.source.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
        return self.build_dir / f"lib{self.stem}-{cpu_tag()}-{h}.so"

    def _build(self, so: Path) -> bool:
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run([self.cxx, *FLAGS, str(self.source), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
            return True
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return False

    def _stale(self):
        """The newest earlier build of this library on this host, or None."""
        olds = sorted(self.build_dir.glob(f"lib{self.stem}-{cpu_tag()}-*.so"),
                      key=lambda p: p.stat().st_mtime, reverse=True)
        return olds[0] if olds else None

    def load(self):
        """The loaded library, or None when it neither builds nor loads."""
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            so = self.path()
            if not so.exists() and not self._build(so):
                so = self._stale()
            try:
                if so is None:
                    raise OSError("no build")
                lib = ctypes.CDLL(str(so))
                self.bind(lib)
            except (OSError, AttributeError):
                # no library, an unloadable one, or a stale build that
                # predates newer symbols: the numpy paths, never an
                # escaping AttributeError from the binding
                self._failed = True
                return None
            self._lib = lib
            return lib
