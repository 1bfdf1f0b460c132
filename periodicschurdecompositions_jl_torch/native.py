"""ctypes loader for the repo's native C++ window Schur (``native/pschur_cpu.cpp``).

The shared library holds the reference's scalar algorithm shape (periodic
Hessenberg reduction + Francis double-shift periodic QR) as sequential
``-O3`` C++.  The real iteration's aggressive early deflation and host-tail
finish (``ops/aed.py``) solve their (p, w, w) windows with it on the host.

Built on first use with ``g++ -O3 -march=native`` from the source in the
checkout into ``_build/`` next to this package, keyed by a hash of the
source and of the host CPU (model name and flags), so a binary never
outlives its source or its host; threads of one process build it once
(a lock), and each build writes its own temporary file before it is moved
into place, so concurrent processes never load a half-written one.  The checked-in ``native/libpschur_cpu.so``
is never loaded: it may lag the source.  A missing compiler or a failed
build raises, with the compiler's error.

Ported so far: ``pschur_real_cpu``; ``pqz_complex_cpu`` and
``pqz_real_gen_cpu`` wait for the complex and real generalized AED routes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .types import ConvergenceFailure

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "pschur_cpu.cpp"
_BUILD = _PKG / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


def _host_key(src: bytes) -> str:
    """Hash of the source, the flags and the host CPU (-march=native)."""
    h = hashlib.sha256(src)
    h.update(" ".join(GXX_FLAGS).encode())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    h.update(line.encode())
                    if line.startswith("flags"):
                        break
    except OSError:
        import platform
        h.update(platform.processor().encode())
    return h.hexdigest()[:16]


def _build(so: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            f"g++ not found: the native window Schur is built from {SOURCE} "
            "with g++ on first use")
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD, prefix=so.name + ".", suffix=".tmp")
    os.close(fd)
    try:
        res = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ build of {SOURCE} failed:\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """Build (once per source and host) and load the native library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not SOURCE.is_file():
            raise RuntimeError(f"native source {SOURCE} not found")
        so = _BUILD / f"libpschur_cpu_{_host_key(SOURCE.read_bytes())}.so"
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.pschur_real_cpu.restype = ctypes.c_int
        lib.pschur_real_cpu.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp,
                                        ctypes.c_int, ctypes.c_int]
        _lib = lib
        return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def pschur_real_cpu(A, maxitfac: int = 30, want_z: bool = True
                    ) -> Tuple[np.ndarray, Optional[np.ndarray],
                               np.ndarray, np.ndarray]:
    """Real periodic Schur decomposition on the host (native C++).

    Args:
      A: (p, n, n) real cycle (right orientation: product A[0]...A[p-1]).

    Returns:
      (T, Z, wr, wi): quasi-triangular stack, orthogonal factors with
      ``Z[l].T @ A[l] @ Z[(l+1)%p] = T[l]``, eigenvalue parts.

    Raises:
      ConvergenceFailure: the iteration ran out of its budget.
      RuntimeError: the library could not be built or loaded.
    """
    lib = load()
    T = np.array(A, np.float64, order="C", copy=True)
    if T.ndim != 3 or T.shape[1] != T.shape[2]:
        raise ValueError(f"expected (p, n, n), got {T.shape}")
    p, n, _ = T.shape
    Z = np.zeros_like(T)
    wr = np.zeros(n)
    wi = np.zeros(n)
    rc = lib.pschur_real_cpu(p, n, _dp(T), _dp(Z), _dp(wr), _dp(wi),
                             int(maxitfac), int(bool(want_z)))
    if rc != 0:
        raise ConvergenceFailure(rc)
    return T, (Z if want_z else None), wr, wi
