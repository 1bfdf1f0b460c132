"""ctypes loader for the repo's native C++ window Schur (``native/pschur_cpu.cpp``).

The shared library holds the reference's scalar algorithm shape (periodic
Hessenberg reduction + Francis double-shift periodic QR) as sequential
``-O3`` C++.  The aggressive early deflation and host-tail finish of the
three iterations (``ops/aed.py``) solve their (p, w, w) windows with it on
the host: ``pschur_real_cpu`` (real), ``pqz_real_gen_cpu`` (real with a
signature) and ``pqz_complex_cpu`` (complex).

Built on first use with ``g++ -O3 -march=native`` from the source in the
checkout into ``_build/`` next to this package, keyed by a hash of the
source and of the host CPU (model name and flags), so a binary never
outlives its source or its host; threads of one process build it once
(a lock), and each build writes its own temporary file before it is moved
into place, so concurrent processes never load a half-written one.  The checked-in ``native/libpschur_cpu.so``
is never loaded: it may lag the source.  A missing compiler or a failed
build raises, with the compiler's error.  Each entry's argument types are
set on its first call.
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
        _lib = ctypes.CDLL(str(so))
        return _lib


_I = ctypes.c_int
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    "pschur_real_cpu": [_I, _I, _DP, _DP, _DP, _DP, _I, _I],
    "pqz_real_gen_cpu": [_I, _I, _DP, _IP, _DP, _DP, _DP, _DP, _IP, _I, _I],
    "pqz_complex_cpu": [_I, _I, _DP, _IP, _DP, _DP, _DP, _IP, _I, _I],
    "pqz_real_gen_niter_cpu": [_I, _I, _DP, _IP, _DP, _DP, _DP, _DP, _IP, _I, _I, _IP],
}


def _entry(name: str):
    """The library's C entry ``name`` with its argument types."""
    fn = getattr(load(), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_IP)


def _signature(S) -> np.ndarray:
    return np.ascontiguousarray([1 if bool(s) else -1 for s in S], dtype=np.int32)


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
    fn = _entry("pschur_real_cpu")
    T = np.array(A, np.float64, order="C", copy=True)
    if T.ndim != 3 or T.shape[1] != T.shape[2]:
        raise ValueError(f"expected (p, n, n), got {T.shape}")
    p, n, _ = T.shape
    Z = np.zeros_like(T)
    wr = np.zeros(n)
    wi = np.zeros(n)
    rc = fn(p, n, _dp(T), _dp(Z), _dp(wr), _dp(wi), int(maxitfac), int(bool(want_z)))
    if rc != 0:
        raise ConvergenceFailure(rc)
    return T, (Z if want_z else None), wr, wi


def pqz_real_gen_cpu(H, S, maxitfac: int = 120, want_z: bool = True):
    """Real generalized periodic QZ of a Hessenberg-triangular signed cycle
    on the host (native C++; the shift scheme of ``ops/pqz_real.py``).

    Args:
      H: (p, n, n) float64, H[0] upper Hessenberg, H[1:] upper triangular.
      S: the signature (S[0] True).

    Returns:
      (T, Z, alpha_r, alpha_i, beta, scale), with ``Z[l]' H[l] Z[l+1] =
      T[l]`` (S[l]) or ``Z[l+1]' H[l] Z[l] = T[l]``; or None when the
      native core declines: a negligible triangular diagonal (the singular
      factor case, which needs the deflation actions) or no convergence.

    Raises:
      RuntimeError: the library could not be built or loaded.
    """
    fn = _entry("pqz_real_gen_cpu")
    T = np.array(H, np.float64, order="C", copy=True)
    p, n, _ = T.shape
    Z = np.zeros_like(T)
    alr, ali, beta = np.zeros(n), np.zeros(n), np.zeros(n)
    scal = np.zeros(n, np.int32)
    rc = fn(p, n, _dp(T), _ip(_signature(S)), _dp(Z), _dp(alr), _dp(ali), _dp(beta),
            _ip(scal), int(maxitfac), int(bool(want_z)))
    if rc != 0:
        return None
    return T, (Z if want_z else None), alr, ali, beta, scal


def pqz_real_gen_niter_cpu(H, S, maxitfac: int = 120, want_z: bool = True):
    """``pqz_real_gen_cpu`` with its iteration count (the shift-scheme
    probe's oracle, ``benchmarks/probe_rg_hostile.py``).

    Returns (rc, niter, out): rc 0 converged, 1 budget exhausted, 2
    declined (a negligible triangular diagonal); ``out`` is (T, Z, alpha_r,
    alpha_i, beta, scale) when rc == 0, else None.
    """
    fn = _entry("pqz_real_gen_niter_cpu")
    T = np.array(H, np.float64, order="C", copy=True)
    p, n, _ = T.shape
    Z = np.zeros_like(T)
    alr, ali, beta = np.zeros(n), np.zeros(n), np.zeros(n)
    scal = np.zeros(n, np.int32)
    niter = np.zeros(1, np.int32)
    rc = fn(p, n, _dp(T), _ip(_signature(S)), _dp(Z), _dp(alr), _dp(ali), _dp(beta),
            _ip(scal), int(maxitfac), int(bool(want_z)), _ip(niter))
    out = (T, (Z if want_z else None), alr, ali, beta, scal) if rc == 0 else None
    return int(rc), int(niter[0]), out


def pqz_complex_cpu(H, S, maxitfac: int = 30, want_z: bool = True):
    """Complex periodic QZ of a Hessenberg-triangular signed cycle on the
    host (native C++).

    Args:
      H: (p, n, n) complex128, H[0] upper Hessenberg, H[1:] upper triangular.
      S: the signature (S[0] True).

    Returns:
      (T, Z, alpha, beta, scale), or None when the native core declines
      (a negligible triangular diagonal, or no convergence).

    Raises:
      RuntimeError: the library could not be built or loaded.
    """
    fn = _entry("pqz_complex_cpu")
    T = np.array(H, np.complex128, order="C", copy=True)
    p, n, _ = T.shape
    Z = np.zeros_like(T)
    alpha = np.zeros(n, np.complex128)
    beta = np.zeros(n)
    scal = np.zeros(n, np.int32)
    rc = fn(p, n, _dp(T), _ip(_signature(S)), _dp(Z), _dp(alpha), _dp(beta), _ip(scal),
            int(maxitfac), int(bool(want_z)))
    if rc != 0:
        return None
    return T, (Z if want_z else None), alpha, beta, scal
