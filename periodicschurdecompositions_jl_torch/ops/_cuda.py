"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources in ``csrc/*.cu`` have a plain C interface.  On first use each
is compiled with ``nvcc`` to an object file, all at once in parallel, and
the objects are linked into one shared library, keyed by a hash of the
sources and the flags, under ``_build/`` next to this package, and loaded
with ctypes.  Pointers and the CUDA stream cross as ``c_void_p``.  There is
no fallback: a missing ``nvcc`` or a failed build raises.

Flags: no ``--use_fast_math`` and no approximate reciprocal or square
root; the reflector generations need correctly rounded division and sqrt.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()  # threads of one process build and load once


CUDA_ROOTS = ("/usr/local/cuda",)  # searched after PATH, CUDA_HOME, CUDA_PATH


def _find_nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 *CUDA_ROOTS):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of periodicschurdecompositions_jl_torch "
        "are built from csrc/*.cu with nvcc on first use (set CUDA_HOME or put "
        "nvcc on PATH); tensors on the CPU use the plain torch versions instead")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    for s in sorted(_CSRC.glob("*.cuh")):
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib):
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.psd_sweep_generate.argtypes = [vp, vp, vp, i32, i32, i32, i32,
                                       f64, f64, f64, vp]
    lib.psd_sweep_generate_scratch.argtypes = [i32, i32]
    lib.psd_sweep_generate_scratch.restype = ctypes.c_longlong
    lib.psd_sweep_generate_mb.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                          i32, ctypes.POINTER(f64), vp]
    lib.psd_sweep_generate_mb_scratch.argtypes = [i32, i32, i32, i32]
    lib.psd_sweep_generate_mb_scratch.restype = ctypes.c_longlong
    lib.psd_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_left_bounded.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_right_bounded.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_left_shard.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32, i32,
                                         i32, vp]
    lib.psd_sweep_right_shard.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                                          i32, vp]
    lib.psd_deflate2x2.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32,
                                   f64, f64, f64, vp]
    lib.psd_deflate2x2_bounded.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32,
                                           f64, f64, f64, i32, i32, vp]
    lib.psd_qz_sweep_generate.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32,
                                          i32, vp]
    lib.psd_qz_sweep_generate_scratch.argtypes = [i32, i32]
    lib.psd_qz_sweep_generate_scratch.restype = ctypes.c_longlong
    lib.psd_qz_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.psd_qz_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.psd_qz_sweep_left_bounded.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
    lib.psd_qz_sweep_right_bounded.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.psd_qz_shift.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.psd_rg_sweep_generate.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.psd_rg_sweep_generate_scratch.argtypes = [i32, i32]
    lib.psd_rg_sweep_generate_scratch.restype = ctypes.c_longlong
    lib.psd_rg_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.psd_rg_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.psd_rg_sweep_left_bounded.argtypes = lib.psd_qz_sweep_left_bounded.argtypes
    lib.psd_rg_sweep_right_bounded.argtypes = lib.psd_qz_sweep_right_bounded.argtypes
    lib.psd_rg_ladder.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                  i32, vp]
    lib.psd_hess_reduce.argtypes = [vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
    lib.psd_hess_reduce_c128.argtypes = lib.psd_hess_reduce.argtypes
    lib.psd_hess_signed.argtypes = [vp, vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
    lib.psd_hess_signed_c128.argtypes = lib.psd_hess_signed.argtypes
    lib.psd_hess_signed_scratch.argtypes = [i32, i32]
    lib.psd_hess_signed_scratch.restype = ctypes.c_longlong
    lib.psd_glue.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                             f64, f64, f64, vp]
    lib.psd_deflate_czshift.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, f64, f64,
                                        ctypes.POINTER(i32), vp]
    lib.psd_deflate_czshift_c128.argtypes = lib.psd_deflate_czshift.argtypes
    lib.psd_deflate_pos.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                    ctypes.POINTER(i32), vp]
    lib.psd_deflate_pos_c128.argtypes = lib.psd_deflate_pos.argtypes
    lib.psd_deflate_neg.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                                    ctypes.POINTER(i32), vp]
    lib.psd_deflate_neg_c128.argtypes = lib.psd_deflate_neg.argtypes
    lib.psd_deflate_scratch.argtypes = [i32, i32]
    lib.psd_deflate_scratch.restype = ctypes.c_longlong
    for fn in (lib.psd_sweep_generate, lib.psd_sweep_generate_mb, lib.psd_sweep_left,
               lib.psd_sweep_right, lib.psd_sweep_left_bounded, lib.psd_sweep_right_bounded,
               lib.psd_sweep_left_shard, lib.psd_sweep_right_shard,
               lib.psd_deflate2x2, lib.psd_deflate2x2_bounded,
               lib.psd_qz_sweep_generate, lib.psd_qz_sweep_left,
               lib.psd_qz_sweep_right, lib.psd_qz_sweep_left_bounded,
               lib.psd_qz_sweep_right_bounded, lib.psd_qz_shift,
               lib.psd_rg_sweep_generate, lib.psd_rg_sweep_left,
               lib.psd_rg_sweep_right, lib.psd_rg_sweep_left_bounded,
               lib.psd_rg_sweep_right_bounded, lib.psd_rg_ladder,
               lib.psd_hess_reduce, lib.psd_hess_reduce_c128, lib.psd_hess_signed,
               lib.psd_hess_signed_c128, lib.psd_glue, lib.psd_deflate_czshift,
               lib.psd_deflate_czshift_c128, lib.psd_deflate_pos, lib.psd_deflate_pos_c128,
               lib.psd_deflate_neg, lib.psd_deflate_neg_c128):
        fn.restype = i32
    lib.psd_error_string.argtypes = [i32]
    lib.psd_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """Build (once per source hash) and load the kernel library.  Threads
    that call it together build and load it once (a lock)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {_CSRC}")
        nvcc = _find_nvcc()
        so = _BUILD / f"libpsd_kernels_{_key(srcs)}.so"
        if not so.exists():
            _build(nvcc, srcs, so)
        _lib = _declare(ctypes.CDLL(str(so)))
        return _lib


def _run_all(cmds):
    """Run the commands concurrently; raise with the output of any failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    if failed:
        raise RuntimeError("nvcc build of the CUDA kernels failed:\n"
                           + "\n".join(failed))


def _build(nvcc, srcs, so):
    """One nvcc per source, all started together, then one link."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{s.stem}.o" for s in srcs]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(o),
                   str(s)] for s, o in zip(srcs, objs)])
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = load().psd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


@contextlib.contextmanager
def on_device(t):
    """Make the card of the CUDA tensor ``t`` the current device around a
    launch: the C entry points size their launches by, and launch on, the
    current device.  Switches only when ``t`` lies on another card, so a
    one-card run pays nothing."""
    import torch
    if t.device.index == torch.cuda.current_device():
        yield
        return
    with torch.cuda.device(t.device):
        yield
