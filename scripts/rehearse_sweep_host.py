#!/usr/bin/env python3
"""Rehearse the sweep kernels of csrc/sweep.cu (or, with ``--cx``, of
csrc/sweep_cx.cu) on the CPU, without a card.

Rewrites csrc/sweep.cu for the host stub scripts/cuda_host_stub/cuda_runtime.h
(the dynamic shared memory becomes the stub's buffer, each ``<<<...>>>``
launch a call of ``stub_launch``), builds it with g++ into a shared library
under ``_dev/`` and drives it through ctypes on CPU tensors:

* kernel A's log against the numpy model of tests/torch_window_host.py, bit
  for bit (the stub rounds as numpy does), and H unchanged;
* kernel A-mb with one bulge against kernel A, bit for bit;
* B0 and B on A's log against ``chase_sweep_plain``;

at three shared-memory limits: an H100's (windows in shared memory, batches
of up to 30 steps), 3000 bytes (short batches) and 600 bytes (the windows in
the global scratch).  Needs g++ with C++20; takes about a minute.

``--cx``: the same for csrc/sweep_cx.cu: the complex kernel A's log against
the numpy model of tests/torch_cx_window_host.py, bit for bit, for
alternating, all-direct and all-inverse (but S[0]) signatures, H unchanged,
and B0 and B on A's log against ``qz_apply_log_plain``, at an H100's shared
memory, 3000 bytes (short batches; p=16 takes the global windows) and 200
bytes (the windows in the global scratch for every p).

Run from the repository root:  python3 scripts/rehearse_sweep_host.py [--cx]
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
CSRC = os.path.join(ROOT, "periodicschurdecompositions_jl_torch", "csrc")
OUT = os.path.join(ROOT, "_dev")

from chip_smoke import mk_cx_problem  # noqa: E402
from periodicschurdecompositions_jl_torch.ops import sweep, sweep_cx  # noqa: E402
from torch_cx_window_host import qz_log_full  # noqa: E402
from torch_window_host import sweep_log_full  # noqa: E402


def build_stub(name):
    """csrc/<name>.cu rewritten for the host stub and built with g++."""
    src = open(os.path.join(CSRC, name + ".cu")).read()
    src = src.replace("extern __shared__ double smem[];", "double* smem = stub_dyn_smem;")
    src = src.replace("extern __shared__ double2 smem[];",
                      "double2* smem = (double2*)stub_dyn_smem;")
    src = re.sub(r"([A-Za-z_][A-Za-z_0-9]*(?:<\d+>)?)<<<(.*?)>>>\(", r"stub_launch(\1, \2, ",
                 src, flags=re.S)
    os.makedirs(OUT, exist_ok=True)
    cpp, so = os.path.join(OUT, name + "_stub.cpp"), os.path.join(OUT, f"lib{name}_stub.so")
    open(cpp, "w").write(src)
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", os.path.join(ROOT, "scripts", "cuda_host_stub"), "-I", CSRC, cpp,
                    "-o", so, "-lpthread"], check=True)
    return ctypes.CDLL(so)


def build():
    lib = build_stub("sweep")
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.psd_sweep_generate.argtypes = [vp, vp, vp, i32, i32, i32, i32, f64, f64, f64, vp]
    lib.psd_sweep_generate_scratch.argtypes = [i32, i32]
    lib.psd_sweep_generate_scratch.restype = ctypes.c_longlong
    lib.psd_sweep_generate_mb.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                                          ctypes.POINTER(f64), vp]
    lib.psd_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    return lib


def problem(p, n, seed):
    rng = np.random.default_rng(seed)
    N = n + 1
    H = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
        d = np.diagonal(H[f])[:n]
        np.fill_diagonal(H[f, :n, :n], np.where(d >= 0, 1.0, -1.0) * (1 + rng.random(n)))
    Z = np.zeros((p, N, N))
    for f in range(p):
        Z[f, :n, :n] = np.linalg.qr(rng.standard_normal((n, n)))[0]
    v0 = rng.standard_normal(3)
    return H, Z, v0 / np.abs(v0).sum()


def check(lib, p, n, m, i):
    H, Z, v0 = problem(p, n, p * 31 + n)
    if m > 0:
        H[0, m, m - 1] = 0.0
    H[0, i + 1, i] = 0.0
    N = n + 1
    Ht = torch.tensor(H)
    work = torch.full((lib.psd_sweep_generate_scratch(p, N),), float("nan"), dtype=torch.float64)
    R = torch.full((p, N, 9), float("nan"), dtype=torch.float64)
    assert lib.psd_sweep_generate(Ht.data_ptr(), work.data_ptr(), R.data_ptr(), p, N, m, i,
                                  *map(float, v0), None) == 0
    assert torch.equal(Ht, torch.tensor(H)), "kernel A wrote H"
    Rf, _ = sweep_log_full(H, m, i, list(v0))
    assert np.array_equal(R.numpy()[:, m:i], Rf[:, m:i]), "kernel A's log != the model's"
    C = torch.empty((p, N, N), dtype=torch.float64)
    Rm = torch.empty((1, p, N, 9), dtype=torch.float64)
    sh = (ctypes.c_double * 6)(*map(float, v0), 0.0, 0.0, 0.0)
    assert lib.psd_sweep_generate_mb(Ht.data_ptr(), C.data_ptr(), Rm.data_ptr(), p, N, m, i, 1,
                                     3, 1, sh, None) == 0
    assert torch.equal(Rm[0, :, m:i], R[:, m:i]), "A-mb with one bulge != A"
    Hb, Zb = torch.tensor(H), torch.tensor(Z)
    assert lib.psd_sweep_left(Hb.data_ptr(), R.data_ptr(), p, N, m, i, 1, None) == 0
    assert lib.psd_sweep_right(Hb.data_ptr(), Zb.data_ptr(), R.data_ptr(), p, N, m, i, 1,
                               None) == 0
    Hp, Zp = torch.tensor(H), torch.tensor(Z)
    sweep.chase_sweep_plain(Hp, Zp, m, i, v0, want_z=True)
    return float((Hb - Hp).abs().max()) / np.abs(H).max(), float((Zb - Zp).abs().max())


def build_cx():
    lib = build_stub("sweep_cx")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.psd_qz_sweep_generate.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.psd_qz_sweep_generate_scratch.argtypes = [i32, i32]
    lib.psd_qz_sweep_generate_scratch.restype = ctypes.c_longlong
    lib.psd_qz_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.psd_qz_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    return lib


def check_cx(lib, p, n, m, i, S):
    H, Z, cs = mk_cx_problem(p, n, np.random.default_rng(p * 31 + n))
    if m > 0:
        H[0, m, m - 1] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    Ht, cst = torch.tensor(H), torch.tensor(cs)
    Sd = torch.tensor([int(x) for x in S], dtype=torch.int32)
    work = torch.full((lib.psd_qz_sweep_generate_scratch(p, n),), complex(np.nan, np.nan),
                      dtype=torch.complex128)
    log = torch.full((p, n, sweep_cx.LOG), complex(np.nan, np.nan), dtype=torch.complex128)
    assert lib.psd_qz_sweep_generate(Ht.data_ptr(), work.data_ptr(), log.data_ptr(),
                                     cst.data_ptr(), Sd.data_ptr(), p, n, m, i, None) == 0
    assert torch.equal(Ht, torch.tensor(H)), "kernel A wrote H"
    Lf, _ = qz_log_full(H, m, i, cs, S)
    lk = log.numpy()
    assert np.array_equal(lk[:, m:i, :12], Lf[:, m:i, :12]) and \
        np.array_equal(lk[0, m:i, 12], Lf[0, m:i, 12]), "kernel A's log != the model's"
    Hb, Zb = torch.tensor(H), torch.tensor(Z)
    assert lib.psd_qz_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, None) == 0
    assert lib.psd_qz_sweep_right(Hb.data_ptr(), Zb.data_ptr(), log.data_ptr(), p, n, m, i,
                                  None) == 0
    Ha, Za = torch.tensor(H), torch.tensor(Z)
    sweep_cx.qz_apply_log_plain(Ha, Za, log, m, i, want_z=True)
    dh = float((Hb - Ha).abs().max()) / np.abs(H).max()
    dz = float((Zb - Za).abs().max())
    assert dh <= 1e-13 and dz <= 1e-13, (dh, dz)
    return dh, dz


def sig(kind, p):
    if kind == "alt":
        return tuple(l % 2 == 0 for l in range(p))
    return tuple(l == 0 or kind == "direct" for l in range(p))


def main_cx():
    lib = build_cx()
    cases = [(1, 12, 0, 11, "direct"), (2, 14, 2, 12, "alt"), (3, 9, 1, 7, "inverse"),
             (3, 40, 0, 39, "alt"), (16, 40, 0, 39, "alt"), (16, 37, 5, 33, "direct"),
             (4, 8, 2, 4, "inverse"), (2, 6, 2, 3, "alt"), (5, 70, 3, 66, "alt"),
             (8, 64, 0, 63, "inverse")]
    for optin in ("232448", "3000", "200"):
        os.environ["STUB_SMEM_OPTIN"] = optin
        for (p, n, m, i, kind) in cases:
            dh, dz = check_cx(lib, p, n, m, i, sig(kind, p))
            print(f"shared memory {optin} B, p={p} n={n} [{m}, {i}] S {kind}: cx A's log == "
                  f"the model's; B0+B vs qz_apply_log_plain dH {dh:.2e} dZ {dz:.2e}",
                  flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cx", action="store_true")
    if ap.parse_args().cx:
        return main_cx()
    lib = build()
    cases = [(1, 12, 0, 11), (2, 14, 2, 12), (3, 9, 1, 7), (3, 40, 0, 39), (16, 40, 0, 39),
             (16, 37, 5, 33), (4, 8, 2, 4), (2, 6, 2, 3), (5, 70, 3, 66)]
    for optin in ("232448", "3000", "600"):
        os.environ["STUB_SMEM_OPTIN"] = optin
        for (p, n, m, i) in cases:
            dh, dz = check(lib, p, n, m, i)
            print(f"shared memory {optin} B, p={p} n={n} [{m}, {i}]: A's log == the model's, "
                  f"A-mb(1 bulge) == A; B0+B vs chase_sweep_plain dH {dh:.2e} dZ {dz:.2e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
