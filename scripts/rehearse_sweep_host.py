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
the global scratch); then B0 and B bit for bit against the numpy model of
tests/torch_apply_host.py (their tiles, chunks and two-step bulge skew) on
kernel A's log and on A-mb's log of four bulges (NB = 1..4), with and
without Z, including ragged tiles, chunks and spans and p = 1 (the stub's
cp.async copies at once).  Built with UBSan's alignment check.  Needs g++
with C++20; takes about a minute.

``--cx``: the same for csrc/sweep_cx.cu: the complex kernel A's log against
the numpy model of tests/torch_cx_window_host.py, bit for bit, for
alternating, all-direct and all-inverse (but S[0]) signatures, H unchanged,
and B0 and B on A's log against ``qz_apply_log_plain``, at an H100's shared
memory, 3000 bytes (short batches; p=16 takes the global windows) and 200
bytes (the windows in the global scratch for every p); then B0 and B bit
for bit against the numpy model of tests/torch_cx_apply_host.py, after B0
and after B, with and without Z, structural zeros exact, at the source's
tile and chunk sizes and at 8-line tiles with chunks of 7 (B0) and 5 (B)
positions two chunks ahead (ragged tiles, chunks and spans); about 2-3
minutes.

``--mb``: kernel A-mb of csrc/sweep.cu (multi-bulge generation on
look-ahead windows) against the numpy model of the order before the window
(tests/torch_mb_window_host.py, ``sweep_log_mb_full``), bit for bit, H
unchanged, only the active bulges' rows m..i-1 written: p = 1 to 16, NB =
2..4 with fewer active bulges, gap 3, 5 and 7, windows with m > 0, ending
before n-1, shorter than (nbact-1) gap or of the closing step alone, at
an H100's shared memory, 3000 bytes (short batches; p=16 takes the global
windows) and 200 bytes (the windows in the global scratch for every p);
about 2 minutes.

``--rg``: the same for csrc/sweep_rg.cu: kernel rg A's generation against
``psd::givens_r`` bit for bit on operands that take every branch (zeros,
subnormals, infinities, NaNs), kernel rg A's log against the
numpy model of tests/torch_rg_window_host.py, bit for bit, for
alternating, all-direct and all-inverse (but S[0]) signatures on the state
the opening ladder leaves, H unchanged, and B0 and B on A's log against
``rg_apply_log_plain``, at an H100's shared memory, 3000 bytes (short
batches; p=16 takes the global windows) and 200 bytes (the windows in the
global scratch for every p); then rg B0 and rg B bit for bit against the
numpy model of tests/torch_rg_apply_host.py on rg A's log, after B0 and
after B, with and without Z, structural zeros and the logged r exact,
the closing bulge kept, at the source's tile and chunk sizes and at
8-line tiles with chunks of 7 (B0) and 5 (B) positions two chunks ahead
(ragged tiles, chunks and spans, odd n, windows of one and two steps);
about two minutes.

``--shards``: the shard entries of csrc/sweep.cu (``psd_sweep_left_shard``
on column shards of H, ``psd_sweep_right_shard`` on row shards of H and Z,
as ``parallel/sweep_sharded.py`` cuts them) against the unsharded B0 and B
on the same input and log, bit for bit, with 1, 2, 4 and 8 shards, NB = 1
and 4, with and without Z, with and without the want_t=False bounds; and
against ``ops.sweep.apply_log_shard_plain`` on the shards (1e-13); about a
minute.

``--hess``: csrc/hess.cu, the reduction in one cooperative launch (the
stub runs every block at once, with a std::barrier for the grid sync), on
float64 and complex128 cycles (p = 1, 2, 3, 5; n = 1, 2, 3, 12, 40, 150,
270, so that the update tiles walk several batches of loads; want_q on and
off; a complex cycle whose columns have zero tails but complex diagonals)
against ``phessenberg_core_plain`` within 1e-13 max|A| (1e-11 at n >= 150,
chip_smoke.py's floor: the two sum in other orders), with exact structural
zeros, at 1 and 4 resident blocks and at 2 with w in the global scratch
(4500 bytes of shared memory; about 4 minutes, 15 with ``--parent``,
whose two-launch design starts its threads anew for every launch).  The float64 instance is
also held bit for bit against the two-launch design of ``--parent FILE``
(its hess.cu, built for the stub the same way), where given.

``--signed``: csrc/hess_signed.cu, stage 2 of the signed reduction in one
launch, float64 and complex128, on stage 1's output of small cycles (p = 1
to 5, n = 3 to 70; alternating, all-direct and mixed signatures; a planted
exact zero on an inverted factor's diagonal; want_q on and off) against
``phessenberg_signed_core_plain`` within max(1e-13, 10 sens) max|A| (sens:
the plain version's own change when A is perturbed by a relative 1e-16;
the chains amplify rounding to ~1e-13 at n=20 and ~2e-12 at n=37 complex),
with exact structural zeros, with the scratch in shared memory and in the
global ws (200 bytes of shared memory), and with a block of 64 threads (each thread several rows
and columns); about a minute.

``--deflate``: csrc/pqz_deflate.cu, the deflation actions (CZSHIFT,
DEFLATE_POS, DEFLATE_NEG chasing down and up), float64 and complex128, on
small periodic Hessenberg-triangular cycles (p = 2 to 5, n = 3 to 100;
mixed signatures; windows at the matrix's edges and inside it; exact zeros
planted on a triangular factor's diagonal, so that CZSHIFT takes its
identity branch; want_z on and off) against the plain versions of
ops/pqz_deflate.py within max(1e-13, 10 sens) max|H| (sens as for
``--signed``), with the plain version's exact zeros (``zeros_kept``) and
the same flag, with the rotations in shared memory and in the global ws
(200 bytes of shared memory), and with a block of 64 threads; odd n
included, built with UBSan's alignment check (a misaligned double2 stops
the run); about a minute.

``--ladders``: csrc/deflate.cu (kernel D) and csrc/rgopen.cu (kernel R)
against the numpy model of tests/torch_ladder_host.py, bit for bit, on H
and Z and on H without Z, on every case of
tests/test_torch_ladder_schedule.py (D: chainA, chainB, a negligible
trailing diagonal, several rounds, the 20-round cap, p = 1 and 2, i = 1
and n-1, p = 16; R: its three modes with alternating, all-direct and
all-inverse signatures, with and without ``rhi``/``clo``, at the first
and last legal j, p = 2, 4 and 8): the source's build with its
cooperative grid capped at 4 blocks; 64-thread blocks; one block (every
line past the first 128 walked grid-stride); up to 32 blocks of 64 threads
(a line a thread); and at 120 bytes of shared memory, where the parent's
design runs; about 20 seconds.

``--bounds``: the want_t=False bounds of B0 and B (csrc/sweep.cu,
sweep_cx.cu, sweep_rg.cu) and of kernel D (csrc/deflate.cu, also at one
block and in the parent's design): each bounded launch on random logs
against the unbounded launch on the same input, bit for bit inside the
window and untouched outside it (``chip_smoke.py::bounded_ok``), with and
without Z, rlo odd and off the tiles' grid; the plain versions with the
same bounds within 1e-13; about a minute.

Run from the repository root:
  python3 scripts/rehearse_sweep_host.py [--mb | --cx | --rg | --hess [--parent FILE]
                                          | --signed | --deflate | --ladders | --bounds]
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
from periodicschurdecompositions_jl_torch.ops import rgopen, sweep, sweep_cx, sweep_rg  # noqa: E402
from torch_cx_window_host import qz_log_full  # noqa: E402
from torch_rg_window_host import rg_log_full  # noqa: E402
from torch_apply_host import apply_model  # noqa: E402
from torch_cx_apply_host import model_left, replay_left  # noqa: E402
from torch_cx_apply_host import apply_model as cx_apply_model  # noqa: E402
import torch_rg_apply_host  # noqa: E402
from torch_mb_host import mb_sig  # noqa: E402
from torch_mb_window_host import sweep_log_mb_full  # noqa: E402
from torch_window_host import sweep_log_full  # noqa: E402


def build_stub(name, path=None, extra="", sub=(), flags=(), tag=None):
    """csrc/<name>.cu (or the file ``path``) rewritten for the host stub,
    with the source ``extra`` appended and each (old, new) of ``sub``
    replaced, and built with g++ (and ``flags``) under the name ``tag``
    (default: name, with "_sub" where ``sub`` is given)."""
    src = open(path or os.path.join(CSRC, name + ".cu")).read() + extra
    for old, new in sub:
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("cudaLaunchCooperativeKernel((void*)kernel,", "stub_launch_coop(kernel,")
    src = re.sub(r'asm volatile\("bar\.sync (\d+), %0;" ::"r"\((.*)\) : "memory"\);',
                 r"stub_bar_sync(\1, \2);", src)
    src = src.replace("extern __shared__ double smem[];", "double* smem = stub_dyn_smem;")
    src = src.replace("extern __shared__ double2 smem[];",
                      "double2* smem = (double2*)stub_dyn_smem;")
    src = re.sub(r"([A-Za-z_][A-Za-z_0-9]*(?:<\w+>)?)<<<(.*?)>>>\(", r"stub_launch(\1, \2, ",
                 src, flags=re.S)
    os.makedirs(OUT, exist_ok=True)
    tag = tag or name + ("_sub" if sub else "")
    cpp, so = os.path.join(OUT, tag + "_stub.cpp"), os.path.join(OUT, f"lib{tag}_stub.so")
    open(cpp, "w").write(src)
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", os.path.join(ROOT, "scripts", "cuda_host_stub"), "-I", CSRC, *flags,
                    cpp, "-o", so, "-lpthread"], check=True)
    return ctypes.CDLL(so)


def build():
    lib = build_stub("sweep", flags=ALIGN)
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.psd_sweep_generate.argtypes = [vp, vp, vp, i32, i32, i32, i32, f64, f64, f64, vp]
    lib.psd_sweep_generate_scratch.argtypes = [i32, i32]
    lib.psd_sweep_generate_scratch.restype = ctypes.c_longlong
    lib.psd_sweep_generate_mb.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
                                          ctypes.POINTER(f64), vp]
    lib.psd_sweep_generate_mb_scratch.argtypes = [i32, i32, i32, i32]
    lib.psd_sweep_generate_mb_scratch.restype = ctypes.c_longlong
    lib.psd_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    return lib


# UBSan's alignment check: a misaligned double2 load stops the run (x86
# would tolerate it, an H100 would not)
ALIGN = ("-fsanitize=alignment", "-fno-sanitize-recover=alignment")


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


def mb_stub(lib, Ht, m, i, v0, sig, nb, gap, nbact):
    """Kernel A-mb through the stub's C entry (NaN-filled scratch and log);
    returns the log (nb, p, N, 9) and checks that H is unchanged."""
    p, N, _ = Ht.shape
    H0 = Ht.clone()
    work = torch.full((lib.psd_sweep_generate_mb_scratch(p, N, nb, gap),), float("nan"),
                      dtype=torch.float64)
    R = torch.full((nb, p, N, 9), float("nan"), dtype=torch.float64)
    vals = list(map(float, v0)) + [float(x) for s3 in sig for x in s3]
    vals += [0.0] * (3 + 3 * nb - len(vals))
    assert lib.psd_sweep_generate_mb(Ht.data_ptr(), work.data_ptr(), R.data_ptr(), p, N, m, i,
                                     nb, gap, nbact, (ctypes.c_double * len(vals))(*vals),
                                     None) == 0
    assert torch.equal(Ht, H0), "kernel A-mb wrote H"
    return R


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
    Rm = mb_stub(lib, Ht, m, i, v0, [(0.0, 0.0, 0.0)], 1, 3, 1)
    assert torch.equal(Rm[0, :, m:i], R[:, m:i]), "A-mb with one bulge != A"
    Hb, Zb = torch.tensor(H), torch.tensor(Z)
    assert lib.psd_sweep_left(Hb.data_ptr(), R.data_ptr(), p, N, m, i, 1, None) == 0
    assert lib.psd_sweep_right(Hb.data_ptr(), Zb.data_ptr(), R.data_ptr(), p, N, m, i, 1,
                               None) == 0
    Hp, Zp = torch.tensor(H), torch.tensor(Z)
    sweep.chase_sweep_plain(Hp, Zp, m, i, v0, want_z=True)
    return float((Hb - Hp).abs().max()) / np.abs(H).max(), float((Zb - Zp).abs().max())


def check_mb(lib, p, n, m, i, nb, nbact, gap):
    """Kernel A-mb through the stub against the numpy model of the order
    before the look-ahead window (tests/torch_mb_window_host.py), bit for
    bit, H unchanged; rows outside m..i-1 and slices nbact.. untouched."""
    H, _, v0 = problem(p, n, p * 31 + n + nb + gap)
    if m > 0:
        H[0, m, m - 1] = 0.0
    H[0, i + 1, i] = 0.0
    sig = mb_sig(np.random.default_rng(p + n + m), nb)
    R = mb_stub(lib, torch.tensor(H), m, i, v0, sig, nb, gap, nbact).numpy()
    Rf, _ = sweep_log_mb_full(H, m, i, v0, sig, nb, gap, nbact)
    assert np.array_equal(R[:nbact, :, m:i], Rf[:nbact, :, m:i]), \
        (p, n, m, i, nb, nbact, gap, "A-mb's log != the model's")
    assert np.isnan(R[:, :, :m]).all() and np.isnan(R[:, :, i:]).all()
    assert np.isnan(R[nbact:]).all()


# (p, n, m, i, nb, nbact, gap): p = 1, where the band update lands on the
# factor the next bulge reads; m > 0; windows shorter than (nbact-1) gap;
# nbact < nb; gap 5 and 7; the closing step alone; odd and even n; inner
# windows (i < n-1) with fewer active bulges than configured
MB_CASES = [(1, 13, 0, 12, 2, 2, 3), (1, 40, 2, 37, 4, 4, 3), (1, 11, 2, 7, 4, 4, 5),
            (2, 15, 0, 14, 3, 3, 3), (2, 41, 3, 40, 3, 3, 5), (2, 16, 1, 15, 4, 2, 5),
            (3, 14, 2, 12, 4, 4, 3), (3, 12, 4, 8, 4, 4, 3), (5, 37, 1, 36, 4, 3, 3),
            (5, 9, 0, 8, 2, 1, 3), (16, 40, 0, 39, 4, 4, 3), (16, 37, 5, 33, 4, 4, 3),
            (3, 9, 5, 6, 3, 3, 3), (4, 70, 3, 66, 4, 4, 3), (2, 45, 0, 44, 4, 4, 7),
            (2, 40, 10, 30, 4, 2, 3), (16, 70, 20, 60, 4, 2, 3), (5, 50, 2, 47, 4, 4, 5),
            (3, 60, 0, 59, 3, 3, 7), (4, 31, 1, 29, 4, 3, 5)]


def main_mb():
    lib = build()
    for optin in ("232448", "3000", "200"):
        os.environ["STUB_SMEM_OPTIN"] = optin
        for case in MB_CASES:
            check_mb(lib, *case)
            print(f"shared memory {optin} B, (p, n, m, i, nb, nbact, gap) = {case}: A-mb's log "
                  f"== the model's", flush=True)
    return 0


def apply_sizes():
    """The apply kernels' tile and chunk sizes, read from csrc/sweep.cu."""
    src = open(os.path.join(CSRC, "sweep.cu")).read()

    def get(key):
        return int(re.search(rf"constexpr int {key} = (\d+);", src).group(1))
    return {"cols": get("kLeftCols"), "rows": get("kRightRows"), "chunk": get("kApplyChunk")}


def check_apply(lib, p, n, m, i, sizes):
    """B0 then B through the stub, bit for bit against the numpy model of
    tests/torch_apply_host.py, with and without Z: on kernel A's log (NB =
    1) and on A-mb's log of four bulges (gap 3), its first NB = 1..4
    bulges.  Returns the number of runs."""
    H, Z, v0 = problem(p, n, p * 31 + n + m)
    if m > 0:
        H[0, m, m - 1] = 0.0
    H[0, i + 1, i] = 0.0
    N = n + 1
    Ht = torch.tensor(H)
    work = torch.full((lib.psd_sweep_generate_scratch(p, N),), float("nan"), dtype=torch.float64)
    R = torch.full((p, N, 9), float("nan"), dtype=torch.float64)
    assert lib.psd_sweep_generate(Ht.data_ptr(), work.data_ptr(), R.data_ptr(), p, N, m, i,
                                  *map(float, v0), None) == 0
    sig = mb_sig(np.random.default_rng(n + m), 4)
    Rm = mb_stub(lib, Ht, m, i, v0, sig, 4, 3, 4)
    assert not torch.isnan(Rm[:, :, m:i]).any(), "A-mb's log has NaNs"
    runs = 0
    for L, nb in [(R, 1)] + [(Rm, nb) for nb in (1, 2, 3, 4)]:
        for want_z in (True, False):
            Hb = torch.tensor(H)
            Zb = torch.tensor(Z) if want_z else None
            assert lib.psd_sweep_left(Hb.data_ptr(), L.data_ptr(), p, N, m, i, nb, None) == 0
            assert lib.psd_sweep_right(Hb.data_ptr(), Zb.data_ptr() if want_z else None,
                                       L.data_ptr(), p, N, m, i, nb, None) == 0
            Hm, Zm = apply_model(H, Z if want_z else None, L.numpy(), m, i, nb, **sizes)
            assert np.array_equal(Hb.numpy(), Hm), (p, n, m, i, nb, want_z, "H")
            assert not want_z or np.array_equal(Zb.numpy(), Zm), (p, n, m, i, nb, "Z")
            runs += 1
    return runs


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


def shift_sig(kind, p):
    """S's signatures: alternating, all direct, all inverse but S[0]."""
    return sig({"alt": "alt", "direct": "direct", "inverse": "inverse"}[kind], p)


def check_shift(libs, parent):
    """Kernel S of each stub library in ``libs`` against the parent's
    (``parent``, bit for bit) and qz_shift_plain (within 1e-14), at p = 1,
    2, 8, 33 and 40 under alternating, all-direct and all-inverse-but-S[0]
    signatures, on a few windows."""
    for p in (1, 2, 8, 33, 40):
        n = 24
        H, _, _ = mk_cx_problem(p, n, np.random.default_rng(500 + p))
        Ht = torch.tensor(H)
        for kind in ("alt", "direct", "inverse"):
            S = sig(kind, p)
            Sd = torch.tensor([int(x) for x in S], dtype=torch.int32)
            worst = 0.0
            for (a, b) in ((0, n - 1), (3, 9), (7, 8), (n - 2, n - 1)):
                ref = sweep_cx.qz_shift_plain(Ht, a, b, S)
                outs = {}
                for tag, lb in list(libs.items()) + ([("parent", parent)] if parent else []):
                    cs = torch.full((2,), complex(np.nan, np.nan), dtype=torch.complex128)
                    assert lb.psd_qz_shift(Ht.data_ptr(), cs.data_ptr(), Sd.data_ptr(), p, n,
                                           a, b, None) == 0
                    outs[tag] = cs
                    worst = max(worst, float((cs - ref).abs().max()))
                base = outs[next(iter(libs))]
                assert all(torch.equal(base, cs) for cs in outs.values()), (p, kind, a, b)
            assert worst <= 1e-14, (p, kind, worst)
            print(f"S p={p} S {kind}: {', '.join(list(libs) + (['parent'] if parent else []))} "
                  f"bit for bit; vs qz_shift_plain {worst:.2e}", flush=True)


def main_cx(parent=None):
    lib = build_cx()
    # kernel S: the source, factor chunks of 8 (p = 33, 40 take several),
    # and the parent's sweep_cx.cu where given
    small = build_stub("sweep_cx", sub=[("constexpr int kShiftChunk = 256;",
                                         "constexpr int kShiftChunk = 8;")], tag="sweep_cx_s8")
    old = build_stub("sweep_cx", path=parent, tag="sweep_cx_parent") if parent else None
    for lb in (small, old):
        if lb is not None:
            lb.psd_qz_shift.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
                [ctypes.c_void_p]
    lib.psd_qz_shift.argtypes = small.psd_qz_shift.argtypes
    check_shift({"source": lib, "chunks of 8": small}, old)
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
    os.environ["STUB_SMEM_OPTIN"] = "232448"
    # the source's sizes, then chunks of 7 (B0) and 5 (B) positions, 8-line
    # tiles, two chunks ahead
    tight = build_stub("sweep_cx", sub=[
        ("constexpr int kLeftChunk = ", "constexpr int kLeftChunk = 7; //"),
        ("constexpr int kRightChunk = ", "constexpr int kRightChunk = 5; //"),
        ("constexpr int kAhead = ", "constexpr int kAhead = 2; //"),
        ("constexpr int kLeftCols = ", "constexpr int kLeftCols = 8; //"),
        ("constexpr int kRightRows = ", "constexpr int kRightRows = 8; //")])
    for fn in ("psd_qz_sweep_generate", "psd_qz_sweep_generate_scratch", "psd_qz_sweep_left",
               "psd_qz_sweep_right"):
        getattr(tight, fn).argtypes = getattr(lib, fn).argtypes
        getattr(tight, fn).restype = getattr(lib, fn).restype
    for lb in (lib, tight):
        sizes = cx_apply_sizes() if lb is lib else {"cols": 8, "rows": 8, "chunk": 5,
                                                    "left_chunk": 7, "ahead": 2}
        for (p, n, m, i, kind) in cases + [(1, 40, 20, 39, "direct"), (3, 33, 1, 32, "alt"),
                                           (2, 45, 0, 44, "alt"), (3, 17, 6, 7, "direct")]:
            runs = check_cx_apply(lb, p, n, m, i, sig(kind, p), sizes)
            print(f"p={p} n={n} [{m}, {i}] S {kind}: cx B0 and B == the numpy model bit for "
                  f"bit in {runs} runs (after B0, after B; with and without Z; {sizes})",
                  flush=True)
    return 0


def cx_apply_sizes():
    """The complex apply kernels' tile, chunk and ring sizes, read from
    csrc/sweep_cx.cu."""
    src = open(os.path.join(CSRC, "sweep_cx.cu")).read()

    def get(key):
        return int(re.search(rf"constexpr int {key} = (\d+);", src).group(1))
    return {"cols": get("kLeftCols"), "rows": get("kRightRows"), "chunk": get("kRightChunk"),
            "left_chunk": get("kLeftChunk"), "ahead": get("kAhead")}


def check_cx_apply(lib, p, n, m, i, S, sizes):
    """cx B0, then B, through the stub on kernel A's log, bit for bit against
    the numpy model of tests/torch_cx_apply_host.py after each kernel, with
    and without Z; structural zeros exact.  Returns the number of runs."""
    H, Z, cs = mk_cx_problem(p, n, np.random.default_rng(p * 17 + n + m))
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
    Hl = model_left(H, log.numpy(), m, i, cols=sizes["cols"], chunk=sizes["left_chunk"],
                    ahead=sizes["ahead"])
    assert np.array_equal(Hl, replay_left(H, log.numpy(), m, i))
    runs = 0
    for want_z in (True, False):
        Hb = torch.tensor(H)
        Zb = torch.tensor(Z) if want_z else None
        assert lib.psd_qz_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, None) == 0
        assert np.array_equal(Hb.numpy(), Hl), (p, n, m, i, "H after B0")
        assert lib.psd_qz_sweep_right(Hb.data_ptr(), Zb.data_ptr() if want_z else None,
                                      log.data_ptr(), p, n, m, i, None) == 0
        Hm, Zm = cx_apply_model(H, Z if want_z else None, log.numpy(), m, i, **sizes)
        assert np.array_equal(Hb.numpy(), Hm), (p, n, m, i, want_z, "H after B")
        assert not want_z or np.array_equal(Zb.numpy(), Zm), (p, n, m, i, "Z after B")
        Hn = Hb.numpy()
        for r in range(m + 1, i + 1):
            assert not Hn[0, r, m:r - 1].any() and not Hn[1:, r, m:r].any(), (p, n, m, i, r)
        assert np.array_equal(Hn[0, :, :m], H[0, :, :m]), "B0/B touched H[0] left of m"
        runs += 1
    return runs


# kernel rg A's generation and psd::givens_r side by side, for the special
# operands below
GIVENS_PAIR = r'''
extern "C" void stub_givens_pair(double f, double g, double* out) {
  givens_gen(f, g, out[0], out[1], out[2]);
  psd::givens_r(f, g, out[3], out[4], out[5]);
}
'''


def check_givens(lib):
    """rg A's generation against psd::givens_r, bit for bit (NaN as NaN), on
    operands that take every branch: zeros, equal magnitudes, subnormals,
    infinities and NaNs of both signs."""
    vals = [0.0, -0.0, 1.5, -1.5, 3.0, -2.0 ** -1060, 2.0 ** -1070, 1e300, -1e-300,
            float("inf"), -float("inf"), float("nan")]
    out = (ctypes.c_double * 6)()
    for f in vals:
        for g in vals:
            lib.stub_givens_pair(f, g, out)
            a, b = np.array(out[:3]), np.array(out[3:])
            assert np.array_equal(a, b, equal_nan=True), (f, g, a, b)
    return len(vals) ** 2


def build_rg():
    lib = build_stub("sweep_rg", extra=GIVENS_PAIR, flags=ALIGN)
    lib.stub_givens_pair.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.psd_rg_sweep_generate.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.psd_rg_sweep_generate_scratch.argtypes = [i32, i32]
    lib.psd_rg_sweep_generate_scratch.restype = ctypes.c_longlong
    lib.psd_rg_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.psd_rg_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    return lib


def check_rg(lib, p, n, m, i, S):
    from chip_smoke import mk_rg_problem
    H, Z, rot = mk_rg_problem(p, n, np.random.default_rng(p * 31 + n))
    if m > 1:
        H[0, m - 1, m - 2] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    rgopen.rg_ladder_plain(Ht, Zt, "open", m - 1, i, torch.tensor(rot), S, want_z=True)
    H, Z = Ht.numpy().copy(), Zt.numpy().copy()
    Sd = torch.tensor([int(x) for x in S], dtype=torch.int32)
    work = torch.full((lib.psd_rg_sweep_generate_scratch(p, n),), float("nan"),
                      dtype=torch.float64)
    log = torch.full((p, n, sweep_rg.LOG), float("nan"), dtype=torch.float64)
    assert lib.psd_rg_sweep_generate(Ht.data_ptr(), work.data_ptr(), log.data_ptr(),
                                     Sd.data_ptr(), p, n, m, i, None) == 0
    assert torch.equal(Ht, torch.tensor(H)), "kernel rg A wrote H"
    Lf, _ = rg_log_full(H, m, i, S)
    lk = log.numpy()
    assert np.array_equal(lk[:, m:i - 1, :27], Lf[:, m:i - 1, :27]) and \
        np.array_equal(lk[0, m:i - 1, 27], Lf[0, m:i - 1, 27]), "rg A's log != the model's"
    Hb, Zb = torch.tensor(H), torch.tensor(Z)
    assert lib.psd_rg_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, None) == 0
    assert lib.psd_rg_sweep_right(Hb.data_ptr(), Zb.data_ptr(), log.data_ptr(), p, n, m, i,
                                  None) == 0
    Ha, Za = torch.tensor(H), torch.tensor(Z)
    sweep_rg.rg_apply_log_plain(Ha, Za, log, m, i, want_z=True)
    dh = float((Hb - Ha).abs().max()) / np.abs(H).max()
    dz = float((Zb - Za).abs().max())
    assert dh <= 1e-13 and dz <= 1e-13, (dh, dz)
    return dh, dz


def main_rg():
    lib = build_rg()
    print(f"rg A's generation == psd::givens_r on {check_givens(lib)} special operand pairs",
          flush=True)
    cases = [(2, 12, 1, 11, "alt"), (2, 14, 2, 12, "direct"), (3, 9, 1, 7, "inverse"),
             (3, 40, 1, 39, "alt"), (16, 40, 1, 39, "alt"), (16, 37, 5, 33, "direct"),
             (4, 8, 2, 5, "inverse"), (2, 6, 2, 4, "alt"), (5, 70, 3, 66, "alt"),
             (8, 64, 1, 63, "inverse"), (3, 50, 4, 47, "direct")]
    for optin in ("232448", "3000", "200"):
        os.environ["STUB_SMEM_OPTIN"] = optin
        for (p, n, m, i, kind) in cases:
            dh, dz = check_rg(lib, p, n, m, i, sig(kind, p))
            print(f"shared memory {optin} B, p={p} n={n} [{m}, {i}] S {kind}: rg A's log == "
                  f"the model's; B0+B vs rg_apply_log_plain dH {dh:.2e} dZ {dz:.2e}",
                  flush=True)
    os.environ["STUB_SMEM_OPTIN"] = "232448"
    # the source's sizes, then chunks of 7 (B0) and 5 (B) positions, 8-line
    # tiles, two chunks ahead
    tight = build_stub("sweep_rg", flags=ALIGN, sub=[
        ("constexpr int kLeftChunk = ", "constexpr int kLeftChunk = 7; //"),
        ("constexpr int kRightChunk = ", "constexpr int kRightChunk = 5; //"),
        ("constexpr int kAhead = ", "constexpr int kAhead = 2; //"),
        ("constexpr int kLeftCols = ", "constexpr int kLeftCols = 8; //"),
        ("constexpr int kRightRows = ", "constexpr int kRightRows = 8; //")])
    for fn in ("psd_rg_sweep_generate", "psd_rg_sweep_generate_scratch", "psd_rg_sweep_left",
               "psd_rg_sweep_right"):
        getattr(tight, fn).argtypes = getattr(lib, fn).argtypes
        getattr(tight, fn).restype = getattr(lib, fn).restype
    for lb in (lib, tight):
        sizes = rg_apply_sizes() if lb is lib else {"cols": 8, "rows": 8, "chunk": 5,
                                                    "left_chunk": 7, "ahead": 2}
        for (p, n, m, i, kind) in cases + [(2, 41, 20, 40, "direct"), (3, 33, 1, 32, "alt"),
                                           (8, 45, 1, 44, "alt"), (3, 17, 6, 8, "direct"),
                                           (2, 29, 9, 12, "alt"), (3, 129, 1, 128, "alt")]:
            runs = check_rg_apply(lb, p, n, m, i, sig(kind, p), sizes)
            print(f"p={p} n={n} [{m}, {i}] S {kind}: rg B0 and B == the numpy model bit for "
                  f"bit in {runs} runs (after B0, after B; with and without Z; {sizes})",
                  flush=True)
    return 0


def rg_apply_sizes():
    """The rg apply kernels' tile, chunk and ring sizes, read from
    csrc/sweep_rg.cu."""
    src = open(os.path.join(CSRC, "sweep_rg.cu")).read()

    def get(key):
        return int(re.search(rf"constexpr int {key} = (\d+);", src).group(1))
    return {"cols": get("kLeftCols"), "rows": get("kRightRows"), "chunk": get("kRightChunk"),
            "left_chunk": get("kLeftChunk"), "ahead": get("kAhead")}


def check_rg_apply(lib, p, n, m, i, S, sizes):
    """rg B0, then B, through the stub on rg A's log, bit for bit against
    the numpy model of tests/torch_rg_apply_host.py after each kernel, with
    and without Z; structural zeros and the logged r exact, the closing
    bulge kept.  Returns the number of runs."""
    from chip_smoke import mk_rg_problem
    H, Z, rot = mk_rg_problem(p, n, np.random.default_rng(p * 17 + n + m))
    if m > 1:
        H[0, m - 1, m - 2] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    rgopen.rg_ladder_plain(Ht, Zt, "open", m - 1, i, torch.tensor(rot), S, want_z=True)
    H, Z = Ht.numpy().copy(), Zt.numpy().copy()
    Sd = torch.tensor([int(x) for x in S], dtype=torch.int32)
    work = torch.full((lib.psd_rg_sweep_generate_scratch(p, n),), float("nan"),
                      dtype=torch.float64)
    log = torch.full((p, n, sweep_rg.LOG), float("nan"), dtype=torch.float64)
    assert lib.psd_rg_sweep_generate(Ht.data_ptr(), work.data_ptr(), log.data_ptr(),
                                     Sd.data_ptr(), p, n, m, i, None) == 0
    lg = log.numpy()
    Hl = torch_rg_apply_host.model_left(H, lg, m, i, cols=sizes["cols"],
                                        chunk=sizes["left_chunk"], ahead=sizes["ahead"])
    assert np.array_equal(Hl, torch_rg_apply_host.replay_left(H, lg, m, i))
    runs = 0
    for want_z in (True, False):
        Hb = torch.tensor(H)
        Zb = torch.tensor(Z) if want_z else None
        assert lib.psd_rg_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, None) == 0
        assert np.array_equal(Hb.numpy(), Hl), (p, n, m, i, "H after B0")
        assert lib.psd_rg_sweep_right(Hb.data_ptr(), Zb.data_ptr() if want_z else None,
                                      log.data_ptr(), p, n, m, i, None) == 0
        Hm, Zm = torch_rg_apply_host.apply_model(H, Z if want_z else None, lg, m, i, **sizes)
        assert np.array_equal(Hb.numpy(), Hm), (p, n, m, i, want_z, "H after B")
        assert not want_z or np.array_equal(Zb.numpy(), Zm), (p, n, m, i, "Z after B")
        Hn = Hb.numpy()
        assert Hn[0, i, i - 2] != 0.0, "the closing bulge was lost"
        for r in range(m, i + 1):
            assert not Hn[0, r, m - 1:(r - 1 if r < i else i - 2)].any(), (p, n, m, i, r)
            assert not Hn[1:, r, m - 1:r].any(), (p, n, m, i, r)
            if r <= i - 2:
                assert Hn[0, r, r - 1] == lg[0, r, 27], (p, n, m, i, r)
        assert np.array_equal(Hn[:, :, :m - 1], H[:, :, :m - 1]), "B0/B touched H left of m-1"
        runs += 1
    return runs


def build_hess(name, path=None):
    lib = build_stub(name, path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.psd_hess_reduce.argtypes = [vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
    if hasattr(lib, "psd_hess_reduce_c128"):
        lib.psd_hess_reduce_c128.argtypes = [vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
    return lib


def hess_stub(lib, A, want_q):
    """One reduction through the stub's C entry; returns (H, Q, launches)."""
    p, n, _ = A.shape
    H = A.clone()
    Q = torch.eye(n, dtype=A.dtype).expand(p, n, n).clone() if want_q else None
    ws = torch.full((n + 2,), float("nan"), dtype=A.dtype)
    nl = ctypes.c_int(-1)
    entry = lib.psd_hess_reduce_c128 if A.is_complex() else lib.psd_hess_reduce
    rc = entry(H.data_ptr(), Q.data_ptr() if want_q else None, ws.data_ptr(), p, n,
               ctypes.byref(nl), None)
    assert rc == 0, rc
    return H, Q, nl.value


def hess_cycle(p, n, kind, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, n, n))
    if kind == "real":
        return torch.tensor(A)
    A = A + 1j * rng.standard_normal((p, n, n))
    if kind == "zero-tails":  # triangular, complex diagonals: every tau != 0
        A = np.triu(A)
        A[0] = np.triu(A[0], -1)
    return torch.tensor(A)


def main_hess(parent):
    from periodicschurdecompositions_jl_torch.ops import hessenberg
    lib = build_hess("hess")
    old = build_hess("hess_parent", parent) if parent else None
    cases = [(1, 12, "real", True), (3, 12, "real", True), (2, 40, "real", False),
             (5, 12, "real", True), (1, 2, "real", True), (3, 3, "real", True),
             (1, 12, "complex", True), (3, 12, "complex", True), (2, 40, "complex", True),
             (3, 1, "complex", True), (1, 2, "complex", True), (2, 3, "complex", False),
             (3, 12, "zero-tails", True), (1, 12, "zero-tails", True),
             (2, 150, "real", True), (1, 270, "complex", True)]
    for (sms, per_sm, optin) in ((1, 1, 232448), (2, 2, 232448), (2, 1, 4500)):
        os.environ.update(STUB_SMS=str(sms), STUB_BLOCKS_PER_SM=str(per_sm),
                          STUB_SMEM_OPTIN=str(optin))
        for (p, n, kind, want_q) in cases:
            A = hess_cycle(p, n, kind, 100 * p + n)
            H, Q, nl = hess_stub(lib, A, want_q)
            Hp, Qp = hessenberg.phessenberg_core_plain(A, want_q)
            scale = float(A.abs().max())
            dh = float((H - Hp).abs().max()) / scale
            dq = float((Q - Qp).abs().max()) if want_q else 0.0
            assert nl == (1 if n > 1 else 0), nl
            tol = 1e-13 if n <= 40 else 1e-11  # hess_phase's floor at the long windows
            assert dh <= tol and dq <= tol, (p, n, kind, dh, dq)
            Hn = H.numpy()
            assert np.all(np.tril(Hn[0], -2) == 0) and all(
                np.all(np.tril(Hn[f], -1) == 0) for f in range(1, p)), "structural zeros"
            msg = ""
            if old is not None and kind == "real":
                Ho, Qo, _ = hess_stub(old, A, want_q)
                assert torch.equal(H, Ho) and (not want_q or torch.equal(Q, Qo)), \
                    "the real instance != the two-launch design"
                msg = "; bit for bit the two-launch design's"
            print(f"{sms * per_sm} blocks, shared memory {optin} B: p={p} n={n} {kind} "
                  f"want_q={want_q}: vs phessenberg_core_plain dH {dh:.2e} dQ {dq:.2e}{msg}",
                  flush=True)
    return 0


def signed_stub(lib, A, S, want_q):
    """Stage 1 in torch, stage 2 through the stub's C entry; returns (H, Q,
    launches)."""
    from periodicschurdecompositions_jl_torch.ops import hessenberg
    p, n, _ = A.shape
    H, Q = hessenberg._signed_stage1(A, S, want_q)
    cx = A.is_complex()
    ws = torch.full((lib.psd_hess_signed_scratch(n, int(cx)) // 8,), float("nan"),
                    dtype=torch.float64)
    sig = torch.tensor([int(x) for x in S], dtype=torch.int32)
    QT = Q.transpose(1, 2).contiguous() if want_q else None
    nl = ctypes.c_int(-1)
    entry = lib.psd_hess_signed_c128 if cx else lib.psd_hess_signed
    rc = entry(H.data_ptr(), QT.data_ptr() if want_q else None, sig.data_ptr(),
               ws.data_ptr(), p, n, ctypes.byref(nl), None)
    assert rc == 0, rc
    return hessenberg._scrub(H), QT.transpose(1, 2) if want_q else None, nl.value


def build_signed(sub=()):
    lib = build_stub("hess_signed", sub=sub)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("psd_hess_signed", "psd_hess_signed_c128"):
        getattr(lib, name).argtypes = [vp, vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
    lib.psd_hess_signed_scratch.argtypes = [i32, i32]
    lib.psd_hess_signed_scratch.restype = ctypes.c_longlong
    return lib


def main_signed():
    from periodicschurdecompositions_jl_torch.ops import hessenberg
    # the source's block, and one of 64 threads: rows and columns outnumber
    # the threads, so each takes several
    libs = {"": build_signed(),
            ", 64 threads": build_signed((("constexpr int kMaxThreads = 512;",
                                           "constexpr int kMaxThreads = 64;"),))}
    alt = lambda p: tuple(l % 2 == 0 for l in range(p))  # noqa: E731
    cases = [((True, False), 3, "real", True), ((True, False, False), 7, "complex", True),
             (alt(4), 5, "zero", True), ((True,), 6, "real", True),
             ((True, True, True), 12, "real", True), (alt(4), 20, "real", True),
             (alt(4), 20, "complex", False), ((True, False, False), 37, "complex", True),
             ((True, True, False, True, False), 16, "real", False), (alt(2), 2, "real", True),
             ((True, False, True), 40, "real", True), ((True, True, False), 70, "complex", True)]
    for (optin, blk) in (("232448", ""), ("200", ""), ("232448", ", 64 threads")):
        lib = libs[blk]
        os.environ["STUB_SMEM_OPTIN"] = optin
        for (S, n, kind, want_q) in cases:
            p = len(S)
            rng = np.random.default_rng(10 * p + n)
            A = rng.standard_normal((p, n, n))
            if kind == "complex":
                A = A + 1j * rng.standard_normal((p, n, n))
            if kind == "zero":  # an exact zero on an inverted factor's diagonal
                A[1] = np.triu(A[1])
                A[1, 2, 2] = 0.0
            A = torch.tensor(A)
            H, Q, nl = signed_stub(lib, A, S, want_q)
            Hp, Qp = hessenberg.phessenberg_signed_core_plain(A, S, want_q)
            assert nl == (1 if n > 2 else 0), nl
            scale = float(A.abs().max())
            dh = float((H - Hp).abs().max()) / scale
            dq = float((Q - Qp).abs().max()) if want_q else 0.0
            pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
                (p, n, n)))
            Hs, Qs = hessenberg.phessenberg_signed_core_plain(A * pert, S, want_q)
            sens = max(float((Hs - Hp).abs().max()) / scale,
                       float((Qs - Qp).abs().max()) if want_q else 0.0)
            tol = max(1e-13, 10 * sens)
            assert dh <= tol and dq <= tol, (S, n, kind, dh, dq, tol)
            Hn = H.numpy()
            assert np.all(np.tril(Hn[0], -2) == 0) and all(
                np.all(np.tril(Hn[f], -1) == 0) for f in range(1, p)), "structural zeros"
            print(f"shared memory {optin} B{blk}: S={''.join('TF'[not x] for x in S)} n={n} "
                  f"{kind} want_q={want_q}: vs phessenberg_signed_core_plain dH {dh:.2e} "
                  f"dQ {dq:.2e} (tolerance {tol:.2e})", flush=True)
    return 0


def deflate_cycle(S, n, kind, seed, zero=None):
    """A periodic Hessenberg-triangular cycle (H[0] Hessenberg, the others
    upper triangular) and unitary Z of the scalar kind "real" or "complex";
    zero = (l, j) plants an exact zero at H[l][j, j]."""
    rng = np.random.default_rng(seed)
    p = len(S)

    def draw(*shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if kind == "complex" else x
    H = np.stack([np.triu(draw(n, n), -1 if l == 0 else 0) for l in range(p)])
    if zero is not None:
        H[zero[0], zero[1], zero[1]] = 0.0
    Z = np.stack([np.linalg.qr(draw(n, n))[0] for _ in range(p)])
    return torch.tensor(H), torch.tensor(Z)


def zeros_kept(Hk, Hp, tol):
    """Every exact zero of the plain result Hp is one of the kernel's Hk, and
    an exact zero of Hk alone stands where |Hp| <= tol: a fused product can
    round a mathematically zero entry to exactly 0 where the plain
    version's two roundings leave ~1e-19."""
    zk, zp = Hk == 0, Hp == 0
    return bool(zk[zp].all()) and bool((Hp[zk & ~zp].abs() <= tol).all())


def deflate_stub(lib, cores, action, H, Z, args):
    """One action through the stub's C entry on CPU tensors, in place, as
    DeflateCores._launch drives the card's; returns (launches, zflag)."""
    from periodicschurdecompositions_jl_torch.ops import pqz_deflate
    p, n, _ = H.shape
    cx = H.is_complex()
    ZT = Z.transpose(1, 2).contiguous() if cores.want_z else None
    sig = torch.tensor([int(x) for x in cores.S], dtype=torch.int32)
    ptrs = [H.data_ptr(), None if ZT is None else ZT.data_ptr(), sig.data_ptr()]
    ws = torch.full((lib.psd_deflate_scratch(n, int(cx)) // 8,), float("nan"),
                    dtype=torch.float64)
    zflag = torch.full((1,), -1, dtype=torch.int32)
    if action == "neg":
        jlo, ldef, jdef, ilast = args
        args = (*args, int(pqz_deflate._bottom(jlo, jdef, ilast)))
    else:
        ptrs.append(ws.data_ptr())
    if action == "czshift":
        ptrs.append(zflag.data_ptr())
        args = (*args, cores.ulp, cores.smlnum)
    nl = ctypes.c_int(-1)
    entry = getattr(lib, f"psd_deflate_{action}" + ("_c128" if cx else ""))
    rc = entry(*ptrs, p, n, *args, ctypes.byref(nl), None)
    assert rc == 0, rc
    if ZT is not None:
        Z.copy_(ZT.transpose(1, 2))
    return nl.value, bool(zflag.item())


def build_deflate(sub=()):
    # UBSan's alignment check stops the run at a misaligned double2 access,
    # which x86 would otherwise tolerate and the card would not
    lib = build_stub("pqz_deflate", sub=sub,
                     flags=("-fsanitize=alignment", "-fno-sanitize-recover=alignment"))
    vp, i32, f64, ip = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int)
    for cx in ("", "_c128"):
        getattr(lib, "psd_deflate_czshift" + cx).argtypes = [vp, vp, vp, vp, vp, i32, i32, i32,
                                                             i32, f64, f64, ip, vp]
        getattr(lib, "psd_deflate_pos" + cx).argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                                         i32, i32, ip, vp]
        getattr(lib, "psd_deflate_neg" + cx).argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                                         i32, i32, ip, vp]
    lib.psd_deflate_scratch.argtypes = [i32, i32]
    lib.psd_deflate_scratch.restype = ctypes.c_longlong
    return lib


def deflate_cases():
    """(action, S, n, args, zero): the windows, the planted zeros."""
    alt = lambda p: tuple(l % 2 == 0 for l in range(p))  # noqa: E731
    return [
        ("czshift", alt(4), 10, (0, 9), None),
        ("czshift", (True, True, False), 12, (3, 9), None),
        ("czshift", alt(2), 3, (0, 2), None),
        ("czshift", (True, False, True, True, False), 40, (5, 39), None),
        ("czshift", alt(4), 100, (0, 99), None),
        ("czshift", alt(4), 47, (0, 46), None),
        ("czshift", alt(4), 10, (3, 9), (1, 3)),       # inverted (jlo, jlo): identity
        ("czshift", alt(4), 10, (2, 8), (2, 6)),       # direct (k+1, k+1): identity
        ("pos", (True, True, False, True), 10, (0, 2, 5, 9), None),
        ("pos", (True, True, False, True), 10, (0, 3, 0, 9), None),
        ("pos", (True, True, False, True), 10, (2, 1, 8, 8), None),
        ("pos", alt(2) + (True,), 9, (1, 2, 8, 8), None),
        ("pos", (True, True, True, False, True), 70, (0, 2, 33, 69), None),
        ("pos", alt(4), 47, (0, 2, 20, 46), None),
        ("neg", alt(4), 10, (0, 1, 7, 9), None),      # down
        ("neg", alt(4), 10, (0, 3, 1, 9), None),      # up
        ("neg", alt(4), 10, (0, 1, 9, 9), None),      # down from the last row
        ("neg", alt(4), 10, (0, 3, 0, 9), None),      # up from the first row
        ("neg", (True, False, True, False, False), 12, (2, 4, 9, 10), None),
        ("neg", (True, False, True, False, False), 12, (2, 1, 4, 10), None),
        ("neg", alt(2), 3, (0, 1, 2, 2), None),
        ("neg", (True, True, False), 70, (0, 2, 50, 69), None),
        ("neg", (True, True, False), 70, (0, 2, 12, 69), None),
    ]


def main_deflate():
    from periodicschurdecompositions_jl_torch.ops import pqz_deflate
    libs = {"": build_deflate(),
            ", 64 threads": build_deflate((("constexpr int kMaxThreads = 512;",
                                            "constexpr int kMaxThreads = 64;"),))}
    eps = float(np.finfo(np.float64).eps)
    for (optin, blk) in (("232448", ""), ("200", ""), ("232448", ", 64 threads")):
        os.environ["STUB_SMEM_OPTIN"] = optin
        lib = libs[blk]
        for idx, (action, S, n, args, zero) in enumerate(deflate_cases()):
            for kind in ("real", "complex"):
                for want_z in (True, False):
                    p = len(S)
                    if action != "czshift":      # the zero the action deflates
                        zero = (args[1], args[2])
                    H0, Z0 = deflate_cycle(S, n, kind, 7 * idx + n, zero)
                    cores = pqz_deflate.DeflateCores(p, S, want_z, eps,
                                                     float(np.finfo(np.float64).tiny) * n / eps)
                    plain = getattr(cores, f"{action}_core_plain")

                    def run_plain(H):
                        H, Z = H.clone(), Z0.clone()
                        out = plain(H, Z, *args)
                        return H, Z, (out[2] if action == "czshift" else None)
                    Hp, Zp, fp = run_plain(H0)
                    Hk, Zk = H0.clone(), Z0.clone()
                    nl, fk = deflate_stub(lib, cores, action, Hk, Zk, args)
                    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
                        (p, n, n)))
                    Hs, Zs, _ = run_plain(H0 * pert)
                    scale = float(H0.abs().max())
                    sens = max(float((Hs - Hp).abs().max()) / scale,
                               float((Zs - Zp).abs().max()) if want_z else 0.0)
                    tol = max(1e-13, 10 * sens)
                    dh = float((Hk - Hp).abs().max()) / scale
                    dz = float((Zk - Zp).abs().max()) if want_z else 0.0
                    assert nl == 1, nl
                    assert dh <= tol and dz <= tol, (action, S, n, args, kind, dh, dz, tol)
                    assert zeros_kept(Hk, Hp, tol * scale), (action, S, n, args, kind, "zeros")
                    if not want_z:
                        assert torch.equal(Zk, Z0), "Z changed without want_z"
                    if action == "czshift":
                        assert fk == fp, (action, S, n, args, kind, fk, fp)
                    print(f"shared memory {optin} B{blk}: {action} S="
                          f"{''.join('TF'[not x] for x in S)} n={n} {args} {kind} "
                          f"want_z={want_z}: dH {dh:.2e} dZ {dz:.2e} (tolerance {tol:.2e})"
                          + (f", zflag {fk}" if action == "czshift" else ""), flush=True)
    return 0


def build_ladders(sub=()):
    """csrc/deflate.cu and csrc/rgopen.cu for the stub (each (old, new) of
    ``sub`` replaced in both)."""
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    d = build_stub("deflate", flags=ALIGN, sub=sub)
    d.psd_deflate2x2.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32, f64, f64, f64, vp]
    r = build_stub("rgopen", flags=ALIGN, sub=sub)
    r.psd_rg_ladder.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    return d, r


def ladder_runs(d, r, tag, d_cases, r_cases):
    """Kernels D and R of the stub libraries d, r against the numpy model of
    tests/torch_ladder_host.py, bit for bit (H and Z; H without Z)."""
    import test_torch_ladder_schedule as cases
    import torch_ladder_host as lh
    for name in d_cases:
        H, Z, args, _ = cases._d_case(name)
        for want_z in (True, False):
            Hm, Zm, rounds = lh.deflate_model(H, Z if want_z else None, *args)
            Hk, Zk = torch.tensor(H), torch.tensor(Z)
            i, jmin, jmax, cs0, sn0, replace0, finzero, thr = args
            p, N, _ = H.shape
            assert d.psd_deflate2x2(Hk.data_ptr(), Zk.data_ptr() if want_z else None, p, N, i,
                                    int(jmin), int(jmax), int(bool(replace0)),
                                    int(bool(finzero)), float(cs0), float(sn0), float(thr),
                                    None) == 0
            assert np.array_equal(Hk.numpy(), Hm), (tag, name, want_z, "H")
            assert np.array_equal(Zk.numpy(), Zm if want_z else Z), (tag, name, want_z, "Z")
        print(f"{tag}: D {name} (p={p} N={N} i={i}, {rounds} round(s)) == the model bit for "
              "bit, with and without Z", flush=True)
    for (p, n, mode, j, sig, bounds) in r_cases:
        H, Z, rot = cases._r_state(p, n, 7 * p + n + j)
        S = cases._sig(sig, p)
        ilast = n - 1 if mode != "open" or j % 2 == 0 else min(n - 1, j + 5)
        if mode == "close":
            H[0, j + 1, j - 1] = 0.5
        bd = cases._r_bounds(bounds, mode, j, n)
        Sd = torch.tensor([int(x) for x in S], dtype=torch.int32)
        rt = torch.tensor(rot)
        for want_z in (True, False):
            Hm, Zm = lh.rg_model(H, Z if want_z else None, mode, j, ilast, rot, S, **bd)
            Hk, Zk = torch.tensor(H), torch.tensor(Z)
            assert r.psd_rg_ladder(Hk.data_ptr(), Zk.data_ptr() if want_z else None,
                                   rt.data_ptr(), Sd.data_ptr(), p, n,
                                   rgopen.MODES[mode], j, ilast, bd.get("rhi", n),
                                   bd.get("clo", 0), None) == 0
            assert np.array_equal(Hk.numpy(), Hm), (tag, p, n, mode, j, sig, bounds, want_z)
            assert np.array_equal(Zk.numpy(), Zm if want_z else Z), (tag, p, n, mode, j, sig)
    print(f"{tag}: R on {len(r_cases)} cases == the model bit for bit, with and without Z",
          flush=True)


def main_ladders():
    import test_torch_ladder_schedule as cases
    d, r = build_ladders()
    small = build_ladders((("kThreads = 128;", "kThreads = 64;"),))
    some = cases.R_CASES[::7]
    # (SMs, blocks per SM): the cooperative grid's cap; lines past it are
    # walked grid-stride
    for optin, grid, libs, d_cases, r_cases, what in (
            ("232448", (2, 2), (d, r), cases.D_CASES, cases.R_CASES, "source, 4 blocks"),
            ("232448", (2, 2), small, cases.D_CASES, cases.R_CASES, "64-thread blocks, 4 of them"),
            ("232448", (1, 1), (d, r), cases.D_CASES, cases.R_CASES, "one block: every line "
             "past its first 128 grid-stride"),
            ("232448", (32, 1), small, cases.D_CASES, some, "64-thread blocks, up to 32: a "
             "line a thread"),
            ("120", (2, 2), (d, r), cases.D_CASES, some, "120 B of shared memory: the parent's "
             "design")):
        os.environ.update(STUB_SMEM_OPTIN=optin, STUB_SMS=str(grid[0]),
                          STUB_BLOCKS_PER_SM=str(grid[1]))
        ladder_runs(*libs, what, d_cases, r_cases)
    return 0


def main_bounds():
    """The want_t=False bounds of B0/B (real, complex, rg) and of kernel D:
    each bounded launch leaves the entries inside its window (rows >= rlo,
    columns < chi) bit for bit as the unbounded launch on the same input,
    the others as they were, and Z as the unbounded launch (chip_smoke.py's
    bounded_ok), with and without Z; the plain versions with the same
    bounds agree with the stub within 1e-13 and keep the outside exactly.
    Logs are random (chip_smoke.py's random_logs); rlo odd and off the
    tiles' grid, chi = i + 1 and further right."""
    from chip_smoke import bounded_ok, deflate_cases, deflate_scalars, mk_rg_problem, random_logs
    from periodicschurdecompositions_jl_torch.ops import deflate
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    rng = np.random.default_rng(22)

    def against_plain(H0, Hb, Hp_u, Hp_b, rlo, chi, Zb=None, Zp=None):
        scale = float(H0.abs().max())
        assert bounded_ok(H0, Hp_u, Hp_b, rlo, chi), "plain bounded != plain unbounded inside"
        d = float((Hb - Hp_b).abs().max()) / scale
        if Zb is not None:
            d = max(d, float((Zb - Zp).abs().max()))
        assert d <= 1e-13, d
        return d

    worst = 0.0
    real = build()
    real.psd_sweep_left_bounded.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, vp]
    real.psd_sweep_right_bounded.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    for (p, n, m, i, rlo, extra, nb) in [(3, 101, 40, 90, 37, 0, 1), (1, 40, 5, 33, 5, 0, 2),
                                         (16, 70, 33, 66, 33, 0, 4), (2, 45, 0, 44, 0, 0, 3),
                                         (4, 40, 2, 4, 1, 5, 1), (3, 101, 50, 52, 49, 0, 1),
                                         (5, 64, 31, 62, 17, 2, 2)]:
        N = n + 1
        Hn, Zn, _ = problem(p, n, p * 7 + n + m)
        H0, Z0 = torch.tensor(Hn), torch.tensor(Zn)
        R = torch.tensor(random_logs("real", p, n, m, i, rng, 4))
        chi = i + 1 + extra
        for want_z in (True, False):
            Hu, Hb = H0.clone(), H0.clone()
            Zu, Zb = (Z0.clone(), Z0.clone()) if want_z else (None, None)
            zp = (lambda Zx: Zx.data_ptr() if want_z else None)
            assert real.psd_sweep_left(Hu.data_ptr(), R.data_ptr(), p, N, m, i, nb, None) == 0
            assert real.psd_sweep_right(Hu.data_ptr(), zp(Zu), R.data_ptr(), p, N, m, i, nb,
                                        None) == 0
            assert real.psd_sweep_left_bounded(Hb.data_ptr(), R.data_ptr(), p, N, m, i, nb,
                                               chi, None) == 0
            assert real.psd_sweep_right_bounded(Hb.data_ptr(), zp(Zb), R.data_ptr(), p, N, m,
                                                i, nb, rlo, None) == 0
            assert bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb), ("real", p, n, m, i, rlo, nb)
            Ha, Za, Hc = H0.clone(), Z0.clone(), H0.clone()
            sweep.apply_log_plain(Hc, None, R, m, i, want_z=False, nb=nb)
            sweep.apply_log_plain(Ha, Za, R, m, i, want_z=True, nb=nb, rhi=chi, clo=rlo)
            worst = max(worst, against_plain(H0, Hb, Hc, Ha, rlo, chi, Zb, Za if want_z else None))
        print(f"real B0/B p={p} n={n} [{m}, {i}] NB={nb} rlo={rlo} chi={chi}: bounded == "
              "unbounded inside, input outside, with and without Z", flush=True)

    cx = build_cx()
    cx.psd_qz_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    cx.psd_qz_sweep_left_bounded.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
    cx.psd_qz_sweep_right_bounded.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    rg = build_rg()
    rg.psd_rg_sweep_left_bounded.argtypes = cx.psd_qz_sweep_left_bounded.argtypes
    rg.psd_rg_sweep_right_bounded.argtypes = cx.psd_qz_sweep_right_bounded.argtypes
    for kind, lib, cases in (
            ("cx", cx, [(3, 57, 10, 50, 9, 0), (2, 40, 0, 39, 0, 0), (4, 33, 17, 20, 17, 4),
                        (8, 64, 21, 63, 3, 0)]),
            ("rg", rg, [(3, 57, 11, 50, 10, 0), (2, 40, 1, 39, 0, 0), (4, 33, 17, 21, 16, 4),
                        (8, 64, 5, 63, 3, 0)])):
        name = "qz" if kind == "cx" else "rg"
        left, right = getattr(lib, f"psd_{name}_sweep_left"), getattr(lib, f"psd_{name}_sweep_right")
        leftb = getattr(lib, f"psd_{name}_sweep_left_bounded")
        rightb = getattr(lib, f"psd_{name}_sweep_right_bounded")
        plain = sweep_cx.qz_apply_log_plain if kind == "cx" else sweep_rg.rg_apply_log_plain
        for (p, n, m, i, rlo, extra) in cases:
            mk = mk_cx_problem if kind == "cx" else mk_rg_problem
            Hn, Zn, _ = mk(p, n, np.random.default_rng(p * 11 + n + m))
            H0, Z0 = torch.tensor(Hn), torch.tensor(Zn)
            lg = torch.tensor(random_logs(kind, p, n, m, i, rng))
            chi = i + 1 + extra
            for want_z in (True, False):
                Hu, Hb = H0.clone(), H0.clone()
                Zu, Zb = (Z0.clone(), Z0.clone()) if want_z else (None, None)
                zp = (lambda Zx: Zx.data_ptr() if want_z else None)
                assert left(Hu.data_ptr(), lg.data_ptr(), p, n, m, i, None) == 0
                assert right(Hu.data_ptr(), zp(Zu), lg.data_ptr(), p, n, m, i, None) == 0
                assert leftb(Hb.data_ptr(), lg.data_ptr(), p, n, m, i, chi, None) == 0
                assert rightb(Hb.data_ptr(), zp(Zb), lg.data_ptr(), p, n, m, i, rlo, None) == 0
                assert bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb), (kind, p, n, m, i, rlo)
                Ha, Za, Hc = H0.clone(), Z0.clone(), H0.clone()
                plain(Hc, None, lg, m, i, want_z=False)
                plain(Ha, Za, lg, m, i, want_z=True, rhi=chi, clo=rlo)
                worst = max(worst, against_plain(H0, Hb, Hc, Ha, rlo, chi, Zb,
                                                 Za if want_z else None))
            print(f"{kind} B0/B p={p} n={n} [{m}, {i}] rlo={rlo} chi={chi}: bounded == "
                  "unbounded inside, input outside, with and without Z", flush=True)

    d, _ = build_ladders()
    d.psd_deflate2x2_bounded.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, i32, f64, f64,
                                         f64, i32, i32, vp]
    for optin, grid, what in (("232448", (2, 2), "4 blocks"), ("232448", (1, 1), "one block"),
                              ("120", (2, 2), "the parent's design")):
        os.environ.update(STUB_SMEM_OPTIN=optin, STUB_SMS=str(grid[0]),
                          STUB_BLOCKS_PER_SM=str(grid[1]))
        for (p, n) in ((4, 40), (3, 23), (1, 12)):
            for (label, Hn, Zn, i) in deflate_cases(p, n):
                sc = deflate_scalars(Hn, i)
                args = (i, sc["jmin"], sc["jmax"], sc["cs0"], sc["sn0"], sc["replace0"],
                        sc["finzero"], sc["thr"])
                cargs = (i, int(sc["jmin"]), int(sc["jmax"]), int(bool(sc["replace0"])),
                         int(bool(sc["finzero"])), float(sc["cs0"]), float(sc["sn0"]),
                         float(sc["thr"]))
                H0, Z0 = torch.tensor(Hn), torch.tensor(Zn)
                N = n + 1
                for rlo, chi in ((i - 1, i + 1), (3, min(i + 4, N))):
                    for want_z in (True, False):
                        Hu, Hb = H0.clone(), H0.clone()
                        Zu, Zb = (Z0.clone(), Z0.clone()) if want_z else (None, None)
                        zp = (lambda Zx: Zx.data_ptr() if want_z else None)
                        assert d.psd_deflate2x2(Hu.data_ptr(), zp(Zu), p, N, *cargs,
                                                None) == 0
                        assert d.psd_deflate2x2_bounded(Hb.data_ptr(), zp(Zb), p, N, *cargs,
                                                        rlo, chi, None) == 0
                        assert bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb), (what, label, p, n)
                        Ha, Za, Hc = H0.clone(), Z0.clone(), H0.clone()
                        deflate.deflate2x2_plain(Hc, None, *args, want_z=False)
                        deflate.deflate2x2_plain(Ha, Za, *args, want_z=True, rhi=chi, clo=rlo)
                        worst = max(worst, against_plain(H0, Hb, Hc, Ha, rlo, chi, Zb,
                                                         Za if want_z else None))
        print(f"D ({what}): chainA, chainB, chainB-jmax at p=4 n=40, p=3 n=23, p=1 n=12, "
              "bounds (i-1, i+1) and (3, i+4): bounded == unbounded inside, input outside",
              flush=True)
    print(f"plain versions with the same bounds: within {worst:.3e} of the stub", flush=True)
    return 0


def build_glue(tag, path=None, sub=()):
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib = build_stub("glue", path=path, sub=sub, flags=ALIGN, tag=tag)
    lib.psd_glue.argtypes = [vp, vp, vp] + [i32] * 7 + [f64] * 3 + [vp]
    return lib


def glue_stub(lib, H, n, l, i, its, cfg):
    """The packed buffer of the stub's kernel G (output and scratch filled
    with NaN)."""
    from periodicschurdecompositions_jl_torch.ops import glue
    p = H.shape[0]
    k = glue.out_len(p, n)
    buf = torch.full((k + 3 * n,), np.nan, dtype=torch.float64)
    ulp, ulpx, smlnum = glue.scan_constants(n, cfg)
    Ht = torch.tensor(H)
    assert lib.psd_glue(Ht.data_ptr(), buf.data_ptr(), buf[k:].data_ptr(), p, n, l, i, its,
                        int(cfg.slicot_convg), int(cfg.slicot_shifts), ulp, ulpx, smlnum,
                        None) == 0
    return buf[:k].numpy()


def main_glue(parent):
    """Kernel G on the stub against glue_plain, the numpy model of
    tests/torch_glue_host.py (and through both the host glue) and the
    parent's glue.cu, bit for bit, on the model test's cycles and windows:
    the source, chunks of 5 rows on 32 threads and the least shared
    memory (one factor a group)."""
    import test_torch_glue_schedule as cases
    import torch_glue_host as gh
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import glue
    lib = build_glue("glue")
    small = build_glue("glue_r5", sub=[("constexpr int kGlueThreads = 64;",
                                        "constexpr int kGlueThreads = 32;"),
                                       ("constexpr int kGlueRows = 32;",
                                        "constexpr int kGlueRows = 5;")])
    old = build_glue("glue_parent", parent) if parent else None
    cfgs = [AlgoConfig(), AlgoConfig(slicot_convg=True), AlgoConfig(slicot_shifts=True)]
    wide = {"STUB_SMEM_OPTIN": str(gh.H100_OPTIN)}
    for p in (1, 2, 3, 16, 40):
        for n in (1, 2, 3, 5, 31, 33, 600):
            H = cases._cycle(p, n, 1000 * p + n)
            runs = 0
            for (l, i) in cases._windows(n):
                for its in (1, 10, 16, 20):
                    for cfg in cfgs:
                        ref = glue.glue_plain(torch.tensor(H), n, l, i, its, cfg).numpy()
                        builds = [("source", lib, {}, {})]
                        if its == 1 and cfg is cfgs[0]:
                            builds += [
                                ("5-row chunks", small, {}, {"rows": 5, "threads": 32}),
                                ("tight", lib, {"STUB_SMEM_OPTIN": str(gh.glue_tight_optin(p))},
                                 {"optin": gh.glue_tight_optin(p)})]
                            if old is not None:
                                builds.append(("parent", old, {}, None))
                        for tag, lb, env, kw in builds:
                            os.environ.update({**wide, **env})
                            out = glue_stub(lb, H, n, l, i, its, cfg)
                            assert np.array_equal(out, ref), (tag, p, n, l, i, its, cfg)
                            if kw is not None:
                                model = gh.glue_model(H, n, l, i, its, cfg, **kw)
                                assert np.array_equal(out, model), (tag, p, n, l, i, its)
                            runs += 1
            print(f"G p={p} n={n}: {runs} runs bit for bit with glue_plain and the model"
                  f"{' and the parent' if old is not None else ''} (the source, 5-row "
                  "chunks, the least shared memory)", flush=True)
    os.environ.update(wide)
    return 0


def main_shards():
    """The shard entries against the unsharded B0/B (see the module
    docstring)."""
    from chip_smoke import random_logs
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib = build()
    lib.psd_sweep_left_bounded.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_right_bounded.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.psd_sweep_left_shard.argtypes = [vp, vp] + [i32] * 9 + [vp]
    lib.psd_sweep_right_shard.argtypes = [vp, vp, vp] + [i32] * 8 + [vp]
    worst, runs = 0.0, 0
    for (p, n, m, i, nb, bounded) in [(3, 63, 0, 62, 1, False), (2, 47, 5, 40, 1, True),
                                      (16, 39, 3, 30, 4, False), (1, 31, 1, 29, 1, False),
                                      (4, 71, 33, 69, 2, True), (3, 63, 17, 19, 1, False)]:
        N = n + 1
        Hn, Zn, v0 = problem(p, n, p * 13 + n + m)
        H0, Z0 = torch.tensor(Hn), torch.tensor(Zn)
        if nb == 1:
            work = torch.full((lib.psd_sweep_generate_scratch(p, N),), float("nan"),
                              dtype=torch.float64)
            R = torch.full((p, N, 9), float("nan"), dtype=torch.float64)
            assert lib.psd_sweep_generate(H0.data_ptr(), work.data_ptr(), R.data_ptr(), p, N,
                                          m, i, *map(float, v0), None) == 0
        else:
            R = torch.tensor(random_logs("real", p, n, m, i, np.random.default_rng(n), nb))
        chi, rlo = (i + 1, max(m - 3, 0)) if bounded else (N, 0)
        for want_z in (True, False):
            Hu, Zu = H0.clone(), Z0.clone()
            assert lib.psd_sweep_left_bounded(Hu.data_ptr(), R.data_ptr(), p, N, m, i, nb, chi,
                                              None) == 0
            assert lib.psd_sweep_right_bounded(Hu.data_ptr(), Zu.data_ptr() if want_z else None,
                                               R.data_ptr(), p, N, m, i, nb, rlo, None) == 0
            for D in (1, 2, 4, 8):
                if N % D:
                    continue
                L = N // D
                Hs, Zs = H0.clone(), Z0.clone()
                Hp, Zp = H0.clone(), Z0.clone()
                for d in range(D):
                    c0 = d * L
                    for X, fn in ((Hs, "stub"), (Hp, "plain")):
                        Hc = X[:, :, c0:c0 + L].contiguous()
                        if fn == "stub":
                            assert lib.psd_sweep_left_shard(Hc.data_ptr(), R.data_ptr(), p, N,
                                                            m, i, nb, chi, L, c0, L, None) == 0
                        else:
                            sweep.apply_log_shard_plain(Hc, None, R, m, i, side="left",
                                                        offset=c0, nb=nb,
                                                        rhi=chi if bounded else None)
                        X[:, :, c0:c0 + L] = Hc
                for d in range(D):
                    r0 = d * L
                    for X, Y, fn in ((Hs, Zs, "stub"), (Hp, Zp, "plain")):
                        Hr, Zr = X[:, r0:r0 + L].contiguous(), Y[:, r0:r0 + L].contiguous()
                        if fn == "stub":
                            assert lib.psd_sweep_right_shard(
                                Hr.data_ptr(), Zr.data_ptr() if want_z else None,
                                R.data_ptr(), p, N, m, i, nb, rlo, r0, L, None) == 0
                        else:
                            sweep.apply_log_shard_plain(Hr, Zr, R, m, i, side="right",
                                                        offset=r0, want_z=want_z, nb=nb,
                                                        clo=rlo if bounded else None)
                        X[:, r0:r0 + L], Y[:, r0:r0 + L] = Hr, Zr
                assert torch.equal(Hs, Hu) and torch.equal(Zs, Zu), \
                    f"shards != unsharded: p={p} n={n} [{m}, {i}] NB={nb} D={D} z={want_z}"
                d_ = max(float((Hp - Hs).abs().max()) / float(H0.abs().max()),
                         float((Zp - Zs).abs().max()))
                assert d_ <= 1e-13, d_
                worst, runs = max(worst, d_), runs + 1
        print(f"p={p} n={n} [{m}, {i}] NB={nb} bounds={bounded}: the shard entries == B0/B "
              f"bit for bit, D = 1, 2, 4, 8 where N allows, with and without Z", flush=True)
    print(f"{runs} runs; apply_log_shard_plain vs the stub <= {worst:.3e}")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cx", action="store_true")
    ap.add_argument("--rg", action="store_true")
    ap.add_argument("--hess", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--signed", action="store_true")
    ap.add_argument("--deflate", action="store_true")
    ap.add_argument("--mb", action="store_true")
    ap.add_argument("--ladders", action="store_true")
    ap.add_argument("--glue", action="store_true")
    ap.add_argument("--bounds", action="store_true")
    ap.add_argument("--shards", action="store_true")
    args = ap.parse_args()
    if args.shards:
        return main_shards()
    if args.bounds:
        return main_bounds()
    if args.glue:
        return main_glue(args.parent)
    if args.ladders:
        return main_ladders()
    if args.mb:
        return main_mb()
    if args.deflate:
        return main_deflate()
    if args.signed:
        return main_signed()
    if args.hess:
        return main_hess(args.parent)
    if args.cx:
        return main_cx(args.parent)
    if args.rg:
        return main_rg()
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
    # the source's sizes, then the tightest chunk (2 kMaxNb) with 8-line tiles
    tight = build_stub("sweep", flags=ALIGN, sub=[
        ("constexpr int kApplyChunk = ", "constexpr int kApplyChunk = 8; //"),
        ("constexpr int kLeftCols = ", "constexpr int kLeftCols = 8; //"),
        ("constexpr int kRightRows = ", "constexpr int kRightRows = 8; //")])
    for fn in ("psd_sweep_generate", "psd_sweep_generate_scratch", "psd_sweep_generate_mb",
               "psd_sweep_generate_mb_scratch", "psd_sweep_left", "psd_sweep_right"):
        getattr(tight, fn).argtypes = getattr(lib, fn).argtypes
        getattr(tight, fn).restype = getattr(lib, fn).restype
    for lb in (lib, tight):
        sizes = apply_sizes() if lb is lib else {"cols": 8, "rows": 8, "chunk": 8}
        for (p, n, m, i) in [(1, 12, 0, 11), (2, 14, 2, 12), (3, 40, 0, 39), (16, 37, 5, 33),
                             (4, 8, 2, 4), (2, 6, 2, 3), (5, 70, 3, 66), (1, 40, 20, 39),
                             (3, 33, 1, 32), (2, 45, 0, 44)]:
            runs = check_apply(lb, p, n, m, i, sizes)
            print(f"p={p} n={n} [{m}, {i}]: B0+B == the numpy model bit for bit in {runs} "
                  f"runs (A's log; A-mb's, NB = 1..4; with and without Z; {sizes})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
