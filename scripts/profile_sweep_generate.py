#!/usr/bin/env python3
"""Where a sweep-generation kernel's time goes, on one CUDA card.

Real kernel A (default): builds an instrumented copy of csrc/sweep.cu under
``_dev/`` (clock64 counters in kernel A: lane 0's generation per (step,
factor), the whole (step, factor) of the serial phase, and the update
phases) with a few latency microbenchmarks appended (one thread: a chain of
the fused two-reflector generation, of the bulge reflector, of float64
divisions, square roots and multiply-adds), then runs kernel A on
chip_smoke.py's sweep problem (p=16, n=512, windows [0, 511] and [37, 300])
and prints cycles.

``--cx``: the same for the complex kernel A of csrc/sweep_cx.cu on
chip_smoke.py's ``cx_kernel_phase`` problem (p=8, n=256,
``default_rng(2025)``, alternating S, windows [0, 255] and [37, 200]).  The
counters follow the design found in the source: the design with a working
copy C (thread 0 generates, the block updates whole rows between block
barriers) reports thread 0's ``givens_cx``, its row updates and its waits
at the barriers per (step, factor); the look-ahead window reports the
warp's ``givens_cx`` and the whole (step, factor) of the serial phase, both
timed on lane 0, and the update phases.  Microbenchmarks: one thread's
chain of ``givens_cx``, of divisions, of square roots and of one complex
2x2 row rotation.

``--rg``: the real generalized chase kernel rg A of csrc/sweep_rg.cu on
chip_smoke.py's ``rg_kernel_phase`` problem (p=8, n=256,
``default_rng(2026)``, alternating S, the opening ladder applied, windows
[1, 255] and [38, 200]).  The design with a working copy C (thread 0
generates and applies the band's right rotations, the block updates whole
rows between block barriers) reports, per (step, factor) and on thread 0,
the first and the second ``givens_r`` of the pair, the row updates, the
band updates, the waits at the block barriers and the rest; the
look-ahead window reports the warp's two ``givens_r`` on lane 0, the
whole (step, factor) of the serial phase and the update phases.
Microbenchmarks: one thread's chain of ``givens_r``, of divisions, of
square roots and of one two-row rotation.

``--hess``: the periodic Hessenberg reduction of csrc/hess.cu (one
cooperative launch) on the real headline draw (p=16, n=512, seed 12345)
and the complex leg's draw (p=8, n=256, seed 777): per block and stage the
cycles of its generation, of its update tiles and of its wait at the grid
barrier (a block of the first left tile, one of the right tiles and the
mean over blocks), and inside the tiles the cycles of a left tile's first
pass (the dot products, to its partial sums) and whole, and of a right
tile row's first pass and whole, timed on thread 0.

``--root DIR`` instruments the sources of another checkout (for example
the parent commit unpacked with ``git archive``).  The counters add about a
tenth to the kernel's time (they accumulate in global memory).

Run from the repository root:
  python3 scripts/profile_sweep_generate.py [--cx | --rg | --hess] [--root DIR]
"""
import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BENCH = r'''
namespace {
__global__ void bench_gen(double* out, int T, double a0, double a1, double a2) {
  double F[9], beta, betab;
  double x0 = a0, x1 = a1, x2 = a2;
  long long t0 = clock64();
  for (int t = 0; t < T; ++t) {
    gen_fused(x0, x1, x2, x1, x2, x0, true, F, beta, betab);
    x0 = a0 + 1e-3 * F[4]; x1 = a1 + 1e-3 * F[5]; x2 = a2 + 1e-3 * F[8];
  }
  out[0] = (double)(clock64() - t0) / T;
  t0 = clock64();
  for (int t = 0; t < T; ++t) {
    gen_bulge(x0, x1, x2, true, F, beta);
    x0 = a0 + 1e-3 * F[4]; x1 = a1 + 1e-3 * F[5]; x2 = a2 + 1e-3 * F[8];
  }
  out[1] = (double)(clock64() - t0) / T;
  double y = a0;
  t0 = clock64();
  for (int t = 0; t < T; ++t) y = a1 / (y + 1.5);
  out[2] = (double)(clock64() - t0) / T;
  t0 = clock64();
  for (int t = 0; t < T; ++t) y = sqrt(y + 1.5);
  out[3] = (double)(clock64() - t0) / T;
  t0 = clock64();
  for (int t = 0; t < T; ++t) y = fma(y, a1, a2);
  out[4] = (double)(clock64() - t0) / T;
  out[5] = x0 + x1 + x2 + y;
}
}  // namespace
extern "C" int prof_bench(double* out, int T) {
  bench_gen<<<1, 1>>>(out, T, 0.3, -0.7, 0.2);
  return (int)cudaGetLastError();
}
'''

BENCH_CX = r'''
namespace {
__global__ void bench_gen(double* out, int T, double a0, double a1, double a2) {
  double c = 0.0;
  double2 s = make_double2(a0, a1), r = make_double2(a2, a0);
  long long t0 = clock64();
  for (int t = 0; t < T; ++t) {
    psd::givens_cx(make_double2(a0 + 1e-3 * c, a1), make_double2(a2, a0 + 1e-3 * s.y), c, s, r);
  }
  out[0] = (double)(clock64() - t0) / T;
  double2 x0 = make_double2(a0, a1), x1 = make_double2(a2, a0);
  double2 M[4];
  put_lmat(M, 0.6, make_double2(0.48, 0.64));
  t0 = clock64();
  for (int t = 0; t < T; ++t) left2(M, x0, x1);
  out[1] = (double)(clock64() - t0) / T;
  double y = a0;
  t0 = clock64();
  for (int t = 0; t < T; ++t) y = a1 / (y + 1.5);
  out[2] = (double)(clock64() - t0) / T;
  t0 = clock64();
  for (int t = 0; t < T; ++t) y = sqrt(y + 1.5);
  out[3] = (double)(clock64() - t0) / T;
  out[4] = 0.0;
  out[5] = c + s.x + r.y + x0.x + x1.y + y;
}
}  // namespace
extern "C" int prof_bench(double* out, int T) {
  bench_gen<<<1, 1>>>(out, T, 0.3, -0.7, 0.2);
  return (int)cudaGetLastError();
}
'''

BENCH_RG = r'''
namespace {
__global__ void bench_gen(double* out, int T, double a0, double a1, double a2) {
  double c = 0.0, s = 0.0, r = a2;
  long long t0 = clock64();
  for (int t = 0; t < T; ++t) psd::givens_r(a0 + 1e-3 * c, a1 + 1e-3 * s, c, s, r);
  out[0] = (double)(clock64() - t0) / T;
  double x0 = a0, x1 = a1;
  t0 = clock64();
  for (int t = 0; t < T; ++t) {
    const double y0 = 0.6 * x0 + 0.8 * x1;
    x1 = -0.8 * x0 + 0.6 * x1;
    x0 = y0;
  }
  out[1] = (double)(clock64() - t0) / T;
  double y = a0;
  t0 = clock64();
  for (int t = 0; t < T; ++t) y = a1 / (y + 1.5);
  out[2] = (double)(clock64() - t0) / T;
  t0 = clock64();
  for (int t = 0; t < T; ++t) y = sqrt(y + 1.5);
  out[3] = (double)(clock64() - t0) / T;
  out[4] = 0.0;
  out[5] = c + s + r + x0 + x1 + y;
}
}  // namespace
extern "C" int prof_bench(double* out, int T) {
  bench_gen<<<1, 1>>>(out, T, 0.3, -0.7, 0.2);
  return (int)cudaGetLastError();
}
'''

READ = r'''
extern "C" int prof_read(long long* host) {
  cudaDeviceSynchronize();
  cudaError_t e = cudaMemcpyFromSymbol(host, g_prof, sizeof(long long) * 8);
  long long z[8] = {0};
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)e;
}
'''

EDITS = [  # (text in csrc/sweep.cu, instrumented text)
    ("namespace {\n", "namespace {\n__device__ long long g_prof[8];\n"),
    ("      double betab = 0.0;\n      if (lane == 0) {",
     "      double betab = 0.0;\n      long long tq0 = clock64();\n      if (lane == 0) {"),
    ("          Rk[t] = M[t];\n        }\n      }",
     "          Rk[t] = M[t];\n        }\n        g_prof[0] += clock64() - tq0;\n      }"),
    ("        y[2] = o2;\n      }\n      __syncwarp();\n    }\n  }",
     "        y[2] = o2;\n      }\n      __syncwarp();\n"
     "      if (lane == 0) g_prof[1] += clock64() - tq0;\n    }\n  }"),
    ("    if (k1 == i) break;\n    __syncthreads();",
     "    if (k1 == i) break;\n    __syncthreads();\n    long long tu0 = clock64();"),
    ("    __syncthreads();\n    k0 = k1;",
     "    __syncthreads();\n    if (threadIdx.x == 0) g_prof[2] += clock64() - tu0;\n    k0 = k1;"),
]

# The cx kernel A with a working copy C: wrappers timed from thread 0
PROF_CX_COPY = r'''
__device__ long long g_prof[8];
__device__ __forceinline__ void prof_givens(double2 f, double2 g, double& c, double2& s,
                                            double2& r) {
  const long long t = clock64();
  psd::givens_cx(f, g, c, s, r);
  g_prof[0] += clock64() - t;
}
__device__ __forceinline__ void prof_rows_left(double2* Cl, int n, int k, int c0, double c,
                                               double2 s) {
  const long long t = clock64();
  rows_left(Cl, n, k, c0, c, s);
  if (threadIdx.x == 0) g_prof[1] += clock64() - t;
}
__device__ __forceinline__ void prof_sync() {
  const long long t = clock64();
  __syncthreads();
  if (threadIdx.x == 0) g_prof[2] += clock64() - t;
}
'''

# The cx kernel A with look-ahead windows: the warp's givens_cx, timed on lane 0
PROF_CX_WINDOW = r'''
__device__ long long g_prof[8];
__device__ __forceinline__ void prof_givens(double2 f, double2 g, double& c, double2& s,
                                            double2& r) {
  const long long t = clock64();
  givens_cx_warp(f, g, c, s, r);
  if ((threadIdx.x & 31) == 0) g_prof[0] += clock64() - t;
}
'''


def _replace_once(src, old, new, what):
    if src.count(old) != 1:
        raise SystemExit(f"{what} changed; instrument by hand:\n{old}")
    return src.replace(old, new)


def instrument_cx(src):
    """Counters for the design found in csrc/sweep_cx.cu's kernel A."""
    head, sep, tail = src.partition("__global__ void __launch_bounds__(kGenThreads)\n")
    if not sep:
        raise SystemExit("csrc/sweep_cx.cu: kernel A not found; instrument by hand")
    body, sep2, rest = tail.partition("\n}\n")  # the kernel's body
    if "rows_left(" in body:  # working copy C, block barriers
        body = body.replace("psd::givens_cx(", "prof_givens(")
        body = body.replace("rows_left(", "prof_rows_left(")
        body = body.replace("__syncthreads();", "prof_sync();")
        body = _replace_once(body, "  const int tid = threadIdx.x;\n",
                             "  const int tid = threadIdx.x;\n  const long long tk0 = clock64();\n",
                             "csrc/sweep_cx.cu")
        body += "\n  if (tid == 0) g_prof[3] += clock64() - tk0;"
        return head + PROF_CX_COPY + sep + body + sep2 + rest, "copy"
    # look-ahead windows: lane 0's generations in the serial phase, the whole
    # (step, factor) and the update phases
    src = _replace_once(src, "// Serial phase of the batch",
                        PROF_CX_WINDOW + "// Serial phase of the batch", "csrc/sweep_cx.cu")
    src = src.replace("givens_cx_warp(Wf", "prof_givens(Wf")
    for old, new in EDITS_CX_WINDOW:
        src = _replace_once(src, old, new, "csrc/sweep_cx.cu")
    return src, "window"


EDITS_CX_WINDOW = [  # (text in csrc/sweep_cx.cu, instrumented text)
    ("    for (int q = 0; q < p; ++q) {\n",
     "    for (int q = 0; q < p; ++q) {\n      const long long tq0 = clock64();\n"),
    ("    }  // factors\n",
     "      if (lane == 0) g_prof[1] += clock64() - tq0;\n    }  // factors\n"),
    ("    if (k1 == i) break;\n    __syncthreads();",
     "    if (k1 == i) break;\n    __syncthreads();\n    const long long tu0 = clock64();"),
    ("    __syncthreads();\n    k0 = k1;",
     "    __syncthreads();\n    if (threadIdx.x == 0) g_prof[2] += clock64() - tu0;\n    k0 = k1;"),
]


# rg A with a working copy C: thread 0's two givens_r of each pair, its
# share of the row updates, its band updates and its waits at the barriers
PROF_RG_COPY = r'''
__device__ long long g_prof[8];
__device__ __forceinline__ void prof_givens(int k, double f, double g, double& c, double& s,
                                            double& r) {
  const long long t = clock64();
  psd::givens_r(f, g, c, s, r);
  g_prof[k] += clock64() - t;
}
__device__ __forceinline__ void prof_rows_left(double* Cl, int n, int k, int c0, double c,
                                               double s) {
  const long long t = clock64();
  rows_left(Cl, n, k, c0, c, s);
  if (threadIdx.x == 0) g_prof[2] += clock64() - t;
}
__device__ __forceinline__ void prof_band_right(double* Cl, int n, int k, int r0, int r1,
                                                double c, double s) {
  const long long t = clock64();
  band_right(Cl, n, k, r0, r1, c, s);
  g_prof[3] += clock64() - t;
}
__device__ __forceinline__ void prof_sync() {
  const long long t = clock64();
  __syncthreads();
  if (threadIdx.x == 0) g_prof[4] += clock64() - t;
}
'''


def instrument_rg(src):
    """Counters for the design found in csrc/sweep_rg.cu's kernel rg A."""
    head, sep, tail = src.partition("__global__ void __launch_bounds__(kGenThreads)\n")
    if not sep:
        raise SystemExit("csrc/sweep_rg.cu: kernel rg A not found; instrument by hand")
    body, sep2, rest = tail.partition("\n}\n")  # the kernel's body
    if "rows_left(" in body:  # working copy C, block barriers
        parts = body.split("psd::givens_r(")
        body = parts[0] + "".join(f"prof_givens({k % 2}, " + x
                                  for k, x in enumerate(parts[1:]))
        body = body.replace("rows_left(", "prof_rows_left(")
        body = body.replace("band_right(", "prof_band_right(")
        body = body.replace("__syncthreads();", "prof_sync();")
        body = _replace_once(body, "    // rows j+1, j+2 then j, j+1 of C[0], columns j..n-1\n",
                             "    const long long tr0 = clock64();\n", "csrc/sweep_rg.cu")
        body = _replace_once(body, "      x[n] = -s1 * x0 + c1 * y1;\n    }\n",
                             "      x[n] = -s1 * x0 + c1 * y1;\n    }\n"
                             "    if (tid == 0) g_prof[2] += clock64() - tr0;\n",
                             "csrc/sweep_rg.cu")
        body = _replace_once(body, "  const int tid = threadIdx.x;\n",
                             "  const int tid = threadIdx.x;\n  const long long tk0 = clock64();\n",
                             "csrc/sweep_rg.cu")
        body += "\n  if (tid == 0) g_prof[5] += clock64() - tk0;"
        return head + PROF_RG_COPY + sep + body + sep2 + rest, "copy"
    # look-ahead windows: lane 0's two generations of each pair in the
    # serial phase, the whole step and the update phases
    pre, sep, serial = src.partition("// Serial phase of the batch")
    if not sep:
        raise SystemExit("csrc/sweep_rg.cu: unknown design; instrument by hand")
    serial, sep2, post = serial.partition("// Window entries (a, b)")
    parts = serial.split("givens_gen(")
    serial = parts[0] + "".join(f"prof_givens({k % 2}, " + x for k, x in enumerate(parts[1:]))
    src = pre + PROF_RG_WINDOW + sep + serial + sep2 + post
    for old, new in EDITS_RG_WINDOW:
        src = _replace_once(src, old, new, "csrc/sweep_rg.cu")
    return src, "window"


# rg A with look-ahead windows: the warp's givens, timed on lane 0
PROF_RG_WINDOW = r'''__device__ long long g_prof[8];
__device__ __forceinline__ void prof_givens(int k, double f, double g, double& c, double& s,
                                            double& r) {
  const long long t = clock64();
  givens_gen(f, g, c, s, r);
  if ((threadIdx.x & 31) == 0) g_prof[k] += clock64() - t;
}

'''

EDITS_RG_WINDOW = [  # (text in csrc/sweep_rg.cu, instrumented text)
    ("    const int t = j - j0;\n",
     "    const int t = j - j0;\n    const long long tq0 = clock64();\n"),
    ("      __syncwarp();\n    }\n    // ---- factors p-1..1",
     "      __syncwarp();\n    }\n    if (lane == 0) g_prof[4] += clock64() - tq0;\n"
     "    // ---- factors p-1..1"),
    ("      if (__ldg(S + l)) {\n",
     "      const long long tf0 = clock64();\n      if (__ldg(S + l)) {\n"),
    ("      put4(hp + 4 * ((size_t)l * L + t), c1, s1, c2, s2);\n      __syncwarp();\n",
     "      put4(hp + 4 * ((size_t)l * L + t), c1, s1, c2, s2);\n      __syncwarp();\n"
     "      if (lane == 0) g_prof[__ldg(S + l) ? 6 : 7] += clock64() - tf0;\n"),
    ("    // ---- ring close on factor 0",
     "    const long long tr0 = clock64();\n    // ---- ring close on factor 0"),
    ("      win_right(win, SW, t + lane, t + 1, c1, s1);\n    }\n    __syncwarp();\n  }\n",
     "      win_right(win, SW, t + lane, t + 1, c1, s1);\n    }\n    __syncwarp();\n"
     "    if (lane == 0) {\n      g_prof[5] += clock64() - tr0;\n"
     "      g_prof[3] += clock64() - tq0;\n    }\n  }\n"),
    ("    __syncthreads();\n    write_log(",
     "    __syncthreads();\n    const long long tu0 = clock64();\n    write_log("),
    ("    __syncthreads();\n    j0 = j1;",
     "    __syncthreads();\n    if (threadIdx.x == 0) g_prof[2] += clock64() - tu0;\n    j0 = j1;"),
]


EDITS_HESS = [  # (text in csrc/hess.cu, instrumented text)
    ("constexpr int kThreads = 256;\n",
     "constexpr int kThreads = 256;\n__device__ long long g_prof[8 * 2048];\n"),
    # left tile: its first pass, and the whole tile (thread 0)
    ("  const int tx = threadIdx.x % kLeftCols, ty = threadIdx.x / kLeftCols;\n",
     "  const long long ta = clock64();\n"
     "  const int tx = threadIdx.x % kLeftCols, ty = threadIdx.x / kLeftCols;\n"),
    ("  if (mine) part[ty * kLeftCols + tx] = s;\n",
     "  if (mine) part[ty * kLeftCols + tx] = s;\n"
     "  if (threadIdx.x == 0) g_prof[8 * blockIdx.x + 3] += clock64() - ta;\n"),
    ("  __syncthreads();  // part is free again\n",
     "  if (threadIdx.x == 0) {\n    g_prof[8 * blockIdx.x + 4] += clock64() - ta;\n"
     "    g_prof[8 * blockIdx.x + 5] += 1;\n  }\n  __syncthreads();  // part is free again\n"),
    # right tile rows: first pass and whole row (warp 0, lane 0)
    ("    T* row = M + (size_t)r * n;\n",
     "    const long long tr = clock64();\n    T* row = M + (size_t)r * n;\n"),
    ("    const T ts = mul(tau, warp_sum(s));\n",
     "    const T ts = mul(tau, warp_sum(s));\n"
     "    if (threadIdx.x == 0) g_prof[8 * blockIdx.x + 6] += clock64() - tr;\n"),
    # stages: generation, update tiles, wait at the barrier
    ("  for (int i = 0; i < n - 1; ++i) {\n    for (int j = p - 1; j >= 0; --j) {\n",
     "  long long tg = 0, tu = 0, tb = 0;\n  for (int i = 0; i < n - 1; ++i) {\n"
     "    for (int j = p - 1; j >= 0; --j) {\n      const long long c0 = clock64();\n"),
    ("      const int nbl = (n - i - 1 + kLeftCols - 1) / kLeftCols;\n",
     "      const long long c1 = clock64();\n      tg += c1 - c0;\n"
     "      const int nbl = (n - i - 1 + kLeftCols - 1) / kLeftCols;\n"),
    ("      const double beta = sc->beta;\n      grid.sync();\n",
     "      const double beta = sc->beta;\n      const long long c2 = clock64();\n"
     "      tu += c2 - c1;\n      grid.sync();\n      tb += clock64() - c2;\n"),
    ("          col[(size_t)r * n] = real_as((r == lo) ? beta : 0.0, T());\n      }\n    }\n  }\n",
     "          col[(size_t)r * n] = real_as((r == lo) ? beta : 0.0, T());\n      }\n    }\n  }\n"
     "  if (threadIdx.x == 0) {\n    g_prof[8 * blockIdx.x] = tg;\n"
     "    g_prof[8 * blockIdx.x + 1] = tu;\n    g_prof[8 * blockIdx.x + 2] = tb;\n  }\n"),
]

READ_HESS = r'''
extern "C" int prof_read(long long* host) {
  cudaDeviceSynchronize();
  cudaError_t e = cudaMemcpyFromSymbol(host, g_prof, sizeof(long long) * 8 * 2048);
  static long long z[8 * 2048];
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)e;
}
'''


def build_hess(root):
    csrc = os.path.join(root, "periodicschurdecompositions_jl_torch", "csrc")
    src = open(os.path.join(csrc, "hess.cu")).read()
    for old, new in EDITS_HESS:
        src = _replace_once(src, old, new, "csrc/hess.cu")
    # the end of a right tile's row: after the second pass's loop
    old = "        if (c < n) row[c] = msub(rv[k], ts, conj_of(w[c]));\n      }\n    }\n"
    src = _replace_once(src, old, old + "    if (threadIdx.x == 0) {\n"
                        "      g_prof[8 * blockIdx.x + 7] += clock64() - tr;\n"
                        "      g_prof[8 * blockIdx.x + 5] += 1L << 32;\n    }\n",
                        "csrc/hess.cu")
    out = os.path.join(HERE, "_dev")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "hess_prof.cu"), os.path.join(out, "libhess_prof.so")
    open(cu, "w").write(src + READ_HESS)
    from periodicschurdecompositions_jl_torch.ops import _cuda
    subprocess.run([_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", csrc, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.psd_hess_reduce, lib.psd_hess_reduce_c128):
        fn.argtypes = [vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
    lib.prof_read.argtypes = [vp]
    return lib


def profile_hess(lib):
    buf = np.zeros(8 * 2048, dtype=np.int64)
    for (p, n, seed, cplx) in ((16, 512, 12345, False), (8, 256, 777, True)):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((p, n, n))
        if cplx:
            A = A + 1j * rng.standard_normal((p, n, n))
        A = torch.tensor(A, device="cuda")
        H = torch.empty_like(A)
        Q = torch.empty_like(A)
        ws = torch.empty(n + 2, dtype=A.dtype, device="cuda")
        entry = lib.psd_hess_reduce_c128 if cplx else lib.psd_hess_reduce
        nl = ctypes.c_int(0)

        def call():
            H.copy_(A)
            Q.copy_(torch.eye(n, dtype=A.dtype, device="cuda").expand(p, n, n))
            assert entry(H.data_ptr(), Q.data_ptr(), ws.data_ptr(), p, n, ctypes.byref(nl),
                         None) == 0
        call()  # warm-up
        lib.prof_read(buf.ctypes.data)
        ms = timed(call)
        lib.prof_read(buf.ctypes.data)
        P = buf.reshape(-1, 8)
        nb = int((P[:, 0] > 0).sum())
        st = p * (n - 1)
        ntile = P[:nb, 5] & 0xFFFFFFFF
        nrow = P[:nb, 5] >> 32
        right = int(np.argmax(nrow))  # a block that took right tiles
        print(f"reduction {'complex128' if cplx else 'float64'} p={p} n={n} (instrumented) "
              f"{ms:.3f} ms, {nb} blocks; cycles per stage, generation / update / barrier "
              f"wait: block 0 (first left tile) {P[0, 0] / st:.0f} / {P[0, 1] / st:.0f} / "
              f"{P[0, 2] / st:.0f}, block {right} (right tiles) {P[right, 0] / st:.0f} / "
              f"{P[right, 1] / st:.0f} / {P[right, 2] / st:.0f}, mean "
              f"{P[:nb, 0].mean() / st:.0f} / {P[:nb, 1].mean() / st:.0f} / "
              f"{P[:nb, 2].mean() / st:.0f}; left tile first pass "
              f"{P[:nb, 3].sum() / ntile.sum():.0f}, whole {P[:nb, 4].sum() / ntile.sum():.0f} "
              f"cycles ({ntile.sum()} tiles); right row first pass "
              f"{P[:nb, 6].sum() / nrow.sum():.0f}, whole {P[:nb, 7].sum() / nrow.sum():.0f} "
              f"cycles ({nrow.sum()} rows of warp 0)")


def build(root, kind):
    csrc = os.path.join(root, "periodicschurdecompositions_jl_torch", "csrc")
    name = {"cx": "sweep_cx", "rg": "sweep_rg"}.get(kind, "sweep")
    src = open(os.path.join(csrc, name + ".cu")).read()
    if kind == "cx":
        src, design = instrument_cx(src)
        src += BENCH_CX
    elif kind == "rg":
        src, design = instrument_rg(src)
        src += BENCH_RG
    else:
        design = "window"
        for old, new in EDITS:
            src = _replace_once(src, old, new, "csrc/sweep.cu")
        src += BENCH
    out = os.path.join(HERE, "_dev")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, name + "_prof.cu"), os.path.join(out, f"lib{name}_prof.so")
    open(cu, "w").write(src + READ)
    from periodicschurdecompositions_jl_torch.ops import _cuda
    subprocess.run([_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", csrc, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if kind == "cx":
        lib.psd_qz_sweep_generate.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
    elif kind == "rg":
        lib.psd_rg_sweep_generate.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
    else:
        lib.psd_sweep_generate.argtypes = [vp, vp, vp, i32, i32, i32, i32, f64, f64, f64, vp]
    lib.prof_bench.argtypes = [vp, i32]
    lib.prof_read.argtypes = [vp]
    return lib, design


def timed(fn):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def profile_real(lib, buf):
    from chip_smoke import mk_sweep_problem
    p, n = 16, 512
    N = n + 1
    Hn, _, v0 = mk_sweep_problem(p, n, np.random.default_rng(2024))
    H = torch.tensor(Hn, device="cuda")
    work = torch.empty((p, N, N), dtype=torch.float64, device="cuda")
    R = torch.empty((p, N, 9), dtype=torch.float64, device="cuda")
    for (m, i) in ((0, n - 1), (37, 300)):
        lib.prof_read(buf)
        ms = timed(lambda: lib.psd_sweep_generate(H.data_ptr(), work.data_ptr(), R.data_ptr(),
                                                  p, N, m, i, *map(float, v0), None))
        lib.prof_read(buf)
        K = (i - m) * p
        print(f"kernel A on [{m}, {i}] (instrumented) {ms:.3f} ms: lane 0's "
              f"generation {buf[0] / K:.0f} cycles per (step, factor), the whole (step, "
              f"factor) {buf[1] / K:.0f}, update phases {buf[2]} cycles in all")


def profile_cx(lib, design, buf):
    from chip_smoke import alternating, mk_cx_problem
    p, n = 8, 256
    Hn, _, csn = mk_cx_problem(p, n, np.random.default_rng(2025))
    H = torch.tensor(Hn, device="cuda")
    cs = torch.tensor(csn, device="cuda")
    Sd = torch.tensor([int(x) for x in alternating(p)], dtype=torch.int32, device="cuda")
    work = torch.empty((p, n, n), dtype=torch.complex128, device="cuda")  # either design's
    log = torch.empty((p, n, 16), dtype=torch.complex128, device="cuda")
    for (m, i) in ((0, n - 1), (37, 200)):
        def call():
            assert lib.psd_qz_sweep_generate(H.data_ptr(), work.data_ptr(), log.data_ptr(),
                                             cs.data_ptr(), Sd.data_ptr(), p, n, m, i,
                                             None) == 0
        call()  # warm-up
        lib.prof_read(buf)
        ms = timed(call)
        lib.prof_read(buf)
        K = (i - m) * p
        if design == "copy":
            other = buf[3] - buf[0] - buf[1] - buf[2]
            print(f"cx kernel A (working copy C) on [{m}, {i}] (instrumented) {ms:.3f} ms, "
                  f"{buf[3]} cycles; per (step, factor): thread 0's givens_cx "
                  f"{buf[0] / K:.0f} cycles, its row updates {buf[1] / K:.0f}, its waits at "
                  f"the block barriers {buf[2] / K:.0f}, the rest (band updates, log writes) "
                  f"{other / K:.0f}, in all {buf[3] / K:.0f}")
        else:
            print(f"cx kernel A (look-ahead windows) on [{m}, {i}] (instrumented) {ms:.3f} ms: "
                  f"per (step, factor) lane 0's givens_cx {buf[0] / K:.0f} cycles, the whole "
                  f"(step, factor) {buf[1] / K:.0f}; update phases {buf[2]} cycles in all")


def rg_opened(p, n, m, i, S, dev="cuda"):
    """rg_kernel_phase's state of chip_smoke.py: its problem (p, n,
    default_rng(2026)) with the window's boundaries deflated and the
    opening ladder applied; returns (H, Z) on the card."""
    from chip_smoke import mk_rg_problem
    from periodicschurdecompositions_jl_torch.ops import rgopen
    Hn, Zn, rotn = mk_rg_problem(p, n, np.random.default_rng(2026))
    H = torch.tensor(Hn, device=dev)
    if m > 1:
        H[0, m - 1, m - 2] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    Z = torch.tensor(Zn, device=dev)
    rgopen.rg_ladder_plain(H, Z, "open", m - 1, i, torch.tensor(rotn, device=dev), S,
                           want_z=True)
    return H, Z


def profile_rg(lib, design, buf):
    from chip_smoke import alternating
    p, n = 8, 256
    S = alternating(p)
    Sd = torch.tensor([int(x) for x in S], dtype=torch.int32, device="cuda")
    work = torch.empty((p, n, n), dtype=torch.float64, device="cuda")  # either design's
    log = torch.empty((p, n, 28), dtype=torch.float64, device="cuda")
    for (m, i) in ((1, n - 1), (38, 200)):
        H, _ = rg_opened(p, n, m, i, S)

        def call():
            assert lib.psd_rg_sweep_generate(H.data_ptr(), work.data_ptr(), log.data_ptr(),
                                             Sd.data_ptr(), p, n, m, i, None) == 0
        call()  # warm-up
        lib.prof_read(buf)
        ms = timed(call)
        lib.prof_read(buf)
        K = (i - 1 - m) * p
        if design == "copy":
            other = buf[5] - sum(buf[k] for k in range(5))
            print(f"rg A (working copy C) on [{m}, {i}] (instrumented) {ms:.3f} ms, "
                  f"{buf[5]} cycles; per (step, factor) on thread 0: first givens_r "
                  f"{buf[0] / K:.0f} cycles, second {buf[1] / K:.0f}, row updates "
                  f"{buf[2] / K:.0f}, band updates {buf[3] / K:.0f}, waits at the block "
                  f"barriers {buf[4] / K:.0f}, the rest (log writes, loop) {other / K:.0f}, "
                  f"in all {buf[5] / K:.0f}")
        else:
            steps = i - 1 - m
            ns = sum(1 for l in range(1, p) if S[l])
            print(f"rg A (look-ahead windows) on [{m}, {i}] (instrumented) {ms:.3f} ms: per "
                  f"(step, factor) lane 0's first givens_r {buf[0] / K:.0f} cycles, second "
                  f"{buf[1] / K:.0f}, the whole (step, factor) {buf[3] / K:.0f}; per step "
                  f"factor 0 {buf[4] / steps:.0f}, the ring close {buf[5] / steps:.0f}; per "
                  f"factor of S[l] = 1 {buf[6] / max(ns * steps, 1):.0f}, of S[l] = 0 "
                  f"{buf[7] / max((p - 1 - ns) * steps, 1):.0f}; update phases (the log and "
                  f"the deferred left rotations) {buf[2]} cycles in all")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cx", action="store_true")
    ap.add_argument("--rg", action="store_true")
    ap.add_argument("--hess", action="store_true")
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_sweep_generate: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    if args.hess:
        profile_hess(build_hess(os.path.abspath(args.root)))
        return 0
    kind = "cx" if args.cx else "rg" if args.rg else "real"
    lib, design = build(os.path.abspath(args.root), kind)
    print(f"sources: {os.path.abspath(args.root)} ({design} design)")
    out = torch.zeros(8, dtype=torch.float64, device="cuda")
    assert lib.prof_bench(out.data_ptr(), 2000) == 0
    torch.cuda.synchronize()
    if args.rg:
        print("latency, cycles: givens_r %.0f, two-row rotation %.0f, division %.0f, "
              "square root %.0f" % tuple(out[:4].tolist()))
    elif args.cx:
        print("latency, cycles: givens_cx %.0f, complex 2x2 row rotation %.0f, division %.0f, "
              "square root %.0f" % tuple(out[:4].tolist()))
    else:
        print("latency, cycles: fused generation %.0f, bulge reflector %.0f, division %.0f, "
              "square root %.0f, multiply-add %.0f" % tuple(out[:5].tolist()))
    buf = (ctypes.c_longlong * 8)()
    if args.rg:
        profile_rg(lib, design, buf)
    elif args.cx:
        profile_cx(lib, design, buf)
    else:
        profile_real(lib, buf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
