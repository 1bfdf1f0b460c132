#!/usr/bin/env python3
"""Where kernel A's time goes, on one CUDA card.

Builds an instrumented copy of csrc/sweep.cu under ``_dev/`` (clock64
counters in kernel A: lane 0's generation per (step, factor), the whole
(step, factor) of the serial phase, and the update phases) with a few
latency microbenchmarks appended (one thread: a chain of the fused
two-reflector generation, of the bulge reflector, of float64 divisions,
square roots and multiply-adds), then runs kernel A on chip_smoke.py's
sweep problem (p=16, n=512, windows [0, 511] and [37, 300]) and prints
cycles.  The counters cost a few percent of the kernel's time.

Run from the repository root:  python3 scripts/profile_sweep_generate.py
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "periodicschurdecompositions_jl_torch", "csrc")

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


def build():
    src = open(os.path.join(CSRC, "sweep.cu")).read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/sweep.cu changed; instrument by hand:\n{old}")
        src = src.replace(old, new)
    out = os.path.join(ROOT, "_dev")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "sweep_prof.cu"), os.path.join(out, "libsweep_prof.so")
    open(cu, "w").write(src + BENCH)
    from periodicschurdecompositions_jl_torch.ops import _cuda
    subprocess.run([_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", CSRC, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.psd_sweep_generate.argtypes = [vp, vp, vp, i32, i32, i32, i32, f64, f64, f64, vp]
    lib.prof_bench.argtypes = [vp, i32]
    lib.prof_read.argtypes = [vp]
    return lib


def main():
    if not torch.cuda.is_available():
        print("profile_sweep_generate: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import mk_sweep_problem
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    lib = build()
    out = torch.zeros(8, dtype=torch.float64, device="cuda")
    assert lib.prof_bench(out.data_ptr(), 2000) == 0
    torch.cuda.synchronize()
    print("latency, cycles: fused generation %.0f, bulge reflector %.0f, division %.0f, "
          "square root %.0f, multiply-add %.0f" % tuple(out[:5].tolist()))
    buf = (ctypes.c_longlong * 8)()
    p, n = 16, 512
    N = n + 1
    Hn, _, v0 = mk_sweep_problem(p, n, np.random.default_rng(2024))
    H = torch.tensor(Hn, device="cuda")
    work = torch.empty((p, N, N), dtype=torch.float64, device="cuda")
    R = torch.empty((p, N, 9), dtype=torch.float64, device="cuda")
    for (m, i) in ((0, n - 1), (37, 300)):
        lib.prof_read(buf)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        assert lib.psd_sweep_generate(H.data_ptr(), work.data_ptr(), R.data_ptr(), p, N, m, i,
                                      *map(float, v0), None) == 0
        e1.record()
        torch.cuda.synchronize()
        lib.prof_read(buf)
        K = (i - m) * p
        print(f"kernel A on [{m}, {i}] (instrumented) {e0.elapsed_time(e1):.3f} ms: lane 0's "
              f"generation {buf[0] / K:.0f} cycles per (step, factor), the whole (step, "
              f"factor) {buf[1] / K:.0f}, update phases {buf[2]} cycles in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
