// The rotation ladders of the real generalized periodic QZ sweep, in float64.
//
// Replaces the Pallas kernel R of the JAX package's ops/pallas_rgopen.py
// (_make_rg_kernel, line 66; modes open / close / chain).  Semantics: the
// f64 glue of ops/pqz_real.py (reference src/rgeneralized.jl):
//   open  (mode 0): act_sweep's opening at j = ifirst (:890-943): the two
//                   opening rotations (c1, s1) on columns j, j+1 and (c2, s2)
//                   on columns j+1, j+2 of H[0] (rows clo..ilast), threaded
//                   through the factors 1..p-1, ending on the rows of H[0];
//   close (mode 1): the closing rotation at j = ilast-1 (:1015-1048), then
//                   chain510 from it;
//   chain (mode 2): chain510 (:510-540) from the given rotation (c1, s1).
// H, Z: (p, n, n) row-major float64 stacks; rot: (c1, s1, c2, s2) in device
// memory, written by the host; S: (p,) int signature (S[0] = 1).  rhi bounds
// the columns of row updates (n: unbounded), clo the rows of column updates
// (0: unbounded), the reference's window when want_t is False.
//
// What bounds it on the H100, and what the design does about it: a ladder
// is a serial chain of p Givens generations, each reading two entries the
// previous update wrote; the work between them is a 2-row or 2-column update
// of at most n entries.  It is bound by latency (launch, block barriers and
// dependent L2 reads), not by bytes or operations.  So it runs as ONE block
// and one launch per ladder: thread 0 generates each rotation and
// broadcasts it through shared memory; every 2-row or 2-column update is
// spread across the block's threads, with a barrier between dependent steps.
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

constexpr int kThreads = 256;

// rows k, k+1 of M, columns [lo, hi) <- lmat(c, s) = [[c, s], [-s, c]] rows
__device__ __forceinline__ void rows2(double* M, int n, int k, int lo, int hi,
                                      double c, double s) {
  double* r0 = M + (size_t)k * n;
  double* r1 = r0 + n;
  for (int col = max(lo, 0) + threadIdx.x; col < min(hi, n); col += blockDim.x) {
    const double x0 = r0[col], x1 = r1[col];
    r0[col] = c * x0 + s * x1;
    r1[col] = -s * x0 + c * x1;
  }
}

// columns k, k+1 of M, rows [lo, hi) <- cols @ rmat_adj(c, s) = [[c, -s], [s, c]]
__device__ __forceinline__ void cols2(double* M, int n, int k, int lo, int hi,
                                      double c, double s) {
  for (int r = max(lo, 0) + threadIdx.x; r < min(hi, n); r += blockDim.x) {
    double* row = M + (size_t)r * n + k;
    const double x0 = row[0], x1 = row[1];
    row[0] = x0 * c + x1 * s;
    row[1] = x0 * (-s) + x1 * c;
  }
}

__global__ void __launch_bounds__(kThreads)
rg_ladder_kernel(double* __restrict__ H, double* __restrict__ Z,
                 const double* __restrict__ rot, const int* __restrict__ S,
                 int p, int n, int mode, int j, int ilast, int rhi, int clo) {
  __shared__ double sh[4];
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;
  double* H0 = H;
  double c1, s1, c2, s2;

  if (mode == 0) {
    if (tid < 4) sh[tid] = rot[tid];
    __syncthreads();
    c1 = sh[0];
    s1 = sh[1];
    c2 = sh[2];
    s2 = sh[3];
    // H[0] columns j+1, j+2 then j, j+1 (rows clo..ilast); Z[1 % p] alike
    cols2(H0, n, j + 1, clo, ilast + 1, c2, s2);
    cols2(H0, n, j, clo, ilast + 1, c1, s1);
    if (Z) {
      double* Zl = Z + (size_t)(1 % p) * nn;
      cols2(Zl, n, j + 1, 0, n, c2, s2);
      cols2(Zl, n, j, 0, n, c1, s1);
    }
    __syncthreads();
    for (int l = 1; l < p; ++l) {
      double* Hl = H + (size_t)l * nn;
      if (S[l]) {
        rows2(Hl, n, j + 1, j, rhi, c2, s2);
        __syncthreads();
        if (tid == 0) {
          double c, s, r;
          psd::givens_r(Hl[(size_t)(j + 2) * n + j + 2],
                        -Hl[(size_t)(j + 2) * n + j + 1], c, s, r);
          Hl[(size_t)(j + 2) * n + j + 2] = r;
          Hl[(size_t)(j + 2) * n + j + 1] = 0.0;
          sh[2] = c;
          sh[3] = s;
        }
        __syncthreads();
        c2 = sh[2];
        s2 = sh[3];
        cols2(Hl, n, j + 1, clo, j + 2, c2, s2);
        __syncthreads();
        rows2(Hl, n, j, j, rhi, c1, s1);
        __syncthreads();
        if (tid == 0) {
          double c, s, r;
          psd::givens_r(Hl[(size_t)(j + 1) * n + j + 1],
                        -Hl[(size_t)(j + 1) * n + j], c, s, r);
          Hl[(size_t)(j + 1) * n + j + 1] = r;
          Hl[(size_t)(j + 1) * n + j] = 0.0;
          sh[0] = c;
          sh[1] = s;
        }
        __syncthreads();
        c1 = sh[0];
        s1 = sh[1];
        cols2(Hl, n, j, clo, j + 1, c1, s1);
      } else {
        cols2(Hl, n, j + 1, clo, j + 3, c2, s2);
        __syncthreads();
        if (tid == 0) {
          double c, s, r;
          psd::givens_r(Hl[(size_t)(j + 1) * n + j + 1],
                        Hl[(size_t)(j + 2) * n + j + 1], c, s, r);
          Hl[(size_t)(j + 1) * n + j + 1] = r;
          Hl[(size_t)(j + 2) * n + j + 1] = 0.0;
          sh[2] = c;
          sh[3] = s;
        }
        __syncthreads();
        c2 = sh[2];
        s2 = sh[3];
        rows2(Hl, n, j + 1, j + 2, rhi, c2, s2);
        __syncthreads();
        cols2(Hl, n, j, clo, j + 2, c1, s1);
        __syncthreads();
        if (tid == 0) {
          double c, s, r;
          psd::givens_r(Hl[(size_t)j * n + j], Hl[(size_t)(j + 1) * n + j], c,
                        s, r);
          Hl[(size_t)j * n + j] = r;
          Hl[(size_t)(j + 1) * n + j] = 0.0;
          sh[0] = c;
          sh[1] = s;
        }
        __syncthreads();
        c1 = sh[0];
        s1 = sh[1];
        rows2(Hl, n, j, j + 1, rhi, c1, s1);
      }
      if (Z) {
        double* Zl = Z + (size_t)((l + 1) % p) * nn;
        cols2(Zl, n, j + 1, 0, n, c2, s2);
        cols2(Zl, n, j, 0, n, c1, s1);
      }
      __syncthreads();
    }
    // rows j+1, j+2 then j, j+1 of H[0] (one thread per column does both)
    rows2(H0, n, j + 1, j, rhi, c2, s2);
    rows2(H0, n, j, j, rhi, c1, s1);
    return;
  }

  // ---- close / chain: chain510 at j -----------------------------------
  if (tid == 0) {
    if (mode == 1) {
      double r;
      psd::givens_r(H0[(size_t)j * n + j - 1], H0[(size_t)(j + 1) * n + j - 1],
                    c1, s1, r);
      H0[(size_t)j * n + j - 1] = r;
      H0[(size_t)(j + 1) * n + j - 1] = 0.0;
      sh[0] = c1;
      sh[1] = s1;
    } else {
      sh[0] = rot[0];
      sh[1] = rot[1];
    }
  }
  __syncthreads();
  c1 = sh[0];
  s1 = sh[1];
  rows2(H0, n, j, j, rhi, c1, s1);
  if (Z) cols2(Z, n, j, 0, n, c1, s1);
  __syncthreads();
  for (int l = p - 1; l >= 1; --l) {
    double* Hl = H + (size_t)l * nn;
    if (S[l]) {
      cols2(Hl, n, j, clo, j + 2, c1, s1);
      __syncthreads();
      if (tid == 0) {
        double c, s, r;
        psd::givens_r(Hl[(size_t)j * n + j], Hl[(size_t)(j + 1) * n + j], c, s,
                      r);
        Hl[(size_t)j * n + j] = r;
        Hl[(size_t)(j + 1) * n + j] = 0.0;
        sh[0] = c;
        sh[1] = s;
      }
      __syncthreads();
      c1 = sh[0];
      s1 = sh[1];
      rows2(Hl, n, j, j + 1, rhi, c1, s1);
    } else {
      rows2(Hl, n, j, j, rhi, c1, s1);
      __syncthreads();
      if (tid == 0) {
        double c, s, r;
        psd::givens_r(Hl[(size_t)(j + 1) * n + j + 1],
                      -Hl[(size_t)(j + 1) * n + j], c, s, r);
        Hl[(size_t)(j + 1) * n + j + 1] = r;
        Hl[(size_t)(j + 1) * n + j] = 0.0;
        sh[0] = c;
        sh[1] = s;
      }
      __syncthreads();
      c1 = sh[0];
      s1 = sh[1];
      cols2(Hl, n, j, clo, j + 1, c1, s1);
    }
    if (Z) cols2(Z + (size_t)l * nn, n, j, 0, n, c1, s1);
    __syncthreads();
  }
  cols2(H0, n, j, clo, n, c1, s1);
}

}  // namespace

extern "C" {

// Kernel R, in place on H and (when Z != NULL) Z.
int psd_rg_ladder(void* H, void* Z, const void* rot, const int* S, int p, int n,
                  int mode, int j, int ilast, int rhi, int clo, void* stream) {
  rg_ladder_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (double*)H, (double*)Z, (const double*)rot, S, p, n, mode, j, ilast, rhi,
      clo);
  return (int)cudaGetLastError();
}

}  // extern "C"
