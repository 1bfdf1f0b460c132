// The double-shift chase of the real generalized periodic QZ core, float64.
//
// Replaces the Pallas kernels of the JAX package's ops/pallas_sweep_rg.py:
//   rg_sweep_generate <- _make_rg_sweep_kernel (rg A, line 182)
//   rg_sweep_left     <- _make_rg_left_kernel  (rg B0, line 372)
//   rg_sweep_right    <- _make_rg_apply_kernel (rg B, line 409, with and
//                        without Z)
// Semantics: act_sweep's chase_step of ops/pqz_real.py (reference
// src/rgeneralized.jl:953-1014), steps j = m..i-2, on (p, n, n) row-major
// float64 stacks H and Z with a runtime int signature S (S[0] = 1).  The
// opening has left the bulge in column m-1 of H[0], rows m..m+2; the chase
// leaves the closing bulge H[0][i, i-2] for the closing ladder.
//
// Log layout, 28 float64 per (factor l, step j) at Lg[(l*n + j)*28]:
//   [0..8]   L:  the fused left 3x3 on rows j..j+2 of H[l] (row-major),
//                E1(c1, s1) E2(c2, s2);
//   [9..17]  R:  the fused right 3x3 on columns j..j+2 of H[l],
//                R2e(c2, s2) R1e(c1, s1);
//   [18..26] ZR: the fused right 3x3 on columns j..j+2 of Z[l] (the
//                factor's own pair);
//   [27]     r:  factor 0 only, the regenerated H[0][j, j-1].
//
// What bounds each kernel on the H100, and what the design does about it:
// * rg_sweep_generate is a serial latency chain of (i-1-m)*p steps of two
//   Givens generations each, every one reading entries the previous one
//   wrote.  It runs in ONE block: thread 0 generates (and applies the
//   column updates on the few band rows that later generations read), and
//   all threads apply each left rotation to two rows of a working copy C of
//   H across the columns to the right.  C lives in global memory,
//   L2-resident at p=8 n=256 (4.2 MB).  Four block barriers per (factor,
//   step).
// * rg_sweep_left / rg_sweep_right apply the logged 3x3 transforms with full
//   parallelism (one thread per (factor, column) or (factor, row), each
//   walking all steps with two live entries in registers).  They are bound
//   by memory traffic over p n^2 float64.  Deferring the left and right
//   products past the generation is exact (left and right multiplications
//   commute) provided every transform acts on the FULL rows and columns:
//   the interleaved order's bounds skip entries that are zero only in that
//   order.  Columns left of m-1 are never touched.  rg_sweep_right then
//   writes the window's structural zeros exactly, keeping the closing bulge
//   H[0][i, i-2], and the regenerated H[0][j, j-1] = r from the log.
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

constexpr int kGenThreads = 256;
constexpr int kApplyThreads = 128;
constexpr int kLog = 28;

// E1(c1, s1) E2(c2, s2), row-major
__device__ __forceinline__ void put_fuse_left(double* E, double c1, double s1,
                                              double c2, double s2) {
  E[0] = c1;
  E[1] = s1 * c2;
  E[2] = s1 * s2;
  E[3] = -s1;
  E[4] = c1 * c2;
  E[5] = c1 * s2;
  E[6] = 0.0;
  E[7] = -s2;
  E[8] = c2;
}

// R2e(c2, s2) R1e(c1, s1), row-major
__device__ __forceinline__ void put_fuse_right(double* E, double c1, double s1,
                                               double c2, double s2) {
  E[0] = c1;
  E[1] = -s1;
  E[2] = 0.0;
  E[3] = c2 * s1;
  E[4] = c2 * c1;
  E[5] = -s2;
  E[6] = s2 * s1;
  E[7] = s2 * c1;
  E[8] = c2;
}

// rows k, k+1 of one factor of C, columns c0..n-1 <- lmat(c, s) rows
__device__ __forceinline__ void rows_left(double* Cl, int n, int k, int c0,
                                          double c, double s) {
  double* r0 = Cl + (size_t)k * n;
  for (int col = c0 + threadIdx.x; col < n; col += blockDim.x) {
    const double x0 = r0[col], x1 = r0[col + n];
    r0[col] = c * x0 + s * x1;
    r0[col + n] = -s * x0 + c * x1;
  }
}

// rows r0..r1 of one factor of C, columns k, k+1 <- (...) rmat_adj(c, s)
// (thread 0)
__device__ __forceinline__ void band_right(double* Cl, int n, int k, int r0,
                                           int r1, double c, double s) {
  for (int r = r0; r <= r1; ++r) {
    double* row = Cl + (size_t)r * n + k;
    const double x0 = row[0], x1 = row[1];
    row[0] = x0 * c + x1 * s;
    row[1] = x0 * (-s) + x1 * c;
  }
}

__device__ __forceinline__ double& at(double* Cl, int n, int r, int c) {
  return Cl[(size_t)r * n + c];
}

__global__ void __launch_bounds__(kGenThreads)
rg_generate_kernel(double* __restrict__ C, double* __restrict__ Lg,
                   const int* __restrict__ S, int p, int n, int m, int i) {
  __shared__ double sh[4];  // c1, s1, c2, s2
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;

  for (int j = m; j <= i - 2; ++j) {
    // ---- factor 0: the two bulge rotations from column j-1 ---------------
    if (tid == 0) {
      double c1, s1, c2, s2, r1, r2;
      psd::givens_r(at(C, n, j + 1, j - 1), at(C, n, j + 2, j - 1), c2, s2, r2);
      psd::givens_r(at(C, n, j, j - 1), r2, c1, s1, r1);
      at(C, n, j, j - 1) = r1;
      at(C, n, j + 1, j - 1) = 0.0;
      at(C, n, j + 2, j - 1) = 0.0;
      double* E = Lg + (size_t)j * kLog;
      put_fuse_left(E, c1, s1, c2, s2);
      put_fuse_right(E + 18, c1, s1, c2, s2);
      E[27] = r1;
      sh[0] = c1;
      sh[1] = s1;
      sh[2] = c2;
      sh[3] = s2;
    }
    __syncthreads();
    double c1 = sh[0], s1 = sh[1], c2 = sh[2], s2 = sh[3];
    // rows j+1, j+2 then j, j+1 of C[0], columns j..n-1
    for (int col = j + tid; col < n; col += blockDim.x) {
      double* x = C + (size_t)j * n + col;
      const double x0 = x[0], x1 = x[n], x2 = x[2 * n];
      const double y1 = c2 * x1 + s2 * x2;
      x[2 * n] = -s2 * x1 + c2 * x2;
      x[0] = c1 * x0 + s1 * y1;
      x[n] = -s1 * x0 + c1 * y1;
    }
    __syncthreads();

    // ---- factors p-1..1 ----------------------------------------------------
    for (int l = p - 1; l >= 1; --l) {
      double* Cl = C + (size_t)l * nn;
      double* E = Lg + ((size_t)l * n + j) * kLog;
      if (S[l]) {
        // incoming rights, then regenerate from the new columns
        if (tid == 0) {
          put_fuse_right(E + 9, c1, s1, c2, s2);
          band_right(Cl, n, j + 1, j, j + 2, c2, s2);
          double c, s, r;
          psd::givens_r(at(Cl, n, j + 1, j + 1), at(Cl, n, j + 2, j + 1), c, s, r);
          at(Cl, n, j + 1, j + 1) = r;
          at(Cl, n, j + 2, j + 1) = 0.0;
          sh[2] = c;
          sh[3] = s;
        }
        __syncthreads();
        const double c2n = sh[2], s2n = sh[3];
        rows_left(Cl, n, j + 1, j + 2, c2n, s2n);
        __syncthreads();
        if (tid == 0) {
          band_right(Cl, n, j, j, j + 1, c1, s1);
          double c, s, r;
          psd::givens_r(at(Cl, n, j, j), at(Cl, n, j + 1, j), c, s, r);
          at(Cl, n, j, j) = r;
          at(Cl, n, j + 1, j) = 0.0;
          sh[0] = c;
          sh[1] = s;
        }
        __syncthreads();
        const double c1n = sh[0], s1n = sh[1];
        rows_left(Cl, n, j, j + 1, c1n, s1n);
        if (tid == 0) {
          put_fuse_left(E, c1n, s1n, c2n, s2n);
          put_fuse_right(E + 18, c1n, s1n, c2n, s2n);
        }
        __syncthreads();
        c1 = c1n;
        s1 = s1n;
        c2 = c2n;
        s2 = s2n;
      } else {
        // incoming lefts, then regenerate from the new rows
        rows_left(Cl, n, j + 1, j, c2, s2);
        __syncthreads();
        if (tid == 0) {
          put_fuse_left(E, c1, s1, c2, s2);
          double c, s, r;
          psd::givens_r(at(Cl, n, j + 2, j + 2), -at(Cl, n, j + 2, j + 1), c, s, r);
          at(Cl, n, j + 2, j + 1) = 0.0;
          at(Cl, n, j + 2, j + 2) = r;
          band_right(Cl, n, j + 1, j, j + 1, c, s);
          sh[2] = c;
          sh[3] = s;
        }
        __syncthreads();
        const double c2n = sh[2], s2n = sh[3];
        rows_left(Cl, n, j, j, c1, s1);
        __syncthreads();
        if (tid == 0) {
          double c, s, r;
          psd::givens_r(at(Cl, n, j + 1, j + 1), -at(Cl, n, j + 1, j), c, s, r);
          at(Cl, n, j + 1, j) = 0.0;
          at(Cl, n, j + 1, j + 1) = r;
          band_right(Cl, n, j, j, j, c, s);
          put_fuse_right(E + 9, c, s, c2n, s2n);
          put_fuse_right(E + 18, c, s, c2n, s2n);
          sh[0] = c;
          sh[1] = s;
        }
        __syncthreads();
        c1 = sh[0];
        s1 = sh[1];
        c2 = c2n;
        s2 = s2n;
      }
    }

    // ---- ring close on factor 0: columns j+1, j+2 then j, j+1 ------------
    if (tid == 0) {
      const int r1 = min(j + 3, n - 1);
      band_right(C, n, j + 1, j, r1, c2, s2);
      band_right(C, n, j, j, r1, c1, s1);
      put_fuse_right(Lg + (size_t)j * kLog + 9, c1, s1, c2, s2);
    }
    __syncthreads();
  }
}

// B0: rows j..j+2 of every H[f] <- L[f, j] rows, for j = m..i-2.  One thread
// per (factor, column >= m-1).
__global__ void __launch_bounds__(kApplyThreads)
rg_left_kernel(double* __restrict__ H, const double* __restrict__ Lg, int n,
               int m, int i) {
  const int f = blockIdx.y;
  const int c = m - 1 + blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  double* col = H + (size_t)f * n * n + c;
  const double* Ef = Lg + (size_t)f * n * kLog;
  double x0 = col[(size_t)m * n], x1 = col[(size_t)(m + 1) * n];
  for (int j = m; j <= i - 2; ++j) {
    const double x2 = col[(size_t)(j + 2) * n];
    const double* E = Ef + (size_t)j * kLog;
    double M[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) M[q] = __ldg(E + q);
    const double y0 = M[0] * x0 + M[1] * x1 + M[2] * x2;
    const double y1 = M[3] * x0 + M[4] * x1 + M[5] * x2;
    const double y2 = M[6] * x0 + M[7] * x1 + M[8] * x2;
    col[(size_t)j * n] = y0;
    x0 = y1;
    x1 = y2;
  }
  col[(size_t)(i - 1) * n] = x0;
  col[(size_t)i * n] = x1;
}

// B: columns j..j+2 <- columns M for j = m..i-2.  blockIdx.z == 0: H[g]
// rows 0..i with R[g, j], then (rows m..i) the structural zeros, keeping
// the closing bulge H[0][i, i-2], and the regenerated H[0][j, j-1], written
// exactly; blockIdx.z == 1: Z[g], all rows, with ZR[g, j].
__global__ void __launch_bounds__(kApplyThreads)
rg_right_kernel(double* __restrict__ H, double* __restrict__ Z,
                const double* __restrict__ Lg, int n, int m, int i) {
  const int g = blockIdx.y;
  const bool isz = blockIdx.z == 1;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int nrows = isz ? n : i + 1;
  if (r >= nrows) return;
  double* row = (isz ? Z : H) + (size_t)g * n * n + (size_t)r * n;
  const double* Eg = Lg + (size_t)g * n * kLog + (isz ? 18 : 9);
  double x0 = row[m], x1 = row[m + 1];
  for (int j = m; j <= i - 2; ++j) {
    const double x2 = row[j + 2];
    const double* E = Eg + (size_t)j * kLog;
    double M[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) M[q] = __ldg(E + q);
    const double y0 = x0 * M[0] + x1 * M[3] + x2 * M[6];
    const double y1 = x0 * M[1] + x1 * M[4] + x2 * M[7];
    const double y2 = x0 * M[2] + x1 * M[5] + x2 * M[8];
    row[j] = y0;
    x0 = y1;
    x1 = y2;
  }
  row[i - 1] = x0;
  row[i] = x1;
  if (!isz && r >= m) {
    if (g == 0) {
      const int hi = (r < i) ? r - 1 : i - 2;  // (i, i-2) is the closing bulge
      for (int c = m - 1; c < hi; ++c) row[c] = 0.0;
      if (r <= i - 2) row[r - 1] = __ldg(Lg + (size_t)r * kLog + 27);
    } else {
      for (int c = m - 1; c < r; ++c) row[c] = 0.0;
    }
  }
}

}  // namespace

extern "C" {

// Kernel rg A.  H: (p, n, n) input (read only); C: (p, n, n) scratch working
// copy; Lg: (p, n, 28) output log; S: (p,) int signature on the device.
int psd_rg_sweep_generate(const void* H, void* C, void* Lg, const int* S, int p,
                          int n, int m, int i, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t pitch = (size_t)n * n * sizeof(double);
  const int r1 = min(i + 1, n - 1);  // rows m..i+1: what the chain reads
  cudaError_t e = cudaMemcpy2DAsync(
      (double*)C + (size_t)m * n, pitch, (const double*)H + (size_t)m * n, pitch,
      (size_t)(r1 + 1 - m) * n * sizeof(double), p, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  rg_generate_kernel<<<1, kGenThreads, 0, st>>>((double*)C, (double*)Lg, S, p, n,
                                                m, i);
  return (int)cudaGetLastError();
}

// Kernel rg B0, in place on H.
int psd_rg_sweep_left(void* H, const void* Lg, int p, int n, int m, int i,
                      void* stream) {
  dim3 grid((n - m + 1 + kApplyThreads - 1) / kApplyThreads, p);
  rg_left_kernel<<<grid, kApplyThreads, 0, (cudaStream_t)stream>>>(
      (double*)H, (const double*)Lg, n, m, i);
  return (int)cudaGetLastError();
}

// Kernel rg B, in place on H and (when Z != NULL) Z.
int psd_rg_sweep_right(void* H, void* Z, const void* Lg, int p, int n, int m,
                       int i, void* stream) {
  dim3 grid((n + kApplyThreads - 1) / kApplyThreads, p, Z ? 2 : 1);
  rg_right_kernel<<<grid, kApplyThreads, 0, (cudaStream_t)stream>>>(
      (double*)H, (double*)Z, (const double*)Lg, n, m, i);
  return (int)cudaGetLastError();
}

}  // extern "C"
