// Single-shift complex periodic QZ sweep and its shift chain, in complex128.
//
// Replaces the Pallas kernels of the JAX package's ops/pallas_sweep_cx.py:
//   qz_sweep_generate  <- _make_qz_sweep_kernel (kernel A, line 295)
//   qz_sweep_left      <- _make_qz_left_kernel  (kernel B0, line 507)
//   qz_sweep_right     <- _make_qz_apply_kernel (kernel B, line 549, with and
//                         without Z)
//   qz_shift           <- _make_shift_kernel    (kernel S, line 771)
// Semantics: act_sweep of ops/pqz_complex.py (reference
// src/generalized.jl:763-852) on (p, n, n) row-major complex128 stacks H
// and Z (torch's (re, im) interleaving, read as double2), window
// k = m..i-1, signature S a runtime int array (S[0] = 1).
//
// Log layout, 16 complex128 per (factor l, step k) at Lg[(l*n + k)*16]:
//   [0..3]  L:  the left 2x2 on rows k, k+1 of H[l] (row-major);
//   [4..7]  R:  the right 2x2 on columns k, k+1 of H[l];
//   [8..11] ZR: the right 2x2 on columns k, k+1 of Z[l];
//   [12]    r:  factor 0 only, the regenerated H[0][k, k-1] (k > m).
//
// What bounds each kernel on the H100, and what the design does about it:
// * qz_sweep_generate is a serial latency chain of (i-m)*p Givens
//   generations, each reading entries the previous one wrote.  It runs in
//   ONE block: thread 0 generates (and applies the 2x2 band updates that
//   later generations read), then all threads apply the left rotation to
//   the two rows of a working copy C of H across the columns to the right.
//   C lives in global memory, L2-resident at p=8 n=256 (8.4 MB).  Two block
//   barriers per (factor, step); nothing leaves the chip between kernel S
//   and this kernel: the shift rotation is read from a device buffer.
// * qz_sweep_left / qz_sweep_right apply the logged rotations with full
//   parallelism (one thread per (factor, column) or (factor, row), each
//   walking all steps with one live entry in a register).  They are bound
//   by memory traffic over p n^2 complex128.  Deferring the left and right
//   products past the generation is exact (left and right multiplications
//   commute) provided every rotation acts on the FULL rows and columns: the
//   interleaved order's bounds skip entries that are zero only in that
//   order.  The column m-1 of H[0] (the window's boundary subdiagonal) is
//   never touched.  qz_sweep_right writes the structural zeros exactly and
//   the regenerated subdiagonal entries H[0][k, k-1] = r from the log.
// * qz_shift is a chain of p Givens generations on a few scalars: one
//   thread, bound by launch latency.
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

using psd::cadd;
using psd::cconj;
using psd::cmul;
using psd::cneg;
using psd::rmul;

constexpr int kGenThreads = 256;
constexpr int kApplyThreads = 128;
constexpr int kLog = 16;

__device__ __forceinline__ double2 czero() { return make_double2(0.0, 0.0); }

// lmat(c, s) = [[c, s], [-conj(s), c]], row-major
__device__ __forceinline__ void put_lmat(double2* E, double c, double2 s) {
  E[0] = make_double2(c, 0.0);
  E[1] = s;
  E[2] = cneg(cconj(s));
  E[3] = make_double2(c, 0.0);
}

// rmat_adj(c, s) = [[c, -s], [conj(s), c]], row-major
__device__ __forceinline__ void put_rmat_adj(double2* E, double c, double2 s) {
  E[0] = make_double2(c, 0.0);
  E[1] = cneg(s);
  E[2] = cconj(s);
  E[3] = make_double2(c, 0.0);
}

// (x0, x1) <- M (x0, x1)^T for a row-major 2x2 M
__device__ __forceinline__ void left2(const double2* M, double2& x0,
                                      double2& x1) {
  const double2 y0 = cadd(cmul(M[0], x0), cmul(M[1], x1));
  const double2 y1 = cadd(cmul(M[2], x0), cmul(M[3], x1));
  x0 = y0;
  x1 = y1;
}

// (x0, x1) <- (x0, x1) M for a row-major 2x2 M
__device__ __forceinline__ void right2(const double2* M, double2& x0,
                                       double2& x1) {
  const double2 y0 = cadd(cmul(x0, M[0]), cmul(x1, M[2]));
  const double2 y1 = cadd(cmul(x0, M[1]), cmul(x1, M[3]));
  x0 = y0;
  x1 = y1;
}

// rows k, k+1 of one factor of C, columns c0..n-1 <- lmat(c, s) rows
__device__ __forceinline__ void rows_left(double2* Cl, int n, int k, int c0,
                                          double c, double2 s) {
  double2 M[4];
  put_lmat(M, c, s);
  double2* r0 = Cl + (size_t)k * n;
  for (int col = c0 + threadIdx.x; col < n; col += blockDim.x) {
    double2 x0 = r0[col], x1 = r0[col + n];
    left2(M, x0, x1);
    r0[col] = x0;
    r0[col + n] = x1;
  }
}

// rows r0..r1 of one factor of C, columns k, k+1 <- (...) M  (thread 0)
__device__ __forceinline__ void band_right(double2* Cl, int n, int k, int r0,
                                           int r1, const double2* M) {
  for (int r = r0; r <= r1; ++r) {
    double2* row = Cl + (size_t)r * n + k;
    double2 x0 = row[0], x1 = row[1];
    right2(M, x0, x1);
    row[0] = x0;
    row[1] = x1;
  }
}

__global__ void __launch_bounds__(kGenThreads)
qz_generate_kernel(double2* __restrict__ C, double2* __restrict__ Lg,
                   const double2* __restrict__ cs, const int* __restrict__ S,
                   int p, int n, int m, int i) {
  __shared__ double sh_c;
  __shared__ double2 sh_s;
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;

  for (int k = m; k < i; ++k) {
    // ---- factor 0: the shift rotation (k == m) or regeneration ----------
    if (tid == 0) {
      double2* E = Lg + ((size_t)k) * kLog;
      double c;
      double2 s, r;
      if (k == m) {
        c = cs[0].x;
        s = cs[1];
        r = czero();
      } else {
        psd::givens_cx(C[(size_t)k * n + k - 1], C[(size_t)(k + 1) * n + k - 1],
                       c, s, r);
        C[(size_t)k * n + k - 1] = r;
        C[(size_t)(k + 1) * n + k - 1] = czero();
      }
      put_lmat(E, c, s);
      put_rmat_adj(E + 8, c, s);
      E[12] = r;
      sh_c = c;
      sh_s = s;
    }
    __syncthreads();
    rows_left(C, n, k, k, sh_c, sh_s);
    __syncthreads();

    // ---- factors p-1..1 ---------------------------------------------------
    for (int l = p - 1; l >= 1; --l) {
      double2* Cl = C + (size_t)l * nn;
      double2* E = Lg + ((size_t)l * n + k) * kLog;
      if (S[l]) {
        if (tid == 0) {
          // incoming right rotation on columns k, k+1 (band rows k, k+1),
          // then re-triangularize column k
          put_rmat_adj(E + 4, sh_c, sh_s);
          band_right(Cl, n, k, k, k + 1, E + 4);
          double cn;
          double2 sn, r;
          psd::givens_cx(Cl[(size_t)k * n + k], Cl[(size_t)(k + 1) * n + k],
                         cn, sn, r);
          Cl[(size_t)k * n + k] = r;
          Cl[(size_t)(k + 1) * n + k] = czero();
          put_lmat(E, cn, sn);
          put_rmat_adj(E + 8, cn, sn);
          sh_c = cn;
          sh_s = sn;
        }
        __syncthreads();
        rows_left(Cl, n, k, k + 1, sh_c, sh_s);
        __syncthreads();
      } else {
        // incoming rotation from the left, then re-triangularize row k+1
        rows_left(Cl, n, k, k, sh_c, sh_s);
        __syncthreads();
        if (tid == 0) {
          put_lmat(E, sh_c, sh_s);
          double cn;
          double2 sn, r;
          psd::givens_cx(Cl[(size_t)(k + 1) * n + k + 1],
                         Cl[(size_t)(k + 1) * n + k], cn, sn, r);
          Cl[(size_t)(k + 1) * n + k] = czero();
          Cl[(size_t)(k + 1) * n + k + 1] = r;
          put_lmat(E + 4, cn, sn);
          band_right(Cl, n, k, k, k, E + 4);
          const double2 sneg = cneg(sn);
          put_rmat_adj(E + 8, cn, sneg);
          sh_c = cn;
          sh_s = sneg;
        }
        __syncthreads();
      }
    }

    // ---- ring close on factor 0: columns k, k+1, band rows k..k+2 --------
    if (tid == 0) {
      double2* E = Lg + ((size_t)k) * kLog;
      put_rmat_adj(E + 4, sh_c, sh_s);
      band_right(C, n, k, k, min(k + 2, n - 1), E + 4);
    }
    __syncthreads();
  }
}

// B0: rows k, k+1 of every H[f] <- L[f, k] rows, for k = m..i-1.  One thread
// per (factor, column >= m); column m-1 (the boundary subdiagonal of H[0])
// is never touched.
__global__ void __launch_bounds__(kApplyThreads)
qz_left_kernel(double2* __restrict__ H, const double2* __restrict__ Lg, int n,
               int m, int i) {
  const int f = blockIdx.y;
  const int c = m + blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  double2* col = H + (size_t)f * n * n + c;
  const double2* Ef = Lg + (size_t)f * n * kLog;
  double2 x0 = col[(size_t)m * n];
  for (int k = m; k < i; ++k) {
    double2 x1 = col[(size_t)(k + 1) * n];
    const double2* E = Ef + (size_t)k * kLog;
    double2 M[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) M[q] = __ldg(E + q);
    left2(M, x0, x1);
    col[(size_t)k * n] = x0;
    x0 = x1;
  }
  col[(size_t)i * n] = x0;
}

// B: columns k, k+1 <- columns M for k = m..i-1.  blockIdx.z == 0: H[g]
// rows 0..i with R[g, k], then (rows m+1..i) the structural zeros and the
// regenerated subdiagonal of H[0], written exactly; blockIdx.z == 1: Z[g],
// all rows, with ZR[g, k].
__global__ void __launch_bounds__(kApplyThreads)
qz_right_kernel(double2* __restrict__ H, double2* __restrict__ Z,
                const double2* __restrict__ Lg, int n, int m, int i) {
  const int g = blockIdx.y;
  const bool isz = blockIdx.z == 1;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int nrows = isz ? n : i + 1;
  if (r >= nrows) return;
  double2* row = (isz ? Z : H) + (size_t)g * n * n + (size_t)r * n;
  const double2* Eg = Lg + (size_t)g * n * kLog + (isz ? 8 : 4);
  double2 x0 = row[m];
  for (int k = m; k < i; ++k) {
    double2 x1 = row[k + 1];
    const double2* E = Eg + (size_t)k * kLog;
    double2 M[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) M[q] = __ldg(E + q);
    right2(M, x0, x1);
    row[k] = x0;
    x0 = x1;
  }
  row[i] = x0;
  if (!isz && r > m) {
    if (g == 0) {
      for (int c = m; c < r - 1; ++c) row[c] = czero();
      if (r < i) row[r - 1] = __ldg(Lg + (size_t)r * kLog + 12);
    } else {
      for (int c = m; c < r; ++c) row[c] = czero();
    }
  }
}

// S: the shift rotation of one sweep (act_sweep's chain): Givens through
// factors p-1..1 following S, then the closing Givens on H[0].
__global__ void qz_shift_kernel(const double2* __restrict__ H,
                                double2* __restrict__ cs,
                                const int* __restrict__ S, int p, int n,
                                int ifirst, int ilast) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const size_t nn = (size_t)n * n;
  const double2 one = make_double2(1.0, 0.0);
  double c;
  double2 s, r;
  psd::givens_cx(one, one, c, s, r);
  for (int l = p - 1; l >= 1; --l) {
    const double2 hf = H[l * nn + (size_t)ifirst * n + ifirst];
    const double2 hl = H[l * nn + (size_t)ilast * n + ilast];
    if (S[l]) {
      psd::givens_cx(rmul(c, hf), cmul(hl, cconj(s)), c, s, r);
    } else {
      psd::givens_cx(rmul(c, hl), cneg(cmul(hf, cconj(s))), c, s, r);
      s = cneg(s);
    }
  }
  const double2 h0f = H[(size_t)ifirst * n + ifirst];
  const double2 h0l = H[(size_t)ilast * n + ilast];
  const double2 h0sub = H[(size_t)(ifirst + 1) * n + ifirst];
  const double2 t = cmul(h0l, cconj(s));
  psd::givens_cx(make_double2(c * h0f.x - t.x, c * h0f.y - t.y), rmul(c, h0sub),
                 c, s, r);
  cs[0] = make_double2(c, 0.0);
  cs[1] = s;
}

}  // namespace

extern "C" {

// Kernel A.  H: (p, n, n) input (read only); C: (p, n, n) scratch working
// copy; Lg: (p, n, 16) output log; cs: the shift rotation (c, s) on the
// device; S: (p,) int signature on the device.
int psd_qz_sweep_generate(const void* H, void* C, void* Lg, const void* cs,
                          const int* S, int p, int n, int m, int i,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t pitch = (size_t)n * n * sizeof(double2);
  const int r1 = min(i + 1, n - 1);  // rows m..i+1: what the chain reads
  cudaError_t e = cudaMemcpy2DAsync(
      (double2*)C + (size_t)m * n, pitch, (const double2*)H + (size_t)m * n,
      pitch, (size_t)(r1 + 1 - m) * n * sizeof(double2), p,
      cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  qz_generate_kernel<<<1, kGenThreads, 0, st>>>(
      (double2*)C, (double2*)Lg, (const double2*)cs, S, p, n, m, i);
  return (int)cudaGetLastError();
}

// Kernel B0, in place on H.
int psd_qz_sweep_left(void* H, const void* Lg, int p, int n, int m, int i,
                      void* stream) {
  dim3 grid((n - m + kApplyThreads - 1) / kApplyThreads, p);
  qz_left_kernel<<<grid, kApplyThreads, 0, (cudaStream_t)stream>>>(
      (double2*)H, (const double2*)Lg, n, m, i);
  return (int)cudaGetLastError();
}

// Kernel B, in place on H and (when Z != NULL) Z.
int psd_qz_sweep_right(void* H, void* Z, const void* Lg, int p, int n, int m,
                       int i, void* stream) {
  dim3 grid((n + kApplyThreads - 1) / kApplyThreads, p, Z ? 2 : 1);
  qz_right_kernel<<<grid, kApplyThreads, 0, (cudaStream_t)stream>>>(
      (double2*)H, (double2*)Z, (const double2*)Lg, n, m, i);
  return (int)cudaGetLastError();
}

// Kernel S: writes (c, s) of the sweep's shift rotation to cs[0..1].
int psd_qz_shift(const void* H, void* cs, const int* S, int p, int n,
                 int ifirst, int ilast, void* stream) {
  qz_shift_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const double2*)H, (double2*)cs, S, p, n, ifirst, ilast);
  return (int)cudaGetLastError();
}

}  // extern "C"
