// Periodic Hessenberg-triangular reduction (MB03VD column sweep), float64.
//
// Replaces the Pallas kernel _make_hess_kernel of the JAX package's
// ops/pallas_hess.py (the whole ds reduction in one launch, H and Q^T
// resident in VMEM).  Semantics: phessenberg_core of ops/hessenberg.py
// (reference src/PeriodicSchurDecompositions.jl:199-259) on the (p, n, n)
// row-major stacks A (in place: it becomes H) and Q (the identity on entry):
//   Q[j]^T A[j] Q[(j+1) % p] = H[j],  H[0] Hessenberg, H[1..p-1] triangular.
//
// The reduction is a chain of p (n-1) stages.  Stage (i, j), for columns
// i = 0..n-2 and factors j = p-1..1, then 0: a Householder reflector from
// column i of A[j] on the window rows lo..n-1 (lo = i for j >= 1, i + 1 for
// j == 0), applied from the left to A[j], from the right to A[j-1] (A[p-1]
// for j == 0) and to Q[j].  Each stage reads what the one before wrote.
//
// Design: psd_hess_reduce, a host function, loops over the stages and
// enqueues two kernels per stage on the caller's stream (one ctypes call per
// reduction, no host reads):
//   hess_gen    one block: the xLARFG of the window (max-scaled norm, the
//               single-round sfmin rescue, correctly rounded divisions; see
//               psd::reflector_from_norm), writing w (ws[lo..n-1]), tau
//               (ws[n]) and beta (ws[n+1]), and column i of A[j]: beta at
//               row lo, exact zeros below;
//   hess_apply  the three updates over one grid: the left update of A[j]
//               (rows lo.., columns i+1..; 32 columns by 8 row groups a
//               block, so each row's loads coalesce), the right updates of
//               A[j-1] and Q[j] (a warp per row, shuffle reduction).
// The left update never touches columns <= i, whose entries in rows >= lo
// are exact zeros (columns < i) or set by hess_gen (column i), and the
// right updates never touch columns < lo, so H's structural zeros come out
// exact without a scrub.  With p == 1 the left and the right update hit the
// same matrix A[0]: the right one then runs after the left, in a second
// launch.  A reflector with tau == 0 (a zero tail) leaves everything as it
// is, and hess_apply returns at once.
//
// Bound: FP64 operations, about 5.3 n^3 per factor in the rank-one updates
// (0.17 ms at p=16, n=512 at the H100's FP64 tensor-core peak of 67 TFLOP/s,
// which a blocked reduction could mostly use); the 2 p (n-1) launches of the chain
// and the one-block generations set the time here (a single cooperative
// launch with a grid-wide sync between generation and application would
// remove the launches).
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

constexpr int kGenThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kLeftCols = 32;                           // columns per block
constexpr int kLeftRows = kApplyThreads / kLeftCols;    // row groups per block
constexpr int kRightRows = kApplyThreads / 32;          // rows (warps) per block

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum (kMax false) or max (kMax true, of values >= 0) of one
// double per thread; every thread gets the total.
template <bool kMax>
__device__ double block_reduce(double v, double* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) sh[wid] = v;
  __syncthreads();
  double r = (lane < (int)(blockDim.x >> 5)) ? sh[lane] : 0.0;
  r = kMax ? warp_max(r) : warp_sum(r);
  __syncthreads();  // sh is free again
  return r;
}

// Reflector of column i of M (n x n) on the rows lo..n-1.
__global__ void __launch_bounds__(kGenThreads)
hess_gen_kernel(double* __restrict__ M, double* __restrict__ ws, int n, int i,
                int lo) {
  __shared__ double sh[32];
  __shared__ double s_scl, s_den;
  const int tid = threadIdx.x;
  double* col = M + i;  // entry r of column i is col[r * n]
  double mx = 0.0;
  for (int r = lo + 1 + tid; r < n; r += blockDim.x)
    mx = fmax(mx, fabs(col[(size_t)r * n]));
  const double m = block_reduce<true>(mx, sh);
  const double ms = (m == 0.0) ? 1.0 : m;
  double ss = 0.0;
  for (int r = lo + 1 + tid; r < n; r += blockDim.x) {
    const double t = col[(size_t)r * n] / ms;
    ss += t * t;
  }
  const double rs = sqrt(block_reduce<false>(ss, sh));
  if (tid == 0) {
    double tau, beta, scl, den;
    psd::reflector_from_norm(col[(size_t)lo * n], m, rs, tau, beta, scl, den);
    s_scl = scl;
    s_den = den;
    ws[lo] = 1.0;
    ws[n] = tau;
    ws[n + 1] = beta;
    col[(size_t)lo * n] = beta;
  }
  __syncthreads();
  for (int r = lo + 1 + tid; r < n; r += blockDim.x) {
    double* x = col + (size_t)r * n;
    ws[r] = (*x * s_scl) / s_den;
    *x = 0.0;
  }
}

// M[lo.., c] -= tau w (w^T M[lo.., c]) for the 32 columns c >= i+1 of tile b.
__device__ void left_update(double* __restrict__ M, const double* __restrict__ w,
                            double tau, int n, int i, int lo, int b) {
  __shared__ double part[kLeftRows][kLeftCols];
  const int tx = threadIdx.x % kLeftCols, ty = threadIdx.x / kLeftCols;
  const int c = i + 1 + b * kLeftCols + tx;
  double s = 0.0;
  if (c < n)
    for (int r = lo + ty; r < n; r += kLeftRows) s += w[r] * M[(size_t)r * n + c];
  part[ty][tx] = s;
  __syncthreads();
  if (c >= n) return;
  double t = 0.0;
#pragma unroll
  for (int k = 0; k < kLeftRows; ++k) t += part[k][tx];
  const double tt = tau * t;
  for (int r = lo + ty; r < n; r += kLeftRows) M[(size_t)r * n + c] -= w[r] * tt;
}

// M[r, lo..] -= tau (M[r, lo..] w) w^T for the rows r of block b, a warp each.
__device__ void right_update(double* __restrict__ M, const double* __restrict__ w,
                             double tau, int n, int lo, int b) {
  const int lane = threadIdx.x & 31;
  const int r = b * kRightRows + (threadIdx.x >> 5);
  if (r >= n) return;  // the whole warp
  double* row = M + (size_t)r * n;
  double s = 0.0;
  for (int c = lo + lane; c < n; c += 32) s += row[c] * w[c];
  const double ts = tau * warp_sum(s);
  for (int c = lo + lane; c < n; c += 32) row[c] -= ts * w[c];
}

// Blocks [0, nbl): left update of L; [nbl, nbl + nbr): right update of R;
// the rest: right update of Z.
__global__ void __launch_bounds__(kApplyThreads)
hess_apply_kernel(double* __restrict__ L, double* __restrict__ R,
                  double* __restrict__ Z, const double* __restrict__ ws, int n,
                  int i, int lo, int nbl, int nbr) {
  const double tau = ws[n];
  if (tau == 0.0) return;
  const int b = blockIdx.x;
  if (b < nbl)
    left_update(L, ws, tau, n, i, lo, b);
  else if (b < nbl + nbr)
    right_update(R, ws, tau, n, lo, b - nbl);
  else
    right_update(Z, ws, tau, n, lo, b - nbl - nbr);
}

int launch_apply(double* L, double* R, double* Z, const double* ws, int n,
                 int i, int lo, cudaStream_t st, int* nlaunch) {
  const int nbl = L ? (n - i - 1 + kLeftCols - 1) / kLeftCols : 0;
  const int nbrows = (n + kRightRows - 1) / kRightRows;
  const int nbr = R ? nbrows : 0;
  const int nb = nbl + nbr + (Z ? nbrows : 0);
  if (nb == 0) return 0;
  hess_apply_kernel<<<nb, kApplyThreads, 0, st>>>(L, R, Z, ws, n, i, lo, nbl, nbr);
  ++*nlaunch;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole reduction, in place.  A: (p, n, n) input, H on return; Q:
// (p, n, n) identity on entry (NULL: not accumulated); ws: n + 2 doubles of
// scratch; *nlaunch: set to the number of kernel launches enqueued (2 p
// (n-1), and n-1 more when p == 1).  Returns the first CUDA error code, 0 on
// success.
int psd_hess_reduce(double* A, double* Q, double* ws, int p, int n,
                    int* nlaunch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t nn = (size_t)n * n;
  *nlaunch = 0;
  for (int i = 0; i < n - 1; ++i) {
    for (int j = p - 1; j >= 0; --j) {
      const int lo = (j == 0) ? i + 1 : i;
      double* Aj = A + (size_t)j * nn;
      double* Ar = A + (size_t)((j == 0) ? p - 1 : j - 1) * nn;
      double* Qj = Q ? Q + (size_t)j * nn : nullptr;
      hess_gen_kernel<<<1, kGenThreads, 0, st>>>(Aj, ws, n, i, lo);
      ++*nlaunch;
      int e = (int)cudaGetLastError();
      if (e) return e;
      if (Ar != Aj) {
        e = launch_apply(Aj, Ar, Qj, ws, n, i, lo, st, nlaunch);
      } else {  // p == 1: the right update of A[0] after the left one
        e = launch_apply(Aj, nullptr, Qj, ws, n, i, lo, st, nlaunch);
        if (!e) e = launch_apply(nullptr, Ar, nullptr, ws, n, i, lo, st, nlaunch);
      }
      if (e) return e;
    }
  }
  return 0;
}

}  // extern "C"
