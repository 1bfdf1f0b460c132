// Periodic Hessenberg-triangular reduction (MB03VD column sweep), float64 and
// complex128, in one cooperative launch.
//
// Replaces the Pallas kernel _make_hess_kernel of the JAX package's
// ops/pallas_hess.py (the whole ds reduction in one launch, H and Q^T
// resident in VMEM); the complex128 instance is the port's kernel for the
// JAX package's complex phessenberg_core (ops/hessenberg.py, jnp, no Pallas
// kernel).  Semantics: phessenberg_core of ops/hessenberg.py (reference
// src/PeriodicSchurDecompositions.jl:199-259) on the (p, n, n) row-major
// stacks A (in place: it becomes H) and Q (the identity on entry):
//   Q[j]^H A[j] Q[(j+1) % p] = H[j],  H[0] Hessenberg, H[1..p-1] triangular.
//
// The reduction is a chain of p (n-1) stages.  Stage (i, j), for columns
// i = 0..n-2 and factors j = p-1..1, then 0: a Householder reflector
// P = I - tau w w^H from column i of A[j] on the window rows lo..n-1 (lo = i
// for j >= 1, i + 1 for j == 0), applied from the left to A[j]
// (A <- P^H A), from the right to A[j-1] (A[p-1] for j == 0) and to Q[j]
// (M <- M P).  Each stage reads what the one before wrote.
//
// Design: one persistent launch (cudaLaunchCooperativeKernel, every block
// resident; as many blocks as the widest stage has tiles, at most what the
// card holds at once) runs the whole chain, with one grid barrier per stage:
//   generation  every block computes the stage's reflector itself from
//               column i of A[j] into its shared memory (xLARFG / zlarfg:
//               max-scaled norm, the single-round sfmin rescue, correctly
//               rounded divisions; psd::reflector_from_norm{,_cx}), so no
//               barrier separates generation and update;
//   update      the blocks walk the stage's tiles: the left update of A[j]
//               (rows lo.., columns i+1..; kLeftCols columns by 8 row groups
//               a tile, so each row's loads coalesce), the right updates of
//               A[j-1] and Q[j] (kRightRows rows a tile, a warp per row,
//               shuffle reduction), each thread's loads issued in batches;
//   barrier     cooperative_groups' grid sync; then block 0 writes column i
//               of A[j] (beta at row lo, exact zeros below).  That write
//               waits for the barrier because every block reads the column
//               during the generation; no later stage reads or writes it
//               (left updates touch columns > i, right updates columns >= lo
//               of another factor or of a later column).
// The real instance keeps the two-launch design's arithmetic and summation
// order entry by entry (its multiply-adds written out with __fma_rn as nvcc
// contracted them there), so H and Q are that design's bit for bit.  The
// left update never touches columns <= i and the right updates never touch
// columns < lo, so H's structural zeros come out exact without a scrub.
// With p == 1 the left and the right update hit the same matrix A[0]: a
// second grid barrier runs between them.  A reflector with tau == 0 (a zero
// tail; for complex128 also a real alpha) skips the updates, never a barrier.
//
// w lives in shared memory (n entries after kFixed doubles of scratch): up
// to n = 28760 in float64 and n = 14380 in complex128 on an H100's 227 KB.
// Above that block 0 generates w into the global scratch ws and a second
// barrier hands it to the other blocks.
//
// Bound: FP64 operations, about 5.3 n^3 per factor in the rank-one updates
// (0.17 ms at p=16, n=512 at the H100's FP64 tensor-core peak of 67 TFLOP/s,
// which a blocked (WY) reduction could mostly use).  This kernel is bound by
// its chain of p (n-1) dependent stages: per stage a generation, the slowest
// tile of the update and one grid barrier (the split, and what bounds the
// update, are in PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// Tile shapes (scripts/time_sweep_generate.py --hess --set NAME=VALUE times
// other values; on the headline draw 16 columns beat 32 and 8, two rows a
// warp beat one, three and four, batches of 4 loads beat 2, 8, 16 and 32).
constexpr int kLeftRows = 8;                        // row groups of a left tile
constexpr int kLeftCols = 16;                       // columns of a left tile (<= 32)
constexpr int kRowsPerWarp = 2;                     // rows of a warp in a right tile
constexpr int kRightRows = kThreads / 32 * kRowsPerWarp;  // rows of a right tile
constexpr int kBatch = 4;                           // loads in flight per thread
constexpr int kGenKeep = 2;                         // column entries a thread keeps
// Shared scratch before w, in doubles: block reductions (32), the left
// tile's partial sums (kLeftRows x kLeftCols complex at most), scalars (8).
constexpr int kRed = 32, kPart = 2 * kLeftRows * kLeftCols, kScal = 8;
constexpr int kFixed = kRed + kPart + kScal;
// What a stage runs: 2 all of it; 1 the generations and the barriers; 0 the
// barriers only (scripts/time_sweep_generate.py --hess builds 0 and 1 to
// split the reduction's time).
constexpr int kStagePhases = 2;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double2 warp_sum(double2 v) {
  return make_double2(warp_sum(v.x), warp_sum(v.y));
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

// ---- scalar arithmetic of the two instances ----

__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }
__device__ __forceinline__ double real_as(double v, double) { return v; }
__device__ __forceinline__ double2 real_as(double v, double2) { return make_double2(v, 0.0); }
__device__ __forceinline__ double conj_of(double a) { return a; }
__device__ __forceinline__ double2 conj_of(double2 a) { return psd::cconj(a); }
__device__ __forceinline__ bool is_zero(double a) { return a == 0.0; }
__device__ __forceinline__ bool is_zero(double2 a) { return a.x == 0.0 && a.y == 0.0; }
__device__ __forceinline__ double mul(double a, double b) { return a * b; }
__device__ __forceinline__ double2 mul(double2 a, double2 b) { return psd::cmul(a, b); }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double2 add(double2 a, double2 b) { return psd::cadd(a, b); }
// s + a b and s - a b
__device__ __forceinline__ double madd(double s, double a, double b) {
  return __fma_rn(a, b, s);
}
__device__ __forceinline__ double2 madd(double2 s, double2 a, double2 b) {
  return psd::cadd(s, psd::cmul(a, b));
}
__device__ __forceinline__ double msub(double s, double a, double b) {
  return __fma_rn(-a, b, s);
}
__device__ __forceinline__ double2 msub(double2 s, double2 a, double2 b) {
  const double2 t = psd::cmul(a, b);
  return make_double2(s.x - t.x, s.y - t.y);
}
// max(|re|, |im|) and the running sum of squares of x / ms
__device__ __forceinline__ double amax(double a) { return fabs(a); }
__device__ __forceinline__ double amax(double2 a) { return fmax(fabs(a.x), fabs(a.y)); }
__device__ __forceinline__ double sumsq(double ss, double x, double ms) {
  const double t = x / ms;
  return __fma_rn(t, t, ss);
}
__device__ __forceinline__ double sumsq(double ss, double2 x, double ms) {
  const double tr = x.x / ms, ti = x.y / ms;
  return ss + (tr * tr + ti * ti);
}

// Shared scalars of a stage, in kScal doubles: tau (2), beta, scl, den (2).
template <class T>
struct Scalars {
  T tau;
  double beta, scl;
  T den;  // real: the divisor of w; complex: 1 / denom
};

__device__ __forceinline__ void reflector(double alpha, double m, double rs,
                                          Scalars<double>& s) {
  psd::reflector_from_norm(alpha, m, rs, s.tau, s.beta, s.scl, s.den);
}

__device__ __forceinline__ void reflector(double2 alpha, double m, double rs,
                                          Scalars<double2>& s) {
  psd::reflector_from_norm_cx(alpha, m, rs, s.tau, s.beta, s.scl, s.den);
}

__device__ __forceinline__ double scale_w(double x, const Scalars<double>& s) {
  return (x * s.scl) / s.den;
}

__device__ __forceinline__ double2 scale_w(double2 x, const Scalars<double2>& s) {
  return psd::cmul(psd::rmul(s.scl, x), s.den);
}

// The reflector of column i of M on the rows lo..n-1: w[lo..n-1] (w[lo] = 1)
// and the block's Scalars.  Each thread keeps its first kGenKeep entries of
// the column (and alpha) in registers for the three passes over it (max,
// sum of squares, w); the sums run over the same entries in the same order.
template <class T>
__device__ void generate(const T* M, T* w, int n, int i, int lo, double* red,
                         Scalars<T>* sc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* col = M + i;  // entry r of column i is col[r * n]
  const int r1 = lo + 1 + tid + kGenKeep * nt;  // first row not kept
  T x[kGenKeep > 0 ? kGenKeep : 1];
#pragma unroll
  for (int k = 0; k < kGenKeep; ++k)
    if (lo + 1 + tid + k * nt < n) x[k] = col[(size_t)(lo + 1 + tid + k * nt) * n];
  const T alpha = col[(size_t)lo * n];
  double mx = 0.0;
#pragma unroll
  for (int k = 0; k < kGenKeep; ++k)
    if (lo + 1 + tid + k * nt < n) mx = fmax(mx, amax(x[k]));
  for (int r = r1; r < n; r += nt) mx = fmax(mx, amax(col[(size_t)r * n]));
  const double m = block_reduce<true>(mx, red);
  const double ms = (m == 0.0) ? 1.0 : m;
  double ss = 0.0;
#pragma unroll
  for (int k = 0; k < kGenKeep; ++k)
    if (lo + 1 + tid + k * nt < n) ss = sumsq(ss, x[k], ms);
  for (int r = r1; r < n; r += nt) ss = sumsq(ss, col[(size_t)r * n], ms);
  const double rs = sqrt(block_reduce<false>(ss, red));
  if (tid == 0) reflector(alpha, m, rs, *sc);
  __syncthreads();
  const Scalars<T> s = *sc;
  if (tid == 0) w[lo] = real_as(1.0, T());
#pragma unroll
  for (int k = 0; k < kGenKeep; ++k)
    if (lo + 1 + tid + k * nt < n) w[lo + 1 + tid + k * nt] = scale_w(x[k], s);
  for (int r = r1; r < n; r += nt) w[r] = scale_w(col[(size_t)r * n], s);
  __syncthreads();
}

// M[lo.., c] -= ctau w (w^H M[lo.., c]) for the 32 columns c >= i+1 of tile b
// (ctau = conj(tau)).  Each thread loads its rows of M in batches of kBatch
// loads issued together, then does the batch's multiply-adds in row order:
// the sum is the one-row-at-a-time sum, with one memory latency per batch.
template <class T>
__device__ void left_tile(T* M, const T* w, T ctau, int n, int i, int lo, int b,
                          T* part) {
  const int tx = threadIdx.x % kLeftCols, ty = threadIdx.x / kLeftCols;
  const bool mine = ty < kLeftRows;  // the threads of the tile
  const int c = mine ? i + 1 + b * kLeftCols + tx : n;
  constexpr int kStep = kLeftRows * kBatch;
  T s = zero_of(T());
  if (c < n)
    for (int r0 = lo + ty; r0 < n; r0 += kStep) {
      T mv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (r0 + k * kLeftRows < n) mv[k] = M[(size_t)(r0 + k * kLeftRows) * n + c];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (r0 + k * kLeftRows < n) s = madd(s, conj_of(w[r0 + k * kLeftRows]), mv[k]);
    }
  if (mine) part[ty * kLeftCols + tx] = s;
  __syncthreads();
  if (c < n) {
    T t = zero_of(T());
#pragma unroll
    for (int k = 0; k < kLeftRows; ++k) t = add(t, part[k * kLeftCols + tx]);
    const T tt = mul(ctau, t);
    for (int r0 = lo + ty; r0 < n; r0 += kStep) {
      T mv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (r0 + k * kLeftRows < n) mv[k] = M[(size_t)(r0 + k * kLeftRows) * n + c];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = r0 + k * kLeftRows;
        if (r < n) M[(size_t)r * n + c] = msub(mv[k], w[r], tt);
      }
    }
  }
  __syncthreads();  // part is free again
}

// M[r, lo..] -= tau (M[r, lo..] w) w^H for the rows r of tile b, kRowsPerWarp
// a warp (lane-strided columns, loads in batches as in left_tile).
template <class T>
__device__ void right_tile(T* M, const T* w, T tau, int n, int lo, int b) {
  const int lane = threadIdx.x & 31;
  constexpr int kStep = 32 * kBatch;
#pragma unroll 1
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int r = b * kRightRows + q * (kThreads / 32) + (threadIdx.x >> 5);
    if (r >= n) return;  // the whole warp; no block barrier follows
    T* row = M + (size_t)r * n;
    T s = zero_of(T());
    for (int c0 = lo + lane; c0 < n; c0 += kStep) {
      T rv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (c0 + 32 * k < n) rv[k] = row[c0 + 32 * k];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (c0 + 32 * k < n) s = madd(s, rv[k], w[c0 + 32 * k]);
    }
    const T ts = mul(tau, warp_sum(s));
    for (int c0 = lo + lane; c0 < n; c0 += kStep) {
      T rv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (c0 + 32 * k < n) rv[k] = row[c0 + 32 * k];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int c = c0 + 32 * k;
        if (c < n) row[c] = msub(rv[k], ts, conj_of(w[c]));
      }
    }
  }
}

// The whole reduction.  gw: w in the global scratch ws (n + 2 entries; tau
// at ws[n]) instead of shared memory.
template <class T>
__global__ void __launch_bounds__(kThreads)
hess_reduce_kernel(T* A, T* Q, T* ws, int p, int n, int gw) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double smem[];
  double* red = smem;
  T* part = reinterpret_cast<T*>(smem + kRed);
  Scalars<T>* sc = reinterpret_cast<Scalars<T>*>(smem + kRed + kPart);
  T* w = gw ? ws : reinterpret_cast<T*>(smem + kFixed);
  const size_t nn = (size_t)n * n;
  const int nbrows = (n + kRightRows - 1) / kRightRows;
  const int nq = Q ? nbrows : 0;
  for (int i = 0; i < n - 1; ++i) {
    for (int j = p - 1; j >= 0; --j) {
      const int lo = (j == 0) ? i + 1 : i;
      T* Aj = A + (size_t)j * nn;
      T* Ar = A + (size_t)((j == 0) ? p - 1 : j - 1) * nn;
      T* Qj = Q ? Q + (size_t)j * nn : nullptr;
      if (kStagePhases >= 1 && (!gw || blockIdx.x == 0))
        generate<T>(Aj, w, n, i, lo, red, sc);
      T tau = zero_of(T());
      if (kStagePhases >= 1) tau = sc->tau;
      if (gw) {
        if (blockIdx.x == 0 && threadIdx.x == 0) ws[n] = tau;
        grid.sync();
        tau = ws[n];
      }
      const int nbl = (n - i - 1 + kLeftCols - 1) / kLeftCols;
      const bool run = kStagePhases >= 2 && !is_zero(tau);
      if (Ar != Aj) {
        for (int t = blockIdx.x; run && t < nbl + nbrows + nq; t += gridDim.x) {
          if (t < nbl)
            left_tile<T>(Aj, w, conj_of(tau), n, i, lo, t, part);
          else if (t < nbl + nbrows)
            right_tile<T>(Ar, w, tau, n, lo, t - nbl);
          else
            right_tile<T>(Qj, w, tau, n, lo, t - nbl - nbrows);
        }
      } else {  // p == 1: the right update of A[0] after the left one
        for (int t = blockIdx.x; run && t < nbl + nq; t += gridDim.x) {
          if (t < nbl)
            left_tile<T>(Aj, w, conj_of(tau), n, i, lo, t, part);
          else
            right_tile<T>(Qj, w, tau, n, lo, t - nbl);
        }
        grid.sync();
        for (int t = blockIdx.x; run && t < nbrows; t += gridDim.x)
          right_tile<T>(Ar, w, tau, n, lo, t);
      }
      const double beta = sc->beta;
      grid.sync();
      if (kStagePhases >= 1 && blockIdx.x == 0) {  // column i of A[j]
        T* col = Aj + i;
        for (int r = lo + threadIdx.x; r < n; r += blockDim.x)
          col[(size_t)r * n] = real_as((r == lo) ? beta : 0.0, T());
      }
    }
  }
}

// Tiles of the widest stage (i = 0): the blocks a launch can keep busy.
int max_tiles(int p, int n, bool want_q) {
  const int nbrows = (n + kRightRows - 1) / kRightRows;
  const int nq = want_q ? nbrows : 0;
  const int nbl = (n - 1 + kLeftCols - 1) / kLeftCols;
  return p == 1 ? (nbl + nq > nbrows ? nbl + nq : nbrows) : nbl + nbrows + nq;
}

template <class T>
int hess_reduce(T* A, T* Q, T* ws, int p, int n, int* nlaunch, void* stream) {
  *nlaunch = 0;
  if (n < 2) return 0;
  auto kernel = hess_reduce_kernel<T>;
  const size_t fixed = kFixed * sizeof(double);
  size_t smem = fixed + (size_t)n * sizeof(T);
  bool fits = false;
  cudaError_t e = psd::fit_smem(kernel, smem, fits);
  int gw = !fits;
  if (!e && gw) {
    smem = fixed;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  int nblocks = 0;
  if (!e) e = psd::coop_blocks(kernel, kThreads, smem, max_tiles(p, n, Q != nullptr), nblocks);
  if (e) return (int)e;
  void* args[] = {&A, &Q, &ws, &p, &n, &gw};
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(nblocks), dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e) return (int)e;
  *nlaunch = 1;
  return 0;
}

}  // namespace

extern "C" {

// The whole reduction, in place, in one cooperative launch.  A: (p, n, n)
// input, H on return; Q: (p, n, n) identity on entry (NULL: not
// accumulated); ws: n + 2 entries of scratch; *nlaunch: set to the number of
// kernel launches enqueued (1; 0 when n < 2).  Returns the first CUDA error
// code (a refused launch included), 0 on success.
int psd_hess_reduce(double* A, double* Q, double* ws, int p, int n, int* nlaunch,
                    void* stream) {
  return hess_reduce<double>(A, Q, ws, p, n, nlaunch, stream);
}

// The same for a complex128 stack (interleaved re, im).
int psd_hess_reduce_c128(double2* A, double2* Q, double2* ws, int p, int n,
                         int* nlaunch, void* stream) {
  return hess_reduce<double2>(A, Q, ws, p, n, nlaunch, stream);
}

}  // extern "C"
