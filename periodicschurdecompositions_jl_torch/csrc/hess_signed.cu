// Stage 2 of the signed periodic Hessenberg-triangular reduction (Kressner's
// two-stage scheme), float64 and complex128, in one launch of one block.
//
// The JAX package computes this stage in jnp inside its jitted
// phessenberg_signed_core (ops/hessenberg.py:113-242, the nested fori_loops
// at 167-239); there is no Pallas kernel.  Semantics:
// phessenberg_signed_core_plain of the port's ops/hessenberg.py, on the
// (p, n, n) row-major stacks H (stage 1's output, in place) and QT (stage
// 1's unitary factors transposed, QT[l] = Q[l]^T, or NULL), with the
// signature S (p ints, S[0] = 1).
//
// For each column j = 0..n-3 (active rotations i = n-1 down to lo = j+2):
//   factor 0     rotations G[i] from column j (f = A0[i-1][j], g = the carried
//                r), then the row updates of rows i-1, i (columns > j) and
//                Q[0]'s column updates;
//   l = p-1..1   with the incoming rotations G of the factor before, either
//     direct     the column update of columns i-1, i (rows 0..i), the
//                generation from (A[i-1][i-1], A[i][i-1]), then (deferred to
//                the chain's end) the row update of rows i-1, i from column i;
//     inverted   the row update of rows i-1, i from column i-1 by G[i], the
//                generation from (A[i][i], A[i][i-1]), then the column update
//                of columns i-1, i (rows 0..i-1), stored as (c, -s);
//     and Q[l]'s column updates by the factor's new rotations;
//   factor 0     the column updates by factor 1's rotations.
//
// Design: every entry sees the plain version's operations in its order;
// what the generations do not read is taken off the serial chain.
//   * A thread owns a row (column updates) or a column (row updates) and
//     applies a chain's rotations in the chain's order, the entry it shares
//     with the next step carried in a register.  Q's column updates are row
//     updates of QT, so a warp's loads there are coalesced.
//   * Factor 0 and direct factors: the generations form a chain of scalars.
//     A direct factor's column updates use known (incoming) rotations, so
//     the rows run them first, in parallel, and hand the chain the entry
//     A[i-1][i-1] each generation needs; thread 0 then runs the n - lo
//     generations back to back, and the rows and columns apply the rest.
//   * Inverted factors: a generation needs row i-1's entry A[i-1][i] after
//     the column updates of all the steps before, which are generated ones.
//     One barrier a step: thread 0 runs step i's generation (the 2x2 block
//     of rows and columns i-1, i, with row i-1's update by the previous
//     step's rotation done by itself), while warps 1.. apply the previous
//     step's rotation to rows 0..i-2 (each row's carried entry lives in
//     the scratch).  The row update right of column i is applied per
//     column after the chain (it touches nothing a generation reads).
//   The chain's rotations, the carried entries and the original diagonals
//   live in shared memory (in the global scratch ws when they do not fit:
//   above n ~ 3200 in float64, ~1800 in complex128).
//
// Numerics: psd::givens_r / psd::givens_cx (ops/rotations.py givens_host
// and JAX givens); every 2x2 product is written out with __fma_rn and
// __dmul_rn; no fast math.  The annihilated entries are written as exact
// zeros.
//
// Bound: about 3 real operations per updated entry, ~6 p n^3 in all with Q
// (chip_smoke.py::hess_signed_work: 12 us at p=8 n=256 at the FP64 peak).
// One block is bound instead by its chain of p (n-2)(n-1)/2 dependent
// generations, and by the updates between them, which stream each factor
// through one SM (the split on the card is in PERF.md).
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

constexpr int kGenWarp = 32;      // warp 0: thread 0 generates, its other lanes wait
constexpr int kMaxThreads = 512;
using psd::chain;
using psd::cj;
using psd::gen;
using psd::ng;
using psd::rot;
using psd::rot_r;

__host__ __device__ constexpr int threads_for(int n) {
  return kGenWarp + (n + 31) / 32 * 32 < kMaxThreads ? kGenWarp + (n + 31) / 32 * 32
                                                     : kMaxThreads;
}

// Scratch in bytes: two rotation sets (c: n doubles each, s: n T each),
// then the T arrays carry, fv, dg, sb, sp (n each).
__host__ __device__ constexpr size_t scratch_bytes(int n, size_t tsize) {
  return (size_t)n * (2 * sizeof(double) + 7 * tsize);
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads)
    hess_signed_kernel(T* __restrict__ H, T* __restrict__ QT, const int* __restrict__ S,
                       double* ws, int p, int n, int in_smem) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  double* base = in_smem ? smem : ws;
  double* gcA = base;
  double* gcB = base + n;
  T* gsA = reinterpret_cast<T*>(base + 2 * (size_t)n);
  T* gsB = gsA + n;
  T* carry = gsA + 2 * (size_t)n;  // inverted: row r's carried entry
  T* fv = gsA + 3 * (size_t)n;     // direct: A[i-1][i-1] after the column update i
  T* dg = gsA + 4 * (size_t)n;     // A[i-1][i-1] (inverted) at the chain's start
  T* sb = gsA + 5 * (size_t)n;     // A[i][i-1] at the chain's start; factor 0: column j
  T* sp = gsA + 6 * (size_t)n;     // A[i-1][i] (inverted) at the chain's start
  const size_t nn = (size_t)n * n;
  T* A0 = H;
  const T zero = T();

  for (int j = 0; j < n - 2; ++j) {
    const int lo = j + 2;
    double* gc = gcA;  // the incoming rotations
    T* gs = gsA;
    double* nc = gcB;  // the rotations the current factor generates
    T* ns = gsB;

    // ---- factor 0: the chain of column j ----
    for (int r = j + 1 + tid; r < n; r += nt) sb[r] = A0[(size_t)r * n + j];
    __syncthreads();
    if (tid == 0) {
      T x = sb[n - 1];
      for (int i = n - 1; i >= lo; --i) {
        double c;
        T s, r;
        gen(sb[i - 1], x, c, s, r);
        gc[i] = c;
        gs[i] = s;
        x = r;
      }
      sb[j + 1] = x;
    }
    __syncthreads();
    for (int r = j + 1 + tid; r < n; r += nt)
      A0[(size_t)r * n + j] = (r == j + 1) ? sb[j + 1] : zero;
    for (int k = j + 1 + tid; k < n; k += nt)
      A0[(size_t)(j + 1) * n + k] = chain<false>(A0 + k, n, n - 1, lo, gc, gs);
    if (QT)
      for (int k = tid; k < n; k += nt)
        QT[(size_t)(j + 1) * n + k] = chain<true>(QT + k, n, n - 1, lo, gc, gs);

    // ---- factors p-1..1 ----
    for (int l = p - 1; l >= 1; --l) {
      T* Al = H + (size_t)l * nn;
      if (S[l]) {
        // the column updates by the incoming rotations, rows 0..n-2; a row
        // r > j hands on A[r][r] after step r+1 (the next generation's f)
        for (int r = tid; r < n - 1; r += nt) {
          T* row = Al + (size_t)r * n;
          const T y = chain<true>(row, 1, n - 1, r + 1 > lo ? r + 1 : lo, gc, gs);
          if (r > j)
            fv[r + 1] = y;
          else
            row[j + 1] = y;
        }
        for (int i = lo + tid; i < n; i += nt) sb[i] = Al[(size_t)i * n + i - 1];
        __syncthreads();
        if (tid == 0) {
          T d = Al[(size_t)(n - 1) * n + n - 1];
          for (int i = n - 1; i >= lo; --i) {
            T e = sb[i];
            rot_r(gc[i], gs[i], e, d);  // row i: e <- A[i][i-1], d <- A[i][i]
            Al[(size_t)i * n + i] = d;
            Al[(size_t)i * n + i - 1] = zero;
            double c;
            T s, r;
            gen(fv[i], e, c, s, r);
            nc[i] = c;
            ns[i] = s;
            d = r;
          }
          Al[(size_t)(j + 1) * n + j + 1] = d;
        }
        __syncthreads();
        // the deferred row updates, columns lo..n-1 (rows i-1, i for i <= k)
        for (int k = lo + tid; k < n; k += nt)
          Al[(size_t)(j + 1) * n + k] = chain<false>(Al + k, n, k, lo, nc, ns);
      } else {
        for (int i = lo + tid; i < n; i += nt) {
          dg[i] = Al[(size_t)(i - 1) * n + i - 1];
          sb[i] = Al[(size_t)i * n + i - 1];
          sp[i] = Al[(size_t)(i - 1) * n + i];
        }
        for (int r = tid; r <= n - 3; r += nt) carry[r] = Al[(size_t)r * n + n - 1];
        __syncthreads();
        T d = zero;  // thread 0: A[i][i] after step i+1
        if (tid == 0) d = Al[(size_t)(n - 1) * n + n - 1];
        for (int i = n - 1; i >= lo; --i) {
          if (tid == 0) {
            T b = sp[i];
            if (i < n - 1) {  // row i-1 by step i+1's rotation
              T y = carry[i - 1];
              rot_r(nc[i + 1], ns[i + 1], b, y);
              Al[(size_t)(i - 1) * n + i + 1] = y;
            }
            T a = dg[i], e = sb[i];
            rot(gc[i], gs[i], a, e);  // column i-1: a <- A[i-1][i-1], e <- A[i][i-1]
            rot(gc[i], gs[i], b, d);  // column i:   b <- A[i-1][i],   d <- A[i][i]
            double c;
            T s, r;
            gen(d, e, c, s, r);
            Al[(size_t)i * n + i] = r;
            Al[(size_t)i * n + i - 1] = zero;
            const T sn = ng(s);
            nc[i] = c;
            ns[i] = sn;
            rot_r(c, sn, a, b);  // row i-1 by step i's rotation
            Al[(size_t)(i - 1) * n + i] = b;
            d = a;
          } else if (tid >= kGenWarp && i < n - 1) {  // rows 0..i-2 by step i+1's
            for (int r = tid - kGenWarp; r <= i - 2; r += nt - kGenWarp) {
              T x = Al[(size_t)r * n + i];
              T y = carry[r];
              rot_r(nc[i + 1], ns[i + 1], x, y);
              Al[(size_t)r * n + i + 1] = y;
              carry[r] = x;
            }
          }
          __syncthreads();
        }
        if (tid == 0) Al[(size_t)(j + 1) * n + j + 1] = d;
        for (int r = tid; r <= j; r += nt) {  // rows 0..j by step lo's rotation
          T x = Al[(size_t)r * n + j + 1];
          T y = carry[r];
          rot_r(nc[lo], ns[lo], x, y);
          Al[(size_t)r * n + lo] = y;
          Al[(size_t)r * n + j + 1] = x;
        }
        __syncthreads();
        // the row updates right of column i (rows i-1, i), per column
        for (int k = lo + 1 + tid; k < n; k += nt)
          Al[(size_t)(j + 1) * n + k] = chain<false>(Al + k, n, k - 1, lo, gc, gs);
      }
      if (QT) {
        T* QTl = QT + (size_t)l * nn;
        for (int k = tid; k < n; k += nt)
          QTl[(size_t)(j + 1) * n + k] = chain<true>(QTl + k, n, n - 1, lo, nc, ns);
      }
      double* tc = gc;
      gc = nc;
      nc = tc;
      T* ts = gs;
      gs = ns;
      ns = ts;
    }

    // ---- factor 0: the column updates by factor 1's rotations ----
    __syncthreads();
    for (int r = tid; r < n; r += nt)
      A0[(size_t)r * n + j + 1] = chain<true>(A0 + (size_t)r * n, 1, n - 1, lo, gc, gs);
    __syncthreads();
  }
}

template <class T>
int hess_signed(T* H, T* QT, const int* S, double* ws, int p, int n, int* nlaunch,
                void* stream) {
  *nlaunch = 0;
  if (n <= 2) return 0;
  auto kernel = hess_signed_kernel<T>;
  const size_t bytes = scratch_bytes(n, sizeof(T));
  bool fits = false;
  cudaError_t e = psd::fit_smem(kernel, bytes, fits);
  if (e) return (int)e;
  const int in_smem = fits;
  const size_t smem = in_smem ? bytes : 0;
  kernel<<<1, threads_for(n), smem, (cudaStream_t)stream>>>(H, QT, S, ws, p, n, in_smem);
  e = cudaGetLastError();
  if (e) return (int)e;
  *nlaunch = 1;
  return 0;
}

}  // namespace

extern "C" {

// Bytes of scratch psd_hess_signed takes in ws (used only when they do not
// fit the shared memory of a block).
long long psd_hess_signed_scratch(int n, int cplx) {
  return (long long)scratch_bytes(n, cplx ? sizeof(double2) : sizeof(double));
}

// Stage 2 of the signed reduction, in place, in one launch.  H: (p, n, n),
// stage 1's output (factors 1..p-1 triangular), H on return (with exact
// zeros where the chains annihilate); QT: (p, n, n) stage 1's unitary
// factors transposed (QT[l] = Q[l]^T), updated (NULL: not accumulated); S: p ints on the device, S[0]
// = 1; ws: psd_hess_signed_scratch(n, cplx) bytes on the device; *nlaunch:
// the number of launches enqueued (1; 0 when n <= 2).  Returns the first
// CUDA error code, 0 on success.
int psd_hess_signed(double* H, double* QT, const int* S, double* ws, int p, int n,
                    int* nlaunch, void* stream) {
  return hess_signed<double>(H, QT, S, ws, p, n, nlaunch, stream);
}

// The same for a complex128 stack (interleaved re, im).
int psd_hess_signed_c128(double2* H, double2* QT, const int* S, double* ws, int p, int n,
                         int* nlaunch, void* stream) {
  return hess_signed<double2>(H, QT, S, ws, p, n, nlaunch, stream);
}

}  // extern "C"
