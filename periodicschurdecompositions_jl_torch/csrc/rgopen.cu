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
// is a serial chain of up to 2(p-1) Givens generations, each reading
// entries the previous update wrote; the data, a few rows and columns of
// every factor, is O(p n).  The generations read only each factor's
// diagonal window, the K x K block at (j, j) (K = 3 open, 2 chain510; in
// the close mode also H[0][j:j+2, j-1]); every entry outside the windows
// takes row rotations only (rows j..j+K-1 right of the window) or column
// rotations only (columns j..j+K-1: above the window, in H[0] also below
// it; every row of Z), those of one log entry.  So (tests/torch_ladder_host.py
// models it):
//   * one cooperative launch; every block stages all p windows, the
//     rotation and S in shared memory; thread 0 runs the chain on the
//     windows and logs the rotations (open: (c1, s1, c2, s2) after each
//     factor; chain510: each factor's);
//   * the lines outside the windows (a column of the window's rows, a row
//     of its columns) are spread over the grid, one a thread, and loaded
//     into registers while the chain runs; after one block barrier
//     they take their rotations from the log and are stored.  Lines past
//     the grid (capped at the blocks the card holds at once) are walked
//     grid-stride after it;
//   * every block runs the same deterministic chain, so all hold the same
//     final windows; block 0 writes them back after a grid barrier, once
//     every block has read them.  No state outlives a launch, so launches
//     on two streams may overlap.
// The rotations are written out as the parent compiled them (its SASS):
// (c x0 + s x1, c x1 - s x0) as fma(c, x0, s x1), fma(c, x1, -(s x0)).  So
// H and Z are bit for bit the parent's.  Past the shared memory a block can
// have ((K^2 + 4) p doubles and p ints), the parent's design runs
// (rg_ladder_stepwise: one block, thread 0 generating, a barrier around
// every 2-row or 2-column update).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // one line a thread

// (x0, x1) <- (c x0 + s x1, c x1 - s x0), the parent's form
__device__ __forceinline__ void rot2(double c, double s, double& x0, double& x1) {
  const double y0 = __fma_rn(c, x0, __dmul_rn(s, x1));
  const double y1 = __fma_rn(c, x1, -__dmul_rn(s, x0));
  x0 = y0;
  x1 = y1;
}

// The bounds of the parent's updates where they meet a window: rhi =
// min(rhi, n), clo = max(clo, 0).
struct Box {
  int j, n, rhi, clo;
};

// A factor's K x K window at (j, j) in registers, x[a K + b] = H[l][j+a][j+b]
// (a and b are constants once inlined).
template <int K>
struct Win {
  double x[K * K];
  __device__ __forceinline__ void load(const double* w) {
#pragma unroll
    for (int e = 0; e < K * K; ++e) x[e] = w[e];
  }
  __device__ __forceinline__ void store(double* w) const {
#pragma unroll
    for (int e = 0; e < K * K; ++e) w[e] = x[e];
  }
  // rows j+a, j+a+1, columns [lo, rhi)
  __device__ __forceinline__ void rows(const Box& bx, int a, int lo, double c, double s) {
#pragma unroll
    for (int b = 0; b < K; ++b)
      if (bx.j + b >= lo && bx.j + b < bx.rhi) rot2(c, s, x[a * K + b], x[(a + 1) * K + b]);
  }
  // columns j+b, j+b+1, rows [clo, hi)
  __device__ __forceinline__ void cols(const Box& bx, int b, int hi, double c, double s) {
#pragma unroll
    for (int a = 0; a < K; ++a)
      if (bx.j + a >= bx.clo && bx.j + a < min(hi, bx.n))
        rot2(c, s, x[a * K + b], x[a * K + b + 1]);
  }
};

// Thread 0, open mode: the chain on the windows W (each factor's in
// registers, the next one's loaded while it runs), (c1, s1, c2, s2) after
// each factor into L.
__device__ void chain_open(double* W, double* L, const double* R, const int* S, int p,
                           const Box& bx, int ilast) {
  const int j = bx.j;
  double c1 = R[0], s1 = R[1], c2 = R[2], s2 = R[3], r;
  L[0] = c1, L[1] = s1, L[2] = c2, L[3] = s2;
  Win<3> w0, w, nx;
  w0.load(W);
  w0.cols(bx, 1, ilast + 1, c2, s2);
  w0.cols(bx, 0, ilast + 1, c1, s1);
  if (p > 1) w.load(W + 9);
  for (int l = 1; l < p; ++l) {
    if (l + 1 < p) nx.load(W + 9 * (l + 1));
    double* x = w.x;
    if (S[l]) {
      w.rows(bx, 1, j, c2, s2);
      psd::givens_r(x[8], -x[7], c2, s2, r);
      x[8] = r;
      x[7] = 0.0;
      w.cols(bx, 1, j + 2, c2, s2);
      w.rows(bx, 0, j, c1, s1);
      psd::givens_r(x[4], -x[3], c1, s1, r);
      x[4] = r;
      x[3] = 0.0;
      w.cols(bx, 0, j + 1, c1, s1);
    } else {
      w.cols(bx, 1, j + 3, c2, s2);
      psd::givens_r(x[4], x[7], c2, s2, r);
      x[4] = r;
      x[7] = 0.0;
      w.rows(bx, 1, j + 2, c2, s2);
      w.cols(bx, 0, j + 2, c1, s1);
      psd::givens_r(x[0], x[3], c1, s1, r);
      x[0] = r;
      x[3] = 0.0;
      w.rows(bx, 0, j + 1, c1, s1);
    }
    w.store(W + 9 * l);
    double* Ll = L + 4 * l;
    Ll[0] = c1, Ll[1] = s1, Ll[2] = c2, Ll[3] = s2;
    w = nx;
  }
  w0.rows(bx, 1, j, c2, s2);  // H[0]'s rows j+1, j+2 then j, j+1
  w0.rows(bx, 0, j, c1, s1);
  w0.store(W);
}

// Thread 0, close and chain modes: chain510, each factor's rotation into L.
__device__ void chain510(double* W, double* E, double* L, const double* R, const int* S,
                         int p, int mode, const Box& bx) {
  const int j = bx.j;
  double c1, s1, r;
  if (mode == 1) {
    psd::givens_r(E[0], E[1], c1, s1, r);
    E[0] = r;
    E[1] = 0.0;
  } else {
    c1 = R[0];
    s1 = R[1];
  }
  L[0] = c1, L[1] = s1;
  Win<2> w0, w, nx;
  w0.load(W);
  w0.rows(bx, 0, j, c1, s1);
  w.load(W + 4 * (p - 1));
  for (int l = p - 1; l >= 1; --l) {
    if (l > 1) nx.load(W + 4 * (l - 1));
    double* x = w.x;
    if (S[l]) {
      w.cols(bx, 0, j + 2, c1, s1);
      psd::givens_r(x[0], x[2], c1, s1, r);
      x[0] = r;
      x[2] = 0.0;
      w.rows(bx, 0, j + 1, c1, s1);
    } else {
      w.rows(bx, 0, j, c1, s1);
      psd::givens_r(x[3], -x[2], c1, s1, r);
      x[3] = r;
      x[2] = 0.0;
      w.cols(bx, 0, j + 1, c1, s1);
    }
    w.store(W + 4 * l);
    L[4 * l] = c1, L[4 * l + 1] = s1;
    w = nx;
  }
  w0.cols(bx, 0, bx.n, c1, s1);
  w0.store(W);
}

// The log entry of a line of factor l.  kind 0: rows j..j+K-1 right of the
// window; 1: columns j..j+K-1 (above the window; in H[0] also below it); 2:
// Z[l].  Open: entry e holds (c1, s1, c2, s2) after factor e (0: the input);
// chain510: factor e's rotation (0: the first).
__device__ __forceinline__ int line_entry(int kind, int l, int p, int mode, const int* S) {
  if (mode == 0) {
    if (kind == 2) return (l + p - 1) % p;
    if (l == 0) return kind == 0 ? p - 1 : 0;
    return (kind == 0) == (S[l] != 0) ? l - 1 : l;
  }
  if (kind == 2) return l;
  if (l == 0) return kind == 0 ? 0 : 1;
  return (kind == 0) == (S[l] != 0) ? l : (l == p - 1 ? 0 : l + 1);
}

// Lines of factor 0 and of each other factor; the rows of H[0]'s column
// strip below the window (the rest lie past it).
struct Lines {
  int K, Nr, below0, Nc0, Nc1, Nz, L0, L1;
  __host__ __device__ Lines(int n, int mode, int j, int ilast, int rhi, int clo, bool z) {
    K = mode == 0 ? 3 : 2;
    const int hi0 = mode == 0 ? (ilast + 1 < n ? ilast + 1 : n) : n;
    const int top = clo > j + K ? clo : j + K;
    Nr = rhi - j - K > 0 ? rhi - j - K : 0;
    below0 = (hi0 < j ? hi0 : j) - clo > 0 ? (hi0 < j ? hi0 : j) - clo : 0;
    Nc0 = below0 + (hi0 - top > 0 ? hi0 - top : 0);
    Nc1 = j - clo > 0 ? j - clo : 0;
    Nz = z ? n : 0;
    L0 = Nr + Nc0 + Nz;
    L1 = Nr + Nc1 + Nz;
  }
  __host__ __device__ long total(int p) const { return L0 + (long)(p - 1) * L1; }
};

// A line outside the windows: a column right of the window of its rows
// (kind 0), a row of its columns (kind 1: above it; in H[0] also below it)
// or a row of Z[l]'s (kind 2) of factor l; at: its first entry (nullptr:
// none), st: the stride between its entries.
struct Line {
  double* at = nullptr;
  int st = 1, kind = 0, l = 0;
};

// Line k of ln's.
__device__ __forceinline__ Line line_at(double* H, double* Z, const Lines& ln, long k, int p,
                                        int n, int j, int clo) {
  Line x;
  if (k >= ln.total(p)) return x;
  const size_t nn = (size_t)n * n;
  int Nc = ln.Nc0, below = ln.below0;
  if (k >= ln.L0) {
    k -= ln.L0;
    x.l = 1 + (int)(k / ln.L1);
    k %= ln.L1;
    Nc = below = ln.Nc1;
  }
  const int r = (int)k;
  x.kind = r < ln.Nr ? 0 : r < ln.Nr + Nc ? 1 : 2;
  if (x.kind == 0) {
    x.at = H + x.l * nn + (size_t)j * n + j + ln.K + r;
    x.st = n;
  } else if (x.kind == 1) {
    const int idx = r - ln.Nr;
    const int row = idx < below ? clo + idx : max(clo, j + ln.K) + idx - below;
    x.at = H + x.l * nn + (size_t)row * n + j;
  } else {
    x.at = Z + x.l * nn + (size_t)(r - ln.Nr - Nc) * n + j;
  }
  return x;
}

// A line's rotations g (open: (c1, s1) on entries 0, 1 after (c2, s2) on
// 1, 2; chain510: (c1, s1) on 0, 1).
__device__ __forceinline__ void line_rot(const double* g, int mode, double& v0, double& v1,
                                         double& v2) {
  if (mode == 0) {
    rot2(g[2], g[3], v1, v2);
    rot2(g[0], g[1], v0, v1);
  } else {
    rot2(g[0], g[1], v0, v1);
  }
}

__global__ void __launch_bounds__(kThreads)
rg_ladder_kernel(double* __restrict__ H, double* __restrict__ Z,
                 const double* __restrict__ rot, const int* __restrict__ S, int p,
                 int n, int mode, int j, int ilast, int rhi, int clo) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double smem[];
  const int K = mode == 0 ? 3 : 2;
  double* W = smem;            // K^2 p: the windows
  double* E = W + K * K * p;   // 2: H[0][j:j+2, j-1] (close)
  double* R = E + 2;           // 4: rot
  double* L = R + 4;           // 4 p: the log
  int* Sm = (int*)(L + 4 * p);  // p: S
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x;
  rhi = min(rhi, n);
  clo = max(clo, 0);

  // this thread's lines: k0, then k0 + stride, ...; the first in registers,
  // loaded before the chain
  const Lines ln(n, mode, j, ilast, rhi, clo, Z != nullptr);
  const long lines = ln.total(p);
  const long stride = (long)gridDim.x * kThreads;
  const long k0 = (long)blockIdx.x * kThreads + tid;
  const Line x0 = line_at(H, Z, ln, k0, p, n, j, clo);
  double v0 = 0.0, v1 = 0.0, v2 = 0.0;
  if (x0.at) {
    v0 = x0.at[0];
    v1 = x0.at[x0.st];
    if (K == 3) v2 = x0.at[2 * x0.st];
  }
  if (tid < 32) {
    for (int e = tid; e < K * K * p; e += 32) {
      const int g = e / (K * K), a = (e / K) % K, b = e % K;
      W[e] = H[g * nn + (size_t)(j + a) * n + j + b];
    }
    if (mode == 1 && tid < 2) E[tid] = H[(size_t)(j + tid) * n + j - 1];
    if (tid < 4) R[tid] = rot[tid];
    for (int g = tid; g < p; g += 32) Sm[g] = S[g];
  }
  __syncthreads();
  if (tid == 0) {
    const Box bx{j, n, rhi, clo};
    if (mode == 0)
      chain_open(W, L, R, Sm, p, bx, ilast);
    else
      chain510(W, E, L, R, Sm, p, mode, bx);
  }
  __syncthreads();
  if (x0.at) {
    line_rot(L + 4 * line_entry(x0.kind, x0.l, p, mode, Sm), mode, v0, v1, v2);
    x0.at[0] = v0;
    x0.at[x0.st] = v1;
    if (K == 3) x0.at[2 * x0.st] = v2;
  }
  for (long k = k0 + stride; k < lines; k += stride) {
    const Line x = line_at(H, Z, ln, k, p, n, j, clo);
    double a = x.at[0], b = x.at[x.st], c = K == 3 ? x.at[2 * x.st] : 0.0;
    line_rot(L + 4 * line_entry(x.kind, x.l, p, mode, Sm), mode, a, b, c);
    x.at[0] = a;
    x.at[x.st] = b;
    if (K == 3) x.at[2 * x.st] = c;
  }
  grid.sync();  // every block has read the windows: block 0 writes them back
  if (blockIdx.x == 0 && tid < 32) {
    for (int e = tid; e < K * K * p; e += 32) {
      const int g = e / (K * K), a = (e / K) % K, b = e % K;
      H[g * nn + (size_t)(j + a) * n + j + b] = W[e];
    }
    if (mode == 1 && tid < 2) H[(size_t)(j + tid) * n + j - 1] = E[tid];
  }
}

// ---- the parent's design, past the shared memory of the windowed one ----

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
rg_ladder_stepwise(double* __restrict__ H, double* __restrict__ Z,
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
  auto kernel = rg_ladder_kernel;
  const int K = mode == 0 ? 3 : 2;
  const size_t bytes = (size_t)(K * K * p + 6 + 4 * p) * sizeof(double) + p * sizeof(int);
  double *Hd = (double*)H, *Zd = (double*)Z;
  const double* rd = (const double*)rot;
  bool fits = false;
  cudaError_t e = psd::fit_smem(kernel, bytes, fits);
  if (e != cudaSuccess) return (int)e;
  if (!fits) {
    rg_ladder_stepwise<<<1, kThreads, 0, (cudaStream_t)stream>>>(Hd, Zd, rd, S, p, n, mode, j,
                                                                   ilast, rhi, clo);
    return (int)cudaGetLastError();
  }
  const Lines ln(n, mode, j, ilast, rhi < n ? rhi : n, clo > 0 ? clo : 0, Z != nullptr);
  const long lines = ln.total(p);
  int blocks = 1;
  e = psd::coop_blocks(kernel, kThreads, bytes, lines > 0 ? (lines + kThreads - 1) / kThreads : 1,
                       blocks);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&Hd, &Zd, &rd, &S, &p, &n, &mode, &j, &ilast, &rhi, &clo};
  return (int)cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(kThreads), args,
                                          bytes, (cudaStream_t)stream);
}

}  // extern "C"
