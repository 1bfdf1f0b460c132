// 2x2-deflation branch of the real periodic QR core, in float64.
//
// Replaces the Pallas kernel D of the JAX package's ops/pallas_deflate.py
// (_make_deflate_kernel).  Semantics: defl2's chainA / chainB of
// ops/pqr_real.py (reference src/PeriodicSchurDecompositions.jl:895-1054)
// on the ghost-padded (p, N, N) row-major stacks H and Z, rows/columns
// i-1, i.  The scalars (lanv2's rotation, jmin/jmax, the replacement and
// force-zero flags, the convergence threshold) come from the host.
//
// Bound: a serial chain of at most 20 rounds x p reflector generations;
// the data, rows and columns i-1, i of every factor, is O(p N).  What the
// chain reads is only each factor's 2x2 diagonal window W[f] = H[f][i-1:i+1,
// i-1:i+1]: every entry outside the windows takes row updates only (rows
// i-1, i right of column i) or column updates only (columns i-1, i above row
// i-1; every row of Z), one 2x2 per round at most, in an order the chain
// fixes.  So (tests/torch_ladder_host.py models it):
//   * one cooperative launch; every block stages all p windows in shared
//     memory; thread 0 runs the chain on them, one round at a time, and
//     logs each round's 2x2s;
//   * the lines outside the windows (a column of rows i-1, i; a row of
//     columns i-1, i) are spread over the grid, one a thread, and loaded
//     into registers while the chain runs; after each round's block
//     barrier they take that round's 2x2 from the log (thread 0 goes on
//     with the next round into the other half of the log); at the end they
//     are stored.  Lines past the grid (capped at the blocks the card
//     holds at once) are walked grid-stride, in place, round by round;
//   * every block runs the same deterministic chain, so all hold the same
//     final windows; block 0 writes them back after a grid barrier, once
//     every block has read them.  No state outlives a launch, so launches
//     on two streams may overlap.
// The 2x2s are written out as the parent compiled them (its SASS): y0 =
// fma(A, x0, B x1), y1 = fma(C, x0, D x1); the reflector entries 1 - tau,
// -(tau w1) and fma(-tau, w1 w1, 1).  So H and Z are bit for bit the
// parent's.  Past the shared memory a block can have (12 p doubles), the
// parent's design runs (deflate2x2_stepwise: one block, a barrier around
// every 2-row or 2-column update).
// Without T (want_t=False) the caller bounds the lines: the row updates
// stop before column chi and the column updates of H start at row rlo
// (Z's take every row), in both designs.  The windows lie inside any
// bound, so a bounded launch drops whole lines and leaves the others bit
// for bit as the unbounded one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // one line a thread
constexpr int kRounds = 20;    // chainB's cap

// (x0, x1) <- (A x0 + B x1, C x0 + D x1) of M = (A, B, C, D), the parent's form
__device__ __forceinline__ void op2(const double* M, double& x0, double& x1) {
  const double y0 = __fma_rn(M[0], x0, __dmul_rn(M[1], x1));
  const double y1 = __fma_rn(M[2], x0, __dmul_rn(M[3], x1));
  x0 = y0;
  x1 = y1;
}

__device__ __forceinline__ void put4(double* S, double a, double b, double c, double d) {
  S[0] = a;
  S[1] = b;
  S[2] = c;
  S[3] = d;
}

// Log slot (factor) of the 2x2 a line takes in a round, -1: none.  kind 0:
// H[f]'s rows i-1, i right of column i; 1: H[f]'s columns i-1, i above row
// i-1; 2: Z[f]'s columns i-1, i.  chainA: reflector f-1 on H[f]'s rows and
// Z[f], f on H[f]'s columns; chainB: slot 0 (the round's rotation) on H[0]'s
// rows, Z[0] and H[tgt]'s columns, reflector f on H[f]'s rows and Z[f] and
// on H[f-1]'s columns.
__device__ __forceinline__ int line_slot(int kind, int f, int p, int jmin, int fmin) {
  if (jmin >= 1) {
    const int g = kind == 1 ? f : f - 1;
    return (g >= 0 && g <= jmin - 2) ? g : -1;
  }
  const int tgt = p > 1 ? p - 1 : 0;
  if (kind == 1 ? f == tgt : f == 0) return 0;
  const int g = kind == 1 ? f + 1 : f;
  return (g >= fmin && g <= p - 1) ? g : -1;
}

// A factor's window in registers, x[2a + b] = H[f][i-1+a][i-1+b].
struct Win {
  double x[4];
  __device__ __forceinline__ void load(const double* w) {
    x[0] = w[0], x[1] = w[1], x[2] = w[2], x[3] = w[3];
  }
  __device__ __forceinline__ void store(double* w) const {
    w[0] = x[0], w[1] = x[1], w[2] = x[2], w[3] = x[3];
  }
  __device__ __forceinline__ void rows(const double* M) {  // rows i-1, i
    op2(M, x[0], x[2]);
    op2(M, x[1], x[3]);
  }
  __device__ __forceinline__ void cols(const double* M) {  // columns i-1, i
    op2(M, x[0], x[1]);
    op2(M, x[2], x[3]);
  }
};

// Thread 0: one round of the chain on the windows W (W[4f + 2a + b] =
// H[f][i-1+a][i-1+b]; each factor's in registers, the next one's loaded
// while it runs), its 2x2s into the slots of L; returns whether it is the
// last.
__device__ bool chain_round(double* W, double* L, int p, int jmin, int fmin,
                            bool replace, double cs0, double sn0, double thr) {
  double tau, beta, w1, w2;
  Win cur, nx;
  if (jmin >= 1) {  // chainA: annihilate H[f][i, i-1] from the right, f <= jmin-2
    cur.load(W);
    for (int f = 0; f <= jmin - 2; ++f) {
      nx.load(W + 4 * (f + 1));
      psd::gen_reflector(cur.x[3], cur.x[2], 0.0, tau, beta, w1, w2);
      const double m1 = -__dmul_rn(tau, w1);
      double* M = L + 4 * f;  // column pair (i-1, i): reflector vector (w1, 1)
      put4(M, __fma_rn(-tau, __dmul_rn(w1, w1), 1.0), m1, m1, 1.0 - tau);
      cur.x[2] = 0.0;
      cur.x[3] = beta;
      op2(M, cur.x[0], cur.x[1]);  // row i-1 of the column update
      nx.rows(M);                  // H[f+1]'s rows i-1, i
      cur.store(W + 4 * f);
      cur = nx;
    }
    if (jmin >= 2) cur.store(W + 4 * (jmin - 1));
    return true;
  }
  double c = cs0, s = sn0;
  cur.load(W);
  if (replace) psd::givens(cur.x[0], cur.x[2], c, s);
  put4(L, c, s, -s, c);  // rows by lmat(c, s), columns by rmat_adj(c, s): one 2x2
  cur.rows(L);
  if (p == 1) {  // tgt = 0: the columns after the rows
    cur.cols(L);
    cur.store(W);
    return !replace || fabs(cur.x[2]) < thr;
  }
  cur.store(W);
  cur.load(W + 4 * (p - 1));  // tgt = p-1
  cur.cols(L);
  int at = p - 1;
  for (int f = p - 1; f >= fmin; --f) {
    nx.load(W + 4 * (f - 1));
    psd::gen_reflector(cur.x[0], cur.x[2], 0.0, tau, beta, w1, w2);
    const double m1 = -__dmul_rn(tau, w1);
    double* M = L + 4 * f;  // reflector vector (1, w1)
    put4(M, 1.0 - tau, m1, m1, __fma_rn(-tau, __dmul_rn(w1, w1), 1.0));
    cur.x[0] = beta;
    cur.x[2] = 0.0;
    op2(M, cur.x[1], cur.x[3]);  // rows i-1, i from column i
    nx.cols(M);                  // H[f-1]'s columns i-1, i
    cur.store(W + 4 * f);
    cur = nx;
    at = f - 1;
  }
  cur.store(W + 4 * at);
  return !replace || fabs(W[2]) < thr;
}

// A line outside the windows: a column right of column i of H[f]'s rows
// i-1, i (kind 0), a row above row i-1 of H[f]'s columns i-1, i (kind 1) or
// a row of Z[f]'s (kind 2); at: its first entry (nullptr: none, or a line
// that takes no 2x2), st: the stride to its second, slot: its log slot.
struct Line {
  double* at = nullptr;
  int st = 1, slot = -1;
};

// Line k of the p (Nr + Nc + Nz) lines, Nr = chi-1-i (the columns i+1 ..
// chi-1), Nc = i-1-rlo (the rows rlo .. i-2).
__device__ __forceinline__ Line line_at(double* H, double* Z, long k, int p, int N, int i,
                                        int rlo, int chi, int jmin, int fmin) {
  const int Nr = chi - 1 - i, Nc = i - 1 - rlo, Lf = Nr + Nc + (Z ? N : 0);
  Line ln;
  if (Lf == 0 || k >= (long)p * Lf) return ln;
  const int f = (int)(k / Lf), r = (int)(k % Lf);
  const int kind = r < Nr ? 0 : r < Nr + Nc ? 1 : 2;
  ln.slot = line_slot(kind, f, p, jmin, fmin);
  if (ln.slot < 0) return ln;
  const size_t NN = (size_t)N * N;
  if (kind == 0) {
    ln.at = H + f * NN + (size_t)(i - 1) * N + i + 1 + r;
    ln.st = N;
  } else {
    const int row = kind == 1 ? rlo + r - Nr : r - Nr - Nc;
    ln.at = (kind == 1 ? H : Z) + f * NN + (size_t)row * N + i - 1;
  }
  return ln;
}

__global__ void __launch_bounds__(kThreads)
deflate2x2_kernel(double* __restrict__ H, double* __restrict__ Z, int p, int N, int i,
                  int jmin, int jmax, int replace0, int finzero, double cs0, double sn0,
                  double thr, int rlo, int chi) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double smem[];
  double* W = smem;         // 4 p: the windows
  double* L = smem + 4 * p;  // 2 x 4 p: two rounds' 2x2s, slot f at 4 f
  int* s_last = (int*)(smem + 12 * p);  // 2: whether a round is the last
  const size_t NN = (size_t)N * N;
  const int tid = threadIdx.x;
  const int fmin = max(1, jmax + 1);

  // this thread's lines: k0, then k0 + stride, ...; the first in registers,
  // loaded before the chain
  const long lines = (long)p * ((chi - 1 - i) + (i - 1 - rlo) + (Z ? N : 0));
  const long stride = (long)gridDim.x * kThreads;
  const long k0 = (long)blockIdx.x * kThreads + tid;
  const Line ln = line_at(H, Z, k0, p, N, i, rlo, chi, jmin, fmin);
  double v0 = 0.0, v1 = 0.0;
  if (ln.at) {
    v0 = ln.at[0];
    v1 = ln.at[ln.st];
  }
  if (tid < 32) {
    for (int e = tid; e < 4 * p; e += 32)
      W[e] = H[(e >> 2) * NN + (size_t)(i - 1 + ((e >> 1) & 1)) * N + i - 1 + (e & 1)];
  }
  __syncthreads();
  bool replace = replace0 != 0;
  for (int round = 0;; ++round) {
    double* Lr = L + (round & 1) * 4 * p;
    if (tid == 0) {
      bool last = chain_round(W, Lr, p, jmin, fmin, replace, cs0, sn0, thr);
      replace = true;
      if (round == kRounds - 1) last = true;
      if (last && jmin < 1) {
        if (finzero) W[2] = 0.0;
        if (jmax >= 1) W[4 * jmax + 2] = 0.0;
      }
      s_last[round & 1] = last;
    }
    __syncthreads();
    if (ln.at) op2(Lr + 4 * ln.slot, v0, v1);
    for (long k = k0 + stride; k < lines; k += stride) {
      const Line x = line_at(H, Z, k, p, N, i, rlo, chi, jmin, fmin);
      if (!x.at) continue;
      double x0 = x.at[0], x1 = x.at[x.st];
      op2(Lr + 4 * x.slot, x0, x1);
      x.at[0] = x0;
      x.at[x.st] = x1;
    }
    if (s_last[round & 1]) break;
  }
  if (ln.at) {
    ln.at[0] = v0;
    ln.at[ln.st] = v1;
  }
  grid.sync();  // every block has read the windows: block 0 writes them back
  if (blockIdx.x == 0 && tid < 32) {
    for (int e = tid; e < 4 * p; e += 32)
      H[(e >> 2) * NN + (size_t)(i - 1 + ((e >> 1) & 1)) * N + i - 1 + (e & 1)] = W[e];
  }
}

// ---- the parent's design, past the shared memory of the windowed one ----

// rows k0, k0+1 of A, columns [lo, hi): (x, y) <- M (x, y)
__device__ __forceinline__ void rows2(double* A, int N, int k0, int lo, int hi,
                                      const double* M) {
  double* r0 = A + (size_t)k0 * N;
  for (int c = lo + threadIdx.x; c < hi; c += blockDim.x) {
    const double x = r0[c], y = r0[c + N];
    r0[c] = M[0] * x + M[1] * y;
    r0[c + N] = M[2] * x + M[3] * y;
  }
}

// columns j0, j0+1 of A, rows [lo, hi): (a, b) <- (a, b) M
__device__ __forceinline__ void cols2(double* A, int N, int j0, int lo, int hi,
                                      const double* M) {
  for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    double* e = A + (size_t)r * N + j0;
    const double a = e[0], b = e[1];
    e[0] = a * M[0] + b * M[2];
    e[1] = a * M[1] + b * M[3];
  }
}

__global__ void __launch_bounds__(kThreads)
deflate2x2_stepwise(double* __restrict__ H, double* __restrict__ Z, int p, int N,
                    int i, int jmin, int jmax, int replace0, int finzero,
                    double cs0, double sn0, double thr, int rlo, int chi) {
  __shared__ double M[4];
  __shared__ double G[4];
  __shared__ int done;
  const size_t NN = (size_t)N * N;
  const int tid = threadIdx.x;

  if (jmin >= 1) {
    for (int f = 0; f <= jmin - 2; ++f) {
      double* Hf = H + f * NN;
      if (tid == 0) {
        double tau, beta, w1, w2;
        psd::gen_reflector(Hf[(size_t)i * N + i], Hf[(size_t)i * N + i - 1],
                           0.0, tau, beta, w1, w2);
        M[0] = 1.0 - tau * (w1 * w1);
        M[1] = -tau * (w1 * 1.0);
        M[2] = -tau * (1.0 * w1);
        M[3] = 1.0 - tau * (1.0 * 1.0);
        Hf[(size_t)i * N + i - 1] = 0.0;
        Hf[(size_t)i * N + i] = beta;
      }
      __syncthreads();
      cols2(Hf, N, i - 1, rlo, i, M);
      rows2(H + (f + 1) * NN, N, i - 1, i - 1, chi, M);
      if (Z) cols2(Z + (f + 1) * NN, N, i - 1, 0, N, M);
      __syncthreads();
    }
    return;
  }

  const int tgt = (p > 1) ? p - 1 : 0;
  bool replace = replace0 != 0;
  for (int round = 0; round < kRounds; ++round) {
    if (tid == 0) {
      double c = cs0, s = sn0;
      if (replace)
        psd::givens(H[(size_t)(i - 1) * N + i - 1], H[(size_t)i * N + i - 1], c,
                    s);
      G[0] = c;   // lmat(c, s) = [[c, s], [-s, c]]
      G[1] = s;
      G[2] = -s;
      G[3] = c;
      M[0] = c;   // rmat_adj(c, s) = [[c, -s], [s, c]]
      M[1] = -s;
      M[2] = s;
      M[3] = c;
    }
    __syncthreads();
    rows2(H, N, i - 1, i - 1, chi, G);
    __syncthreads();  // p == 1: the column update below reads these rows
    cols2(H + tgt * NN, N, i - 1, rlo, i + 1, M);
    if (Z) cols2(Z, N, i - 1, 0, N, M);
    __syncthreads();
    for (int f = p - 1; f >= 1 && f >= jmax + 1; --f) {
      double* Hf = H + f * NN;
      if (tid == 0) {
        double tau, beta, w1, w2;
        psd::gen_reflector(Hf[(size_t)(i - 1) * N + i - 1],
                           Hf[(size_t)i * N + i - 1], 0.0, tau, beta, w1, w2);
        M[0] = 1.0 - tau * (1.0 * 1.0);
        M[1] = -tau * (1.0 * w1);
        M[2] = -tau * (w1 * 1.0);
        M[3] = 1.0 - tau * (w1 * w1);
        Hf[(size_t)(i - 1) * N + i - 1] = beta;
        Hf[(size_t)i * N + i - 1] = 0.0;
      }
      __syncthreads();
      rows2(Hf, N, i - 1, i, chi, M);
      cols2(H + (f - 1) * NN, N, i - 1, rlo, i + 1, M);
      if (Z) cols2(Z + f * NN, N, i - 1, 0, N, M);
      __syncthreads();
    }
    if (tid == 0) {
      const double sub = fabs(H[(size_t)i * N + i - 1]);
      done = (!replace) || (sub < thr);
    }
    __syncthreads();
    replace = true;
    if (done) break;
  }
  if (tid == 0) {
    if (finzero) H[(size_t)i * N + i - 1] = 0.0;
    if (jmax >= 1) H[jmax * NN + (size_t)i * N + i - 1] = 0.0;
  }
}

}  // namespace

extern "C" {

// Kernel D, in place on H and (when Z != NULL) Z, H's row updates on the
// columns < chi (i + 1 <= chi <= N) and its column updates on the rows >=
// rlo (0 <= rlo <= i - 1; the want_t=False window: i + 1 and i - 1).
int psd_deflate2x2_bounded(double* H, double* Z, int p, int N, int i, int jmin, int jmax,
                           int replace0, int finzero, double cs0, double sn0, double thr,
                           int rlo, int chi, void* stream) {
  if (rlo < 0 || rlo > i - 1 || chi < i + 1 || chi > N) return (int)cudaErrorInvalidValue;
  auto kernel = deflate2x2_kernel;
  const size_t bytes = (size_t)12 * p * sizeof(double) + 2 * sizeof(int);
  bool fits = false;
  cudaError_t e = psd::fit_smem(kernel, bytes, fits);
  if (e != cudaSuccess) return (int)e;
  if (!fits) {
    deflate2x2_stepwise<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        H, Z, p, N, i, jmin, jmax, replace0, finzero, cs0, sn0, thr, rlo, chi);
    return (int)cudaGetLastError();
  }
  const long lines = (long)p * ((chi - 1 - i) + (i - 1 - rlo) + (Z ? N : 0));
  int blocks = 1;
  e = psd::coop_blocks(kernel, kThreads, bytes, lines > 0 ? (lines + kThreads - 1) / kThreads : 1,
                       blocks);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&H,   &Z,   &p,   &N,   &i,   &jmin, &jmax, &replace0,
                  &finzero, &cs0, &sn0, &thr, &rlo, &chi};
  return (int)cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(kThreads), args,
                                          bytes, (cudaStream_t)stream);
}

// Kernel D on every line.
int psd_deflate2x2(double* H, double* Z, int p, int N, int i, int jmin, int jmax,
                   int replace0, int finzero, double cs0, double sn0, double thr,
                   void* stream) {
  return psd_deflate2x2_bounded(H, Z, p, N, i, jmin, jmax, replace0, finzero, cs0, sn0, thr,
                                0, N, stream);
}

}  // extern "C"
