// Francis double-shift sweep of the real periodic QR core, in float64.
//
// Replaces the Pallas kernels of the JAX package's ops/pallas_sweep.py:
//   sweep_generate     <- _make_sweep_kernel    (kernel A)
//   sweep_generate_mb  <- _make_sweep_kernel_mb (kernel A, NB bulges)
//   sweep_left         <- _make_left_kernel     (kernel B0)
//   sweep_right        <- _make_apply_kernel    (kernel B, with and without Z)
// Semantics: chase_step of ops/pqr_real.py (reference
// src/PeriodicSchurDecompositions.jl:806-886) on the ghost-padded (p, N, N)
// row-major stacks H and Z, window k = m..i-1.
//
// sweep_generate is a serial latency chain: (i-m)*p reflector generations,
// each depending on the previous one through the matrix entries.  It logs
// one fused 3x3 transform F per (factor, step) in R (p, N, 9), row-major:
//   factor 0: the bulge reflector M3;  factor f >= 1: F = M3b diag(1, M2).
// It reads H only (B0 and B apply the log to H afterwards) and runs in ONE
// block, in batches of L steps (L <= 30, set from p by the shared memory a
// block may take):
// * the look-ahead window: for a batch k0..k1-1 each factor keeps rows
//   k0..k0+L+2 and columns k0-1..k0+L+1 (both cut at i+1) of its working
//   state in dynamic shared memory: every entry the batch's generations
//   read or its transforms write on the way there;
// * serial phase: one warp runs the batch's L steps x p factors in the
//   reference order on the windows only: lane 0 generates, the lanes apply
//   F^T to rows k..k+2 of the window's columns (lanes as columns) and F to
//   the band of the next factor (lanes as rows), with __syncwarp between;
// * update phase: the columns right of the window receive no right
//   transform in the batch, only left ones, so the whole block applies the
//   batch's L left transforms of each factor to them at its end, in step
//   order.  Each thread walks one (factor, column) with a three-row
//   register window, as B0 does: the two rows still in flux come from a
//   2 p N scratch (or from H at the first batch) and go back there, or into
//   the next window when the column enters it; the rows below come fresh
//   from H, which no transform has touched there yet.  Columns right of
//   i+1 are never read by a generation and are not visited.
// Every entry therefore receives the same operations in the same order as
// in the reference order on a full working copy (tests/torch_window_host.py
// models both schedules and checks that their logs agree bit for bit), and
// the chain waits on no global memory and no block barrier: one
// __syncthreads pair per batch.  Where even L = 1 does not fit in shared
// memory (p above about 850), the same kernel keeps the windows in a
// global scratch.  What bounds it on an H100: the generation itself.
// Measured with clock64 at p=16, n=512 (scripts/profile_sweep_generate.py):
// 3530 cycles per (step, factor), 2971 of them lane 0's generation, whose
// float64 divisions (~124 cycles each) and square roots (~91) run one
// after the other; the update phases took 6% of the kernel.  Spreading a
// reflector's independent divisions over lanes (shuffles) was slower.
//
// sweep_generate_mb chases NB such bulges in one pass, bulge b GAP columns
// behind bulge b-1 (tick kk puts bulge b at k = kk - b*GAP), in the order of
// the numpy oracle ref_sweep_np_mb (tests of the JAX package): per tick,
// factor 0 and then p-1..1, the bulges' generations, then their left
// transforms and band updates.  What differs from one bulge: the forced
// structural columns are kept (a trailing bulge reads them when it reaches
// those columns), the band updates reach lowext = (NB-1)*GAP rows further
// up (a trailing bulge's left transform mixes its rows across the leading
// bulges' columns), and a trailing bulge's first column comes from the
// leading 3x3 of the cycle product at its introduction tick (unscaled: the
// port's band is float64, so the JAX kernel's power-of-two scale schedule
// is identically 1 here).  Logs: R (NB, p, N, 9), bulge b's slice laid out
// as the one-bulge log.  It reads H only and runs in one block of
// kMbThreads threads, on kernel A's look-ahead window
// (tests/torch_mb_window_host.py models both schedules):
// * windows: for a batch of L ticks kk0..kk0+L-1 each factor keeps rows
//   max(m, kk0-lowext)..kk0+L+2 and columns one further left to kk0+L+1
//   (cut at i+1), (L+lowext+3)^2 doubles, and the batch's NB x L
//   transforms, in dynamic shared memory (L from p, NB and GAP; global
//   memory where even L = 1 does not fit);
// * serial phase: steps (tick, factor) in the reference order.  Lanes
//   0..NB-1 of warp 0 generate the step's NB transforms at once.  With
//   p >= 3 lanes 16.. then apply the band rows the next generation reads,
//   and warps 1..3 apply the rest of the step's updates while warp 0
//   generates the next step, one barrier of warps 0..3 per step; with
//   p <= 2 warp 0 applies them itself;
// * update phase: the columns right of the window receive only left
//   transforms in a batch.  Those that enter the next window take them at
//   the batch's end; the others during the next batch, on the warps from 5
//   on that do not share warp 0's scheduler, from a copy of the batch's
//   transforms in the scratch.  One thread per (factor, column) applies
//   them in bulge-major order, in a walk skewed as B0's, the rows handed
//   from bulge to bulge in registers and those still in flux kept in a ring
//   of a power of two >= lowext + 3 rows per column in the scratch; columns
//   right of i+1 are never visited.
// Every entry of the windows receives the same operations in the same order
// as on a full working copy, and the sums are written out with __fma_rn /
// __dmul_rn in the forms nvcc gave the design before the window (its SASS,
// and its logs for lead_v0's running product), so the logs are that
// design's bit for bit (scripts/time_sweep_generate.py --mb prints their
// hashes).
//
// sweep_left and sweep_right apply the log to H (and Z) with full
// parallelism, one thread per column or row, through tiles staged in shared
// memory by cp.async; they are bound by memory traffic (see the note above
// sweep_left_kernel).  With NB > 1 they run the bulges' logs in one pass,
// bulge b two steps behind bulge b-1, which gives every entry the
// operations of the bulge-major order (bulge 0's whole log, then bulge
// 1's).  Deferring the left and right products past the generation is
// exact because left and right multiplications commute, and bulge-major
// order is exact because with GAP >= 3 a transform of bulge b commutes
// with every later transform of the bulges ahead of it; the reference's
// forced zeros re-emerge as roundoff below the (sub)diagonal, and
// sweep_right writes them as exact zeros.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>

#include "psd_common.cuh"

namespace {

constexpr int kGenThreads = 512;
constexpr int kMaxBatch = 30;  // kernel A: L + 2 <= 32 window columns, one per lane
constexpr int kMaxNb = 4;  // bulges of sweep_generate_mb (shift window 2 NB <= 8)
constexpr int kMbThreads = 384;  // A-mb's block: warp 0 generates, the others update

// v0 of the leading bulge and the shifts (rt1r, rt1i, rt2r) of the others,
// passed by value
struct MbShifts {
  double v0[3];
  double sig[3 * kMaxNb];
};

// out_r = sum_s F[s][r] * x_s   (F^T applied to a 3-vector)
__device__ __forceinline__ void apply_ft(const double* F, double x0, double x1,
                                         double x2, double& o0, double& o1,
                                         double& o2) {
  o0 = F[0] * x0 + F[3] * x1 + F[6] * x2;
  o1 = F[1] * x0 + F[4] * x1 + F[7] * x2;
  o2 = F[2] * x0 + F[5] * x1 + F[8] * x2;
}

// F applied to a row's entries in columns k..k+2: out_c = sum_s y_s F[s][c]
__device__ __forceinline__ void apply_f(const double* F, double y0, double y1,
                                        double y2, double& o0, double& o1,
                                        double& o2) {
  o0 = y0 * F[0] + y1 * F[3] + y2 * F[6];
  o1 = y0 * F[1] + y1 * F[4] + y2 * F[7];
  o2 = y0 * F[2] + y1 * F[5] + y2 * F[8];
}

// Factor 0's bulge reflector M3 from (x0, x1, x2) (x2 dropped unless nr3).
__device__ __forceinline__ void gen_bulge(double x0, double x1, double x2,
                                          bool nr3, double* M, double& beta) {
  double tau, w1, w2;
  psd::gen_reflector(x0, x1, nr3 ? x2 : 0.0, tau, beta, w1, w2);
  psd::refl_mat3(tau, w1, w2, M);
}

// Factor f >= 1 at step k: the 3-reflector of column k (a0..a2, rows
// k..k+2) and, when nr3, the 2-reflector of column k+1 (b0..b2) after it,
// fused: F = M3b diag(1, M2).  beta, betab: the images (beta, 0, 0) of
// column k and (betab, 0) of column k+1's rows k+1..k+2.
__device__ __forceinline__ void gen_fused(double a0, double a1, double a2,
                                          double b0, double b1, double b2,
                                          bool nr3, double* F, double& beta,
                                          double& betab) {
  double M3[9];
  gen_bulge(a0, a1, a2, nr3, M3, beta);
  double M2[4] = {1.0, 0.0, 0.0, 1.0};
  betab = 0.0;
  if (nr3) {
    const double y1 = M3[3] * b0 + M3[4] * b1 + M3[5] * b2;
    const double y2 = M3[6] * b0 + M3[7] * b1 + M3[8] * b2;
    double t2, u1, u2;
    psd::gen_reflector(y1, y2, 0.0, t2, betab, u1, u2);
    M2[0] = 1.0 - t2 * (1.0 * 1.0);
    M2[1] = -t2 * (1.0 * u1);
    M2[2] = -t2 * (u1 * 1.0);
    M2[3] = __fma_rn(-t2, __dmul_rn(u1, u1), 1.0);
  }
  // M2[3] and the fused columns with their multiply-adds written out: the
  // forms nvcc chose for them in the kernels before the look-ahead window
  // (the logs agree bit for bit with those kernels'); left to contraction,
  // the choice changed with the inlining context
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    F[r * 3 + 0] = M3[r * 3 + 0];
    F[r * 3 + 1] = __fma_rn(M3[r * 3 + 1], M2[0], __dmul_rn(M3[r * 3 + 2], M2[2]));
    F[r * 3 + 2] = __fma_rn(M3[r * 3 + 2], M2[3], __dmul_rn(M3[r * 3 + 1], M2[1]));
  }
}

// Kernel A's working set for batch length L, in doubles: per factor the
// (L+3) x (L+3) window, the batch's L transforms and the 3x3 corner handed
// to the next batch.
inline size_t gen_window_doubles(int p, int L) {
  return (size_t)p * ((size_t)(L + 3) * (L + 3) + 9 * (size_t)L + 9);
}

// Serial phase of the batch k0..k1-1, on warp 0.  win: the p windows
// (factor f's entry (r, c) at win[(f S + r - k0) S + c - k0 + 1], S = L+3);
// fs: the batch's transforms (factor f, step k0+s at fs[(f L + s) 9]);
// stage: the next batch's corners.  Warp-synchronous: __syncwarp only.
__device__ void gen_serial(double* win, double* fs, double* stage,
                           double* __restrict__ R, int p, int N, int m, int i,
                           int L, int k0, int k1, double v00, double v01,
                           double v02) {
  const int lane = threadIdx.x & 31;
  const int S = L + 3;
  const size_t SS = (size_t)S * S;
  const int bmax = min(k0 + L + 1, i + 1) - k0 + 1;  // the last window column
  const int tgt0 = (p > 1) ? p - 1 : 0;
  for (int k = k0; k < k1; ++k) {
    const int s = k - k0;
    const bool nr3 = (i - k + 1) >= 3;
    const int nrow = min(k + 3, i) - k + 1;  // band rows k..min(k+3, i)
    for (int q = 0; q < p; ++q) {
      const int f = (q == 0) ? 0 : p - q;  // factor 0, then p-1..1
      double* Wf = win + f * SS;
      double* F = fs + ((size_t)f * L + s) * 9;
      double betab = 0.0;
      if (lane == 0) {  // lane 0 generates; F goes to the log and to fs
        double M[9], beta;
        if (f == 0) {
          double x0 = v00, x1 = v01, x2 = v02;
          if (k > m) {  // column k-1, rows k..k+2
            x0 = Wf[s * S + s];
            x1 = Wf[(s + 1) * S + s];
            x2 = Wf[(s + 2) * S + s];
          }
          gen_bulge(x0, x1, x2, nr3, M, beta);
        } else {
          const double* ck = Wf + s * S + s + 1;  // column k, rows k..k+2
          gen_fused(ck[0], ck[S], ck[2 * S], ck[1], ck[S + 1], ck[2 * S + 1], nr3,
                    M, beta, betab);
        }
        double* Rk = R + ((size_t)f * N + k) * 9;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          F[t] = M[t];
          Rk[t] = M[t];
        }
      }
      __syncwarp();
      betab = __shfl_sync(0xffffffffu, betab, 0);
      // left: F^T on rows k..k+2 of the window's columns >= k (factor 0) or
      // >= k+1; the second reflector's column k+1 takes its exact image
      const int bl = (f == 0) ? s + 1 : s + 2;
      for (int b = bl + lane; b <= bmax; b += 32) {
        double* x = Wf + s * S + b;
        double o0, o1, o2;
        apply_ft(F, x[0], x[S], x[2 * S], o0, o1, o2);
        if (f > 0 && nr3 && b == s + 2) {
          o1 = betab;
          o2 = 0.0;
        }
        x[0] = o0;
        x[S] = o1;
        x[2 * S] = o2;
      }
      // right: F on columns k..k+2 of the next factor's band rows (the same
      // window when p == 1, after the left update)
      if (p == 1) __syncwarp();
      if (lane < nrow) {
        double* y = win + (f == 0 ? tgt0 : f - 1) * SS + (s + lane) * S + s + 1;
        double o0, o1, o2;
        apply_f(F, y[0], y[1], y[2], o0, o1, o2);
        y[0] = o0;
        y[1] = o1;
        y[2] = o2;
      }
      __syncwarp();
    }
  }
  if (k1 < i) {  // rows k1..k1+2 x columns k1-1..k1+1: the next corners
    for (int t = lane; t < p * 9; t += 32) {
      const int f = t / 9, a = L + (t % 9) / 3, b = L + t % 3;
      stage[t] = win[f * SS + (size_t)a * S + b];
    }
  }
}

// Window entries (a, b) (row k0+a, column k0-1+b, up to rlast and clast)
// from H, whole block: with first, every entry of columns >= k0 (the first
// batch); else those below the corner (b <= 2, a >= 3) and below the two
// carried rows (b >= 3, a >= 2).
__device__ void fill_from_h(const double* __restrict__ H, double* win, int p,
                            int N, int L, int k0, int rlast, int clast,
                            bool first) {
  const int S = L + 3;
  const int na = rlast - k0 + 1, nb = clast - k0 + 2, per = na * nb;
  for (int t = threadIdx.x; t < p * per; t += blockDim.x) {
    const int f = t / per, a = (t % per) / nb, b = t % nb;
    if (first ? b == 0 : a < ((b <= 2) ? 3 : 2)) continue;
    win[((size_t)f * S + a) * S + b] = H[((size_t)f * N + k0 + a) * N + k0 - 1 + b];
  }
}

__global__ void __launch_bounds__(kGenThreads)
sweep_generate_kernel(const double* __restrict__ H, double* __restrict__ carry,
                      double* __restrict__ gwin, double* __restrict__ R, int p,
                      int N, int m, int i, int L, double v00, double v01,
                      double v02) {
  extern __shared__ double smem[];
  double* win = gwin ? gwin : smem;
  const int S = L + 3;
  double* fs = win + (size_t)p * S * S;
  double* stage = fs + (size_t)p * L * 9;
  int k0 = m;
  fill_from_h(H, win, p, N, L, k0, min(k0 + L + 2, i + 1), min(k0 + L + 1, i + 1),
              true);
  __syncthreads();
  for (;;) {
    const int k1 = min(k0 + L, i);
    if (threadIdx.x < 32)
      gen_serial(win, fs, stage, R, p, N, m, i, L, k0, k1, v00, v01, v02);
    if (k1 == i) break;
    __syncthreads();
    // update phase: the batch's L left transforms on columns k0+L+2..i+1
    // of every factor, one thread per (factor, column): rows k0, k0+1
    // carried (from H at the first batch), rows k0+2..k1+1 fresh from H;
    // rows k1, k1+1 go into the next window or back to the carry
    const int clast = min(k1 + L + 1, i + 1);
    const int c0 = k0 + L + 2, nc = i + 2 - c0;
    for (int t = threadIdx.x; t < p * max(nc, 0); t += blockDim.x) {
      const int f = t / nc, c = c0 + t % nc;
      const double* Hc = H + (size_t)f * N * N + c;
      double* cy = carry + (size_t)f * 2 * N + c;
      double x0 = (k0 == m) ? Hc[(size_t)k0 * N] : cy[0];
      double x1 = (k0 == m) ? Hc[(size_t)(k0 + 1) * N] : cy[N];
      const double* Ff = fs + (size_t)f * L * 9;
      for (int q = 0; q < L; ++q) {
        double o0, o1, o2;
        apply_ft(Ff + q * 9, x0, x1, Hc[(size_t)(k0 + q + 2) * N], o0, o1, o2);
        x0 = o1;
        x1 = o2;
      }
      if (c <= clast) {
        double* w = win + (size_t)f * S * S + c - k1 + 1;
        w[0] = x0;
        w[S] = x1;
      } else {
        cy[0] = x0;
        cy[N] = x1;
      }
    }
    // the rest of the next windows: the corners, then fresh rows of H
    for (int t = threadIdx.x; t < p * 9; t += blockDim.x)
      win[((size_t)(t / 9) * S + (t % 9) / 3) * S + t % 3] = stage[t];
    fill_from_h(H, win, p, N, L, k1, min(k1 + L + 2, i + 1), clast, false);
    __syncthreads();
    k0 = k1;
  }
}

// The multi-bulge kernel A-mb writes its arithmetic out with __fma_rn and
// __dmul_rn in the forms nvcc gave the design before the look-ahead window
// (read from its SASS), so that its logs do not depend on how nvcc contracts
// them here: psd::dot3 for F^T on a column's rows k..k+2 (f = F[j],
// F[3+j], F[6+j]), F on a row's columns k..k+2 and lead_v0's products (its
// running product's form is the one whose results the earlier design's
// logs reproduce).

// Shifted first column of a trailing bulge, introduced at the window top m:
// from the leading 3x3 of the cycle product C[0] C[1] ... C[p-1] at rows and
// columns m..m+2 (C0: factor 0's entry (m, m), fstride and ld the factor
// and row strides) and the bulge's shifts sg = (rt1r, rt1i, rt2r),
// normalized by its 1-norm (the JAX kernel's _lead_v0; unscaled, see the
// header).
__device__ void lead_v0(const double* C0, size_t fstride, int ld, int p, const double* sg,
                        double& x0, double& x1, double& x2) {
  double T[9] = {1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0};
  for (int f = 1; f < p; ++f) {
    const double* B = C0 + f * fstride;
    double Tn[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Tn[r * 3 + c] =
            psd::dot3(T[r * 3], T[r * 3 + 1], T[r * 3 + 2], B[c], B[ld + c], B[2 * ld + c]);
#pragma unroll
    for (int q = 0; q < 9; ++q) T[q] = Tn[q];
  }
  double P[6];  // rows 0..2, columns 0..1 of C[0] T
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      P[r * 2 + c] = psd::dot3(C0[r * ld], C0[r * ld + 1], C0[r * ld + 2], T[c], T[3 + c],
                               T[6 + c]);
  const double h11 = P[0], h12 = P[1], h21 = P[2], h22 = P[3], h32 = P[5];
  const double rt1r = sg[0], rt1i = sg[1], rt2r = sg[2];
  const double sv = fabs(h11 - rt2r) + fabs(rt1i) + fabs(h21);
  const double svs = (sv == 0.0) ? 1.0 : sv;
  const double h21s = h21 / svs;
  double v1 = __fma_rn(h21s, h12, __dmul_rn(h11 - rt1r, (h11 - rt2r) / svs));
  v1 = __fma_rn(rt1i, rt1i / svs, v1);
  const double v2 = h21s * (((h11 + h22) - rt1r) - rt2r);
  const double v3 = h21s * h32;
  const double sn = fabs(v1) + fabs(v2) + fabs(v3);
  const double sns = (sn == 0.0) ? 1.0 : sn;
  x0 = v1 / sns;
  x1 = v2 / sns;
  x2 = v3 / sns;
}

// A-mb's geometry for one batch of ticks kk0..kk1-1: per factor an S x S
// window, S = L + lowext + 3, entry (r, c) at (r - base, c - base + 1) with
// base = kk0 - lowext, holding rows top..rlast and columns top-1..clast.
struct MbBatch {
  int m, i, nb, gap, nbact, L, lowext, S;
  int kk0, kk1, base, top, rlast, clast;
  __device__ void place(int k0, int kkend) {
    kk0 = k0;
    kk1 = min(k0 + L, kkend);
    base = k0 - lowext;
    top = max(m, base);
    rlast = min(k0 + L + 2, i + 1);
    clast = min(k0 + L + 1, i + 1);
  }
  // factor f's window and the offset of entry (r, c) in it
  __device__ double* fwin(double* win, int f) const { return win + (size_t)f * S * S; }
  __device__ int off(int r, int c) const { return (r - base) * S + (c - base + 1); }
};

// Rows of the ring that holds the rows in flux of a column right of the
// windows, from the trailing bulge's k to the leading bulge's k+2: at least
// lowext + 3, a power of two (the ring is indexed by row & (rows - 1)).
__host__ __device__ inline int mb_ring_rows(int nb, int gap) {
  int w = 1;
  while (w < (nb - 1) * gap + 3) w *= 2;
  return w;
}

// Kernel A-mb's working set for batch length L, in doubles: per factor the
// S x S window and the batch's NB x L transforms.
inline size_t mb_window_doubles(int p, int nb, int gap, int L) {
  const size_t S = (size_t)L + (size_t)(nb - 1) * gap + 3;
  return (size_t)p * (S * S + 9 * (size_t)nb * L);
}

// The offset of the transform of factor f, bulge b at step s of the batch
// in fs.
__device__ __forceinline__ size_t mb_fs(const MbBatch& g, int f, int b, int s) {
  return (((size_t)f * g.nb + b) * g.L + s) * 9;
}

// o_j = x0 F[j] + x1 F[3+j] + x2 F[6+j], j = 0..2: F^T on a column's rows
// k..k+2 and F on a row's columns k..k+2.
__device__ __forceinline__ void mb_apply(const double* F, double x0, double x1, double x2,
                                         double& o0, double& o1, double& o2) {
  o0 = psd::dot3(x0, x1, x2, F[0], F[3], F[6]);
  o1 = psd::dot3(x0, x1, x2, F[1], F[4], F[7]);
  o2 = psd::dot3(x0, x1, x2, F[2], F[5], F[8]);
}

// The bulges' places at one tick, the same for every factor: bulge b at
// k[b], on the windows' row offset roff[b], active (bit b of on) when
// m <= k[b] < i, with its band rows rlo[b]..rhi[b], max(top, k - lowext)..
// min(k+3, i).
struct MbTick {
  int k[kMaxNb], roff[kMaxNb], rlo[kMaxNb], rhi[kMaxNb];
  unsigned on;
};

__device__ __forceinline__ MbTick mb_tick(const MbBatch& g, int kk) {
  MbTick t;
  t.on = 0;
#pragma unroll
  for (int b = 0; b < kMaxNb; ++b) {
    t.k[b] = kk - b * g.gap;
    t.roff[b] = (t.k[b] - g.base) * g.S;
    t.rlo[b] = max(g.top, t.k[b] - g.lowext);
    t.rhi[b] = min(t.k[b] + 3, g.i);
    if (b < g.nbact && t.k[b] >= g.m && t.k[b] < g.i) t.on |= 1u << b;
  }
  return t;
}

// Step (kk, f) of the generation on warp 0's lanes 0..nbact-1 (lane b:
// bulge b at k = kk - b gap, when m <= k < i): the bulge's transform F of
// factor f, into the log R and fs, and the entries its generation fixes:
// factor 0's forced column k-1 (beta, 0, keep), keep being the entry at
// row k+2 when k == i-1; factor f >= 1's column k, its exact image
// (beta, 0, 0), and column k+1, F^T with rows k+1..k+2 the second
// reflector's image (betab, 0) when nr3.  With crit, also the band rows
// that the next step's generation reads: F on columns k..k+2 of the
// target's rows k..k+2 (k..k+3 when the target is factor 0, whose
// generation at the next tick reads column k down to row k+3), cut at i.
__device__ __forceinline__ void mb_gen(double* win, double* fs, double* __restrict__ R, int p,
                                       int N, const MbBatch& g, const MbShifts& sh, int kk,
                                       int f, bool crit) {
  const int lane = threadIdx.x & 31, S = g.S, s = kk - g.kk0;
  const int k = kk - lane * g.gap;
  if (lane < g.nbact && k >= g.m && k < g.i) {
    const bool nr3 = (g.i - k + 1) >= 3;
    // with crit, the band rows: loaded before the generation (no one
    // writes them meanwhile), applied after it
    const int tgt = (f == 0) ? p - 1 : f - 1;
    const int nr = crit ? min((tgt == 0) ? 4 : 3, g.i - k + 1) : 0;
    double* y = g.fwin(win, tgt) + g.off(k, k);
    double v[4][3];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < nr) {
        v[r][0] = y[r * S];
        v[r][1] = y[r * S + 1];
        v[r][2] = y[r * S + 2];
      }
    double* Wf = g.fwin(win, f);
    double M[9];
    if (f == 0) {
      double x0, x1, x2, keep = 0.0, beta;
      if (k > g.m) {  // column k-1, rows k..k+2
        const double* c0 = Wf + g.off(k, k - 1);
        x0 = c0[0];
        x1 = c0[S];
        x2 = c0[2 * S];
        if (k == g.i - 1) keep = x2;
      } else if (lane == 0) {
        x0 = sh.v0[0];
        x1 = sh.v0[1];
        x2 = sh.v0[2];
      } else {
        lead_v0(Wf + g.off(g.m, g.m), (size_t)S * S, S, p, sh.sig + 3 * lane, x0, x1, x2);
      }
      gen_bulge(x0, x1, x2, nr3, M, beta);
      if (k > g.m) {  // the forced bulge column, read by the next bulge
        double* c0 = Wf + g.off(k, k - 1);
        c0[0] = beta;
        c0[S] = 0.0;
        c0[2 * S] = keep;
      }
    } else {
      double* ck = Wf + g.off(k, k);  // columns k, k+1, rows k..k+2
      const double b0 = ck[1], b1 = ck[S + 1], b2 = ck[2 * S + 1];
      double beta, betab;
      gen_fused(ck[0], ck[S], ck[2 * S], b0, b1, b2, nr3, M, beta, betab);
      ck[0] = beta;
      ck[S] = 0.0;
      ck[2 * S] = 0.0;
      ck[1] = psd::dot3(b0, b1, b2, M[0], M[3], M[6]);
      ck[S + 1] = nr3 ? betab : psd::dot3(b0, b1, b2, M[1], M[4], M[7]);
      ck[2 * S + 1] = nr3 ? 0.0 : psd::dot3(b0, b1, b2, M[2], M[5], M[8]);
    }
    double* F = fs + mb_fs(g, f, lane, s);
    double* Rk = R + (size_t)lane * p * N * 9 + ((size_t)f * N + k) * 9;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      F[q] = M[q];
      Rk[q] = M[q];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < nr) {
        y[r * S] = psd::dot3(v[r][0], v[r][1], v[r][2], M[0], M[3], M[6]);
        y[r * S + 1] = psd::dot3(v[r][0], v[r][1], v[r][2], M[1], M[4], M[7]);
        y[r * S + 2] = psd::dot3(v[r][0], v[r][1], v[r][2], M[2], M[5], M[8]);
      }
  }
}

// Step (kk, f)'s window updates of bulges b0..b1-1 as items, item e on
// the thread with e0 <= e, e = e0 mod ne: the (bulge, column) items of the
// left transforms on columns k+c0..clast (c0 = 0 for factor 0; factor f >=
// 1 starts at k+2, its columns k and k+1 being mb_gen's) when left, and the
// (bulge, row) items of the band on the target's rows rlo..rhi outside
// k..k+rc (the rows mb_gen applied; rc = -1: none) when band.  Bulges'
// rows, and their band columns, are disjoint, so the items are
// independent.
__device__ __forceinline__ void mb_items(double* win, const double* fs, int p,
                                         const MbBatch& g, const MbTick& t, int kk, int f,
                                         int b0, int b1, bool left, bool band, int rc, int e0,
                                         int ne) {
  const int S = g.S, W = g.lowext + 4, c0 = (f == 0) ? 0 : 2;
  const int nl = left ? (b1 - b0) * S : 0, n = nl + (band ? (b1 - b0) * W : 0);
  const double* Fs = fs + mb_fs(g, f, 0, kk - g.kk0);
  for (int e = e0; e < n; e += ne) {
    int b;
    double *p0, *p1, *p2;  // the item's three entries: rows k..k+2 of a column, or
                           // columns k..k+2 of a row (F^T and F: the same sums)
    if (e < nl) {
      b = b0 + e / S;
      const int c = t.k[b] + c0 + e % S;
      if (!((t.on >> b) & 1u) || c > g.clast) continue;
      p0 = g.fwin(win, f) + t.roff[b] + c - g.base + 1;
      p1 = p0 + S;
      p2 = p1 + S;
    } else {
      b = b0 + (e - nl) / W;
      const int r = t.rlo[b] + (e - nl) % W;
      if (!((t.on >> b) & 1u) || r > t.rhi[b] || (r >= t.k[b] && r <= t.k[b] + rc)) continue;
      p0 = g.fwin(win, (f == 0) ? p - 1 : f - 1) + g.off(r, t.k[b]);
      p1 = p0 + 1;
      p2 = p0 + 2;
    }
    mb_apply(Fs + b * g.L * 9, *p0, *p1, *p2, *p0, *p1, *p2);
  }
}

// Step (kk, f)'s window updates for p <= 2, on warp 0 after mb_gen, lanes
// as items; with p == 1 the band lands on the factor whose rows the next
// bulge's left update reads, so the bulges go one at a time.
__device__ __forceinline__ void mb_window_step(double* win, const double* fs, int p,
                                               const MbBatch& g, const MbTick& t, int kk,
                                               int f) {
  const int lane = threadIdx.x & 31;
  if (p > 1) {
    mb_items(win, fs, p, g, t, kk, f, 0, g.nbact, true, true, -1, lane, 32);
    return;
  }
  for (int b = 0; b < g.nbact; ++b) {
    mb_items(win, fs, p, g, t, kk, f, b, b + 1, true, false, -1, lane, 32);
    __syncwarp();
    mb_items(win, fs, p, g, t, kk, f, b, b + 1, false, true, -1, lane, 32);
    __syncwarp();
  }
}

// A-mb's warps: warp 0 generates, warps 1..kMbRestWarps apply the rest of
// each step (p >= 3), and the warps from 5 on that do not share warp 0's
// scheduler (not 4j) update the columns right of the windows a batch late.
constexpr int kMbRestWarps = 3;
__device__ __forceinline__ bool mb_lag_warp(int w) { return w > 4 && (w & 3) != 0; }

// The barrier of the step group, warps 0..kMbRestWarps.
__device__ __forceinline__ void mb_step_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(32 * (kMbRestWarps + 1)) : "memory");
}

// The rest of step (kk, f) for p >= 3 on warps 1..kMbRestWarps: its window
// updates but the band rows mb_gen applied.
__device__ __forceinline__ void mb_rest(double* win, const double* fs, int p,
                                        const MbBatch& g, const MbTick& t, int kk, int f) {
  mb_items(win, fs, p, g, t, kk, f, 0, g.nbact, true, true, (f == 1) ? 3 : 2,
           (int)threadIdx.x - 32, 32 * kMbRestWarps);
}

// One batch's ticks on the windows: per step (kk, f), in the order of the
// design before the window, warp 0 generates (mb_gen).  With p >= 3 warps
// 1..kMbRestWarps apply the rest of the step before (mb_rest) meanwhile, one
// barrier of these warps per step, and warp 0 applies only the band rows the next
// generation reads: exact, because step j's generation reads no entry that
// step j-1's rest writes (it reads its own bulge's band rows, which step
// j-1's generation wrote, and the other bulges' bands lie in other
// columns), and the two touch disjoint entries (three different factors).
// The one exception is a trailing bulge's introduction, whose lead_v0
// reads rows m..m+2 of every factor: a barrier first lets step j-1's rest
// land.  With p <= 2 warp 0 applies all of a step's window updates
// itself (mb_window_step).
__device__ __forceinline__ void mb_batch(double* win, double* fs, double* __restrict__ R,
                                         int p, int N, const MbBatch& g,
                                         const MbShifts& sh) {
  const bool piped = p >= 3;
  if (threadIdx.x >= 32 * ((piped ? kMbRestWarps : 0) + 1)) return;
  for (int kk = g.kk0; kk < g.kk1; ++kk) {
    if (piped && kk > g.m && (kk - g.m) % g.gap == 0 && (kk - g.m) / g.gap < g.nbact)
      mb_step_sync();
    const MbTick t = mb_tick(g, kk);
    for (int q = 0; q < p; ++q) {
      const int f = (q == 0) ? 0 : p - q;
      if (threadIdx.x < 32) {
        mb_gen(win, fs, R, p, N, g, sh, kk, f, piped);
        if (!piped) {
          __syncwarp();
          mb_window_step(win, fs, p, g, t, kk, f);
          __syncwarp();
        }
      }
      if (!piped) continue;
      mb_step_sync();
      if (threadIdx.x >= 32) mb_rest(win, fs, p, g, t, kk, f);
    }
  }
}

// One iteration u of the update phase's walk where every bulge takes a
// step that is neither its first in the batch nor its step i-1 (so it
// takes the row below from the bulge ahead, and hands its finished row to
// the bulge behind): bulge b's F at fb[b] + 9 u; h enters as bulge 0's row
// k+2 and leaves as the last bulge's finished row.
template <int kNb>
__device__ __forceinline__ double mb_steady(double (&x0)[kMaxNb], double (&x1)[kMaxNb],
                                            const double* const (&fb)[kMaxNb], int u,
                                            double h) {
#pragma unroll
  for (int b = 0; b < kNb; ++b) {
    double o0, o1, o2;
    mb_apply(fb[b] + 9 * u, x0[b], x1[b], h, o0, o1, o2);
    x0[b] = o1;
    x1[b] = o2;
    h = o0;
  }
  return h;
}

// Ring row r of the carried rows of a column (rc: the column's row 0).
__device__ __forceinline__ double& mb_ring_at(double* rc, int N, int mask, int r) {
  return rc[(size_t)(r & mask) * N];
}

// Update phase of one batch: the batch's left transforms on columns c0..c1
// right of its window, one thread per (factor, column) (thread e0 + j ne
// takes item j), in
// bulge-major order (exact: a bulge's rows at a tick are disjoint from the
// others', and bulge b reaches a row only after bulge b-1 has left it).
// The walk is skewed as B0's: at iteration u bulge b takes its step u - 2b
// (if it is one of its steps kb0..kb1-1 in the batch), so the row bulge b
// needs below its pair, k+2, is the one bulge b-1 finished in the same
// iteration and passes on in a register.  Each bulge carries its pair in
// registers from its first step in the batch.  The column's ring holds the
// rest: rows from the batch before (a bulge's first pair, and the rows
// below it that bulge b-1 finished then), and every row a bulge finishes
// that the next bulge does not take in this batch; H gives the rows no
// transform has touched (bulge 0's row k+2, and its first pair at m).
// With enter, the columns enter the next window nx: they take their rows
// top'..kk1+1 from the ring.
__device__ __forceinline__ void mb_update(const double* __restrict__ H,
                                          double* __restrict__ ring, double* win,
                                          const double* __restrict__ fs, int p, int N,
                                          const MbBatch& g, const MbBatch& nx, int c0, int c1,
                                          bool enter, int e0, int ne) {
  const int nc = c1 - c0 + 1;
  const int mask = mb_ring_rows(g.nb, g.gap) - 1;
  int kb0[kMaxNb + 1], kb1[kMaxNb + 1];  // bulge b's steps in the batch: kb0..kb1-1
  int u0 = 1 << 30, u1 = -(1 << 30);
  int us0 = -(1 << 30), us1 = 1 << 30;  // the iterations mb_steady takes
#pragma unroll
  for (int b = 0; b <= kMaxNb; ++b) {
    kb0[b] = max(g.m, g.kk0 - b * g.gap);
    kb1[b] = min(g.i, g.kk1 - b * g.gap);
    if (b >= g.nbact || kb0[b] >= kb1[b]) kb0[b] = kb1[b] = -(1 << 30);  // no steps
    if (kb0[b] < kb1[b]) {
      u0 = min(u0, kb0[b] + 2 * b);
      u1 = max(u1, kb1[b] - 1 + 2 * b);
    }
    if (b < g.nbact) {
      us0 = max(us0, kb0[b] + 2 * b + 1);
      us1 = min(us1, min(kb1[b], g.i - 1) - 1 + 2 * b);
    }
  }
  for (int t = e0; t < p * max(nc, 0); t += ne) {
    const int f = t / nc, c = c0 + t % nc;
    const double* Hc = H + (size_t)f * N * N + c;
    double* rc = ring + (size_t)f * (mask + 1) * N + c;
    const double* fb[kMaxNb];  // bulge b's F at iteration u: fb[b] + 9 u
#pragma unroll
    for (int b = 0; b < kMaxNb; ++b)
      fb[b] = fs + mb_fs(g, f, b, 0) + 9 * (b * (g.gap - 2) - g.kk0);
    double x0[kMaxNb], x1[kMaxNb];
#pragma unroll
    for (int b = 0; b < kMaxNb; ++b) x0[b] = x1[b] = 0.0;
    for (int u = u0; u <= u1; ++u) {
      // bulge 0's row k+2 comes from H: no transform has touched it
      const double h0 = (u < kb1[0]) ? Hc[(size_t)(u + 2) * N] : 0.0;
      if (u >= us0 && u <= us1) {
        double last;
        switch (g.nbact) {
          case 1: last = mb_steady<1>(x0, x1, fb, u, h0); break;
          case 2: last = mb_steady<2>(x0, x1, fb, u, h0); break;
          case 3: last = mb_steady<3>(x0, x1, fb, u, h0); break;
          default: last = mb_steady<4>(x0, x1, fb, u, h0); break;
        }
        mb_ring_at(rc, N, mask, u - 2 * (g.nbact - 1)) = last;
        continue;
      }
      double h = 0.0;  // the row bulge b-1 finished at this iteration, if b takes it
#pragma unroll
      for (int b = 0; b < kMaxNb; ++b) {
        const int k = u - 2 * b;
        if (k < kb0[b] || k >= kb1[b]) continue;
        if (k == kb0[b]) {  // bulge b's first step in the batch: its pair
          const bool fresh = b == 0 && g.kk0 == g.m;
          x0[b] = fresh ? Hc[(size_t)k * N] : mb_ring_at(rc, N, mask, k);
          x1[b] = fresh ? Hc[(size_t)(k + 1) * N] : mb_ring_at(rc, N, mask, k + 1);
        }
        const double x2 = (b == 0)                                   ? h0
                          : (k + 2 >= kb0[b - 1] && k + 2 < kb1[b - 1]) ? h
                                                                         : mb_ring_at(rc, N, mask, k + 2);
        double o0, o1, o2;
        mb_apply(fb[b] + 9 * u, x0[b], x1[b], x2, o0, o1, o2);
        x0[b] = o1;
        x1[b] = o2;
        h = o0;
        if (!(k - 2 >= kb0[b + 1] && k - 2 < kb1[b + 1]))  // the next bulge does not take it
          mb_ring_at(rc, N, mask, k) = o0;
        if (k == g.i - 1) {  // its last step: the next bulge reads rows i, i+1
          mb_ring_at(rc, N, mask, k + 1) = o1;
          mb_ring_at(rc, N, mask, k + 2) = o2;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kMaxNb; ++b)  // the pairs of the bulges still under way
      if (kb0[b] < kb1[b] && kb1[b] <= g.i - 1) {
        mb_ring_at(rc, N, mask, kb1[b]) = x0[b];
        mb_ring_at(rc, N, mask, kb1[b] + 1) = x1[b];
      }
    if (enter) {
      double* Wn = nx.fwin(win, f);
      for (int r = nx.top; r <= g.kk1 + 1; ++r) Wn[nx.off(r, c)] = mb_ring_at(rc, N, mask, r);
    }
  }
}

__global__ void __launch_bounds__(kMbThreads)
sweep_generate_mb_kernel(const double* __restrict__ H, double* __restrict__ ring,
                         double* __restrict__ gwin, double* __restrict__ R, int p, int N,
                         int m, int i, int nb, int gap, int nbact, int L, MbShifts sh) {
  extern __shared__ double smem[];
  double* win = gwin ? gwin : smem;
  const int lowext = (nb - 1) * gap, S = L + lowext + 3, kkend = i + (nbact - 1) * gap;
  double* fs = win + (size_t)p * S * S;
  MbBatch g{m, i, nb, gap, nbact, L, lowext, S};
  g.place(m, kkend);
  // the first windows: rows m..rlast, columns m..clast (column m-1 is
  // never read)
  {
    const int na = g.rlast - m + 1, nw = g.clast - m + 1, per = na * nw;
    for (int t = threadIdx.x; t < p * per; t += blockDim.x) {
      const int f = t / per, r = m + (t % per) / nw, c = m + t % nw;
      g.fwin(win, f)[g.off(r, c)] = H[((size_t)f * N + r) * N + c];
    }
  }
  __syncthreads();
  // the columns right of the windows take a batch's left transforms during
  // the next batch, on the lag warps, from a copy of its transforms in fsg;
  // only the columns that enter the next windows take them at its end
  double* fsg = ring + (size_t)mb_ring_rows(nb, gap) * p * N;
  const size_t nfs = (size_t)p * nb * L * 9;
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int lag_idx = 0, nlag = 0;  // the lag warps' threads
  for (int v = 5; v < nw; ++v) {
    if (v == w) lag_idx = nlag;
    nlag += mb_lag_warp(v) ? 32 : 0;
  }
  lag_idx += threadIdx.x & 31;
  MbBatch gp = g;
  bool lagging = false;
  for (;;) {
    if (lagging && mb_lag_warp(w))
      mb_update(H, ring, win, fsg, p, N, gp, g, g.clast + 1, i + 1, false, lag_idx, nlag);
    else
      mb_batch(win, fs, R, p, N, g, sh);
    __syncthreads();
    if (g.kk1 == kkend) break;
    MbBatch nx = g;
    nx.place(g.kk1, kkend);
    // the windows move down and right by L: entry (a, b) <- (a + L, b + L),
    // in rounds of ascending a S + b (each round reads, then writes, and a
    // source lies after every destination before it)
    const int D = S - L, per = D * D;
    for (int e0 = 0; e0 < p * per; e0 += blockDim.x) {
      const int e = e0 + threadIdx.x;
      double* wp = win + (size_t)(e / per) * S * S + (size_t)((e % per) / D) * S + e % D;
      double v = 0.0;
      if (e < p * per) v = wp[(size_t)L * S + L];
      __syncthreads();
      if (e < p * per) wp[0] = v;
      __syncthreads();
    }
    for (size_t t = threadIdx.x; t < nfs; t += blockDim.x) fsg[t] = fs[t];
    mb_update(H, ring, win, fs, p, N, g, nx, g.clast + 1, nx.clast, true, threadIdx.x,
              blockDim.x);
    // fresh rows of H for the rest of the next windows: below the old
    // windows' rows, and below the carried rows of the columns that enter
    for (int c = max(nx.top - 1, m) + w; c <= nx.clast; c += nw) {
      const int r0 = (c <= g.clast) ? g.rlast + 1 : g.kk1 + 2;
      for (int t = (threadIdx.x & 31); t < p * max(nx.rlast - r0 + 1, 0); t += 32) {
        const int na = nx.rlast - r0 + 1, f = t / na, r = r0 + t % na;
        nx.fwin(win, f)[nx.off(r, c)] = H[((size_t)f * N + r) * N + c];
      }
    }
    __syncthreads();
    gp = g;
    lagging = true;
    g = nx;
  }
}

// Kernels B0 and B.  Both walk lines (B0: the columns >= max(m-1, 0) of
// every H[f]; B: the rows 0..i of H[g] and all rows of Z[g]) along the
// positions m..i+1 (B0: rows, B: columns).  Step k of a line maps its
// entries (x0, x1, x2) at positions k..k+2 to
//   o_j = dot3(x0, x1, x2; F[j], F[3+j], F[6+j]),  j = 0, 1, 2
// (B0: F^T on rows, B: F on columns; the same products), writes o0 at k and
// carries (o1, o2) to the next step.  The NB logs run in one pass, bulge b
// two steps behind bulge b-1: at tick t bulge b takes its step k = t - 2b,
// which reads position k+2 just as bulge b-1 finished it (its step k+2,
// the same tick), so every entry sees bulge 0's steps, then bulge 1's, ...,
// exactly as in one walk per bulge, and the entry passes from bulge to
// bulge in a register.  A bulge outside its steps m..i-1 passes its
// entries on unchanged (a delay of two ticks), which also loads its first
// pair (x0, x1) = positions (m, m+1) and flushes its last at i, i+1.  So
// the line is read once and written once whatever NB.
//
// Each block stages its lines in chunks of kApplyChunk positions through
// a ring of shared-memory slots filled by 8-byte cp.async (16-byte ones
// would need 16-byte aligned rows, which an odd N does not give), kAhead
// chunks in flight ahead of the one in use, each chunk with the log rows
// its ticks read (NB x (kApplyChunk + 2 NB) rows of 9 doubles, staged at a
// pitch of 10 so that they load as double2).  The shared memory a block
// takes depends on these sizes and NB only, never on N or p, so no path
// with global windows is needed.  Ragged tiles, chunks and spans are
// masked; p = 1 (B's source factor (g+1) mod p = g), m = 0, i = N-2 and
// windows of one or two steps take the same code.
//
// Without T (want_t=False) the caller bounds both: B0 walks only the
// columns < chi (psd_sweep_left_bounded) and B only H's rows >= rlo
// (psd_sweep_right_bounded; Z's rows all).  Whole lines drop out, and every
// line that runs does what it does unbounded, so a bounded launch leaves
// the lines it keeps bit for bit as the unbounded one and the others as
// they were.
//
// One thread per line leaves an H100 with only ~2 (B0) or ~4 (B) walking
// warps per SM at p=16, n=512, each a latency-bound chain, so a block has
// kApplyThreads threads: warp 0 walks, and all of them issue the copies and
// (B) write finished chunks back, which would otherwise sit on the walk's
// path.  A chunk whose ticks all lie inside every bulge's steps runs from
// registers: its entries are read before its first tick and its outputs
// stored after its last, so the log rows load ahead of the arithmetic.
//
// The three-term sums are written out with __fma_rn/__dmul_rn in the order
// nvcc contracted the earlier kernels' `x0 * F[0] + x1 * F[3] + x2 * F[6]`
// (both the B0 and the B form): the middle product rounded, the first fused
// onto it, then the third.  So every entry goes through the same operations
// in the same order as before this design, bit for bit
// (scripts/time_sweep_generate.py --apply prints the hashes).
//
// B0 (replaces the JAX package's ops/pallas_sweep.py:796
// _make_left_kernel): a block owns kLeftCols columns of one factor, one per
// lane of warp 0, and walks their rows down through the ring; its stores
// are rows of consecutive columns, coalesced, straight to device memory.  B
// (replaces ops/pallas_sweep.py:988 _make_apply_kernel): a block owns
// kRightRows rows of one target, one per lane, and walks the columns;
// the row pitch in shared memory is odd, so the lanes' 8-byte accesses to
// one column of 32 rows fall in distinct banks.  A finished column goes
// back into its slot, and a chunk goes back to device memory as coalesced
// row segments once the next chunk's ticks have finished it (kApplyChunk >=
// 2 NB), with the structural zeros of H's rows m+1..i written exactly.
// What bounds both: bytes.  B0 reads the upper parts of its rows (its
// input is zero below the (sub)diagonal) and writes the rows in full: its
// chained left transforms fill every entry below the (sub)diagonal, so it
// cannot stop at a band, and B, whose input that is, reads whole rows and
// writes the zeros back.  At p=16, n=512 on [0, 511] that is 15.2 us (B0)
// and 40.2 us (B) (chip_smoke.py::apply_bounds); 15 flops per entry and
// step need ~1 us at the FP64 rate.  Measured there (NVIDIA H100 80GB
// HBM3, 700 W, scripts/time_sweep_generate.py --apply): B0 0.040 ms, B
// 0.071 ms with one log (38% and 56% of the bound; the design before, one
// walk per bulge, 0.24 and 0.36 ms), 0.103 and 0.133 ms with four (1.02
// and 2.97 ms before).

constexpr int kApplyChunk = 16;  // positions per chunk (>= 2 kMaxNb)
constexpr int kAhead = 3;        // chunks in flight ahead of the one in use
constexpr int kLeftCols = 32;    // B0: columns per block, one per thread of warp 0
constexpr int kRightRows = 32;   // B: rows per block, one per thread of warp 0
constexpr int kApplyThreads = 128;  // per block: warp 0 walks, all copy and write back
constexpr int kRightPitch = kApplyChunk + 1;  // odd: conflict-free columns
constexpr int kLogPitch = 10;    // doubles per staged log row (16-byte rows)
static_assert(kApplyChunk >= 2 * kMaxNb, "a chunk is finished by the next one's ticks");
static_assert(kRightPitch % 2 == 1, "B's row pitch must be odd");
static_assert(kApplyThreads % 32 == 0 && kApplyThreads >= kLeftCols &&
                  kApplyThreads >= kRightRows, "the walking lanes are the block's first");

// Doubles of the staged log rows of one chunk, NB bulges.
__host__ __device__ constexpr int log_slot_doubles(int nb) {
  return nb * (kApplyChunk + 2 * nb) * kLogPitch;
}

// Shared memory of B0 and B (bytes): kAhead + 1 (B0) or kAhead + 2 (B, the
// previous chunk waits for its write-back) tile slots, kAhead + 1 log slots.
constexpr size_t left_smem(int nb) {
  return sizeof(double) * ((size_t)(kAhead + 1) * kApplyChunk * kLeftCols +
                           (size_t)(kAhead + 1) * log_slot_doubles(nb));
}
constexpr size_t right_smem(int nb) {
  return sizeof(double) * ((size_t)(kAhead + 2) * kRightRows * kRightPitch +
                           (size_t)(kAhead + 1) * log_slot_doubles(nb));
}
static_assert((kApplyChunk * kLeftCols) % 2 == 0 && (kRightRows * kRightPitch) % 2 == 0,
              "the log slots must start 16-byte aligned");

// Stage the log rows chunk j's ticks read: bulge b's step k = q0 - 2 - 2b +
// s at row s < kApplyChunk + 2 NB (for every tick t of the chunk, s = t - q0
// + 2 whatever b), for the steps m..i-1 only.  src: the factor whose log.
template <int kNb>
__device__ __forceinline__ void stage_logs(double* Lg, const double* __restrict__ R,
                                           int p, int N, int src, int m, int i, int q0) {
  constexpr int LW = kApplyChunk + 2 * kNb;
  for (int e = threadIdx.x; e < kNb * LW * 9; e += blockDim.x) {
    const int b = e / (LW * 9), s = (e / 9) % LW, q = e % 9;
    const int k = q0 - 2 - 2 * b + s;
    if (k >= m && k < i)
      __pipeline_memcpy_async(Lg + (b * LW + s) * kLogPitch + q,
                              R + (((size_t)b * p + src) * N + k) * 9 + q, sizeof(double));
  }
}

// Step k of a bulge on its carried pair (x0, x1) and the entry x at
// position k+2, with the staged log row F: returns o0, carries (o1, o2).
__device__ __forceinline__ double apply_step(double& x0, double& x1, double x,
                                             const double* F) {
  const double2* F2 = reinterpret_cast<const double2*>(F);
  const double2 f01 = F2[0], f23 = F2[1], f45 = F2[2], f67 = F2[3];
  const double o0 = psd::dot3(x0, x1, x, f01.x, f23.y, f67.x);
  const double n1 = psd::dot3(x0, x1, x, f01.y, f45.x, f67.y);
  const double n2 = psd::dot3(x0, x1, x, f23.x, f45.y, F[8]);
  x0 = n1;
  x1 = n2;
  return o0;
}

// One tick t of a line: x enters bulge 0 (the entry at position t+2), each
// bulge takes its step t - 2b (or passes its entries on), and the entry that
// leaves the last bulge, at position t - 2(NB-1), is returned.  Lg: the
// chunk's staged log rows, s = t - q0 + 2; keep: the step m is the
// identity (B0's window-boundary column).
template <int kNb>
__device__ __forceinline__ double apply_tick(double x, double (&x0)[kNb], double (&x1)[kNb],
                                             const double* Lg, int s, int t, int m, int i,
                                             bool keep) {
  constexpr int LW = kApplyChunk + 2 * kNb;
#pragma unroll
  for (int b = 0; b < kNb; ++b) {
    const int k = t - 2 * b;
    double o0;
    if (k >= m && k < i && !(keep && k == m)) {
      o0 = apply_step(x0[b], x1[b], x, Lg + (b * LW + s) * kLogPitch);
    } else {
      o0 = x0[b];
      x0[b] = x1[b];
      x1[b] = x;
    }
    x = o0;
  }
  return x;
}

// A chunk's kApplyChunk ticks when every bulge is inside its steps m..i-1
// at each of them (no pass-on, no boundary column): the chunk's entries
// enter in registers (xin[u]: position q0+u) and its outputs leave in
// registers (out[u]: position q0 - 2 NB + u), so no shared-memory store
// sits between two ticks and the log rows load ahead of the arithmetic.
template <int kNb>
__device__ __forceinline__ void steady_ticks(const double (&xin)[kApplyChunk],
                                             double (&out)[kApplyChunk], double (&x0)[kNb],
                                             double (&x1)[kNb], const double* Lg) {
  constexpr int LW = kApplyChunk + 2 * kNb;
#pragma unroll
  for (int u = 0; u < kApplyChunk; ++u) {
    double x = xin[u];
#pragma unroll
    for (int b = 0; b < kNb; ++b)
      x = apply_step(x0[b], x1[b], x, Lg + (b * LW + u) * kLogPitch);
    out[u] = x;
  }
}

// The walk of one line over chunk j's ticks, and after the last chunk the
// drain that flushes the bulges' positions up to i+1.  in(u) reads the
// chunk's position q0+u; out(d, x) takes the finished entry at position
// q0+d >= m (d >= -2 NB: the chunk before).  keep: the step m is the
// identity (B0's window-boundary column).
template <int kNb, class In, class Out>
__device__ __forceinline__ void walk_chunk(int j, int nch, int m, int i, const double* Lg,
                                           bool keep, double (&x0)[kNb], double (&x1)[kNb],
                                           In in, Out out) {
  constexpr int W = kApplyChunk;
  const int q0 = m + j * W, w = min(W, i + 2 - q0);
  if (w == W && j * W > 2 * kNb && q0 + W - 2 <= i) {  // every bulge inside its steps
    double xin[W], y[W];
#pragma unroll
    for (int u = 0; u < W; ++u) xin[u] = in(u);
    steady_ticks<kNb>(xin, y, x0, x1, Lg);
#pragma unroll
    for (int u = 0; u < W; ++u) out(u - 2 * kNb, y[u]);
  } else {
    for (int t = q0 - 2; t < q0 + w - 2; ++t) {
      const double x = apply_tick<kNb>(in(t + 2 - q0), x0, x1, Lg, t + 2 - q0, t, m, i, keep);
      const int r = t - 2 * (kNb - 1);
      if (r >= m) out(r - q0, x);
    }
  }
  if (j == nch - 1) {
    for (int t = i; t < i + 2 * kNb; ++t) {
      const double x = apply_tick<kNb>(0.0, x0, x1, Lg, t + 2 - q0, t, m, i, keep);
      const int r = t - 2 * (kNb - 1);
      if (r >= m) out(r - q0, x);
    }
  }
}

// B0: rows k..k+2 of every H[f] <- F[f,k]^T rows, for k = m..i-1, for the
// logs of bulges 0..kNb-1 (log stride p N 9).  Block (x, f): the global
// columns clo + x kLeftCols + threadIdx.x < chi of H[f] (unsharded: clo =
// max(m-1, 0), chi = N, or the want_t=False window's i + 1).  H holds the
// global columns from c0 on, its rows ld doubles apart (unsharded: c0 = 0,
// ld = N; a column shard (p, N, L): ld = L).  Column m-1 of factor 0 keeps
// its value at k == m (the window-boundary subdiagonal, reference rowsk
// lo=k).
template <int kNb>
__global__ void __launch_bounds__(kApplyThreads)
sweep_left_kernel(double* __restrict__ H, const double* __restrict__ R, int p, int N,
                  int m, int i, int clo, int chi, int ld, int c0) {
  constexpr int W = kApplyChunk, NT = kAhead + 1, NL = kAhead + 1;
  extern __shared__ double smem[];
  double* tiles = smem;                             // NT x W rows x kLeftCols
  double* logs = smem + NT * W * kLeftCols;         // NL x log_slot_doubles
  const int f = blockIdx.y, tid = threadIdx.x;
  const int cb = clo + blockIdx.x * kLeftCols;  // the tile's first (global) column
  const int nc = min(kLeftCols, chi - cb);
  double* Hf = H + (size_t)f * N * ld + (cb - c0);
  const int nch = (i + 2 - m + W - 1) / W;
  auto copy = [&](int j) {  // chunk j's rows
    const int q0 = m + j * W, w = min(W, i + 2 - q0);
    double* T = tiles + (j % NT) * W * kLeftCols;
    for (int e = tid; e < w * kLeftCols; e += kApplyThreads)
      if (e % kLeftCols < nc)
        __pipeline_memcpy_async(T + e, Hf + (size_t)(q0 + e / kLeftCols) * ld + e % kLeftCols,
                                sizeof(double));
    stage_logs<kNb>(logs + (j % NL) * log_slot_doubles(kNb), R, p, N, f, m, i, q0);
  };
  const bool keep = f == 0 && cb + tid == m - 1;
  double x0[kNb], x1[kNb];
#pragma unroll
  for (int b = 0; b < kNb; ++b) x0[b] = x1[b] = 0.0;
  auto walk = [&](int j) {  // stores: rows of consecutive columns, coalesced
    const double* T = tiles + (j % NT) * W * kLeftCols + tid;
    double* out = Hf + (size_t)(m + j * W) * ld + tid;
    walk_chunk<kNb>(
        j, nch, m, i, logs + (j % NL) * log_slot_doubles(kNb), keep, x0, x1,
        [&](int u) { return T[u * kLeftCols]; },
        [&](int d, double x) {
          if (tid < nc) out[(ptrdiff_t)d * ld] = x;
        });
  };
  psd::apply_ring<kAhead>(nch, kLeftCols, copy, walk, [](int) {});
}

// B: columns k..k+2 <- columns F for k = m..i-1, for the logs of bulges
// 0..kNb-1.  H and Z hold the global rows r0..r0+nloc-1 of each factor
// (unsharded: r0 = 0, nloc = N; a row shard (p, nloc, N)).  Block (x, g,
// 0): the global rows max(rlo, r0) + x kRightRows + threadIdx.x <= i of
// H[g] that the shard holds (rlo = 0: all; the want_t=False window: its
// top row) with the log of factor (g+1) mod p, then the structural zeros of
// rows m+1..i written exactly, by global row; block (x, g, 1): the shard's
// rows of Z[g], own log.
template <int kNb>
__global__ void __launch_bounds__(kApplyThreads)
sweep_right_kernel(double* __restrict__ H, double* __restrict__ Z,
                   const double* __restrict__ R, int p, int N, int m, int i, int rlo,
                   int r0, int nloc) {
  constexpr int W = kApplyChunk, P = kRightPitch, NT = kAhead + 2, NL = kAhead + 1;
  extern __shared__ double smem[];
  double* tiles = smem;                         // NT x kRightRows x P
  double* logs = smem + NT * kRightRows * P;    // NL x log_slot_doubles
  const int g = blockIdx.y, tid = threadIdx.x;
  const bool isz = blockIdx.z == 1;
  const int rend = isz ? r0 + nloc : min(i + 1, r0 + nloc);
  const int rb = (isz ? r0 : max(rlo, r0)) + blockIdx.x * kRightRows;  // global
  if (rb >= rend) return;
  const int nr = min(kRightRows, rend - rb);
  const int src = isz ? g : (g + 1) % p;
  double* A = (isz ? Z : H) + (size_t)g * nloc * N + (size_t)(rb - r0) * N;
  const int nch = (i + 2 - m + W - 1) / W;
  auto copy = [&](int j) {  // chunk j's row segments, into chunk j-2's slot
    const int q0 = m + j * W, w = min(W, i + 2 - q0);
    double* T = tiles + (j % NT) * kRightRows * P;
    for (int e = tid; e < nr * W; e += kApplyThreads)
      if (e % W < w)
        __pipeline_memcpy_async(T + (e / W) * P + e % W, A + (size_t)(e / W) * N + q0 + e % W,
                                sizeof(double));
    stage_logs<kNb>(logs + (j % NL) * log_slot_doubles(kNb), R, p, N, src, m, i, q0);
  };
  // chunk j's finished columns back to device memory, zeros below the
  // (sub)diagonal of H's rows m+1..i in their place
  auto write_back = [&](int j) {
    const int q0 = m + j * W, w = min(W, i + 2 - q0);
    const double* T = tiles + (j % NT) * kRightRows * P;
    for (int e = tid; e < nr * W; e += kApplyThreads) {
      const int rr = e / W, cc = e % W, r = rb + rr;
      if (cc >= w) continue;
      const bool zero = !isz && r > m && q0 + cc < (g == 0 ? r - 1 : r);
      A[(size_t)rr * N + q0 + cc] = zero ? 0.0 : T[rr * P + cc];
    }
  };
  double x0[kNb], x1[kNb];
#pragma unroll
  for (int b = 0; b < kNb; ++b) x0[b] = x1[b] = 0.0;
  // a finished column goes back into its slot: this chunk's or, for the
  // positions the last bulge leaves behind (kApplyChunk >= 2 NB), the one
  // before, indexed from q0
  auto walk = [&](int j) {
    double* T = tiles + (j % NT) * kRightRows * P + tid * P;
    double* Tp = tiles + ((j + NT - 1) % NT) * kRightRows * P + tid * P + W;
    walk_chunk<kNb>(
        j, nch, m, i, logs + (j % NL) * log_slot_doubles(kNb), false, x0, x1,
        [&](int u) { return T[u]; },
        [&](int d, double x) {
          if (d >= 0) T[d] = x;
          else Tp[d] = x;
        });
  };
  psd::apply_ring<kAhead>(nch, kRightRows, copy, walk, [&](int j) {
    __syncthreads();  // chunk j-1 (and at the end chunk j) finished
    if (j >= 1) write_back(j - 1);
    if (j == nch - 1) write_back(j);
  });
  if (!isz && g == 0 && m >= 1 && tid < nr && rb + tid > m)
    A[(size_t)tid * N + m - 1] = 0.0;  // column m-1 below the subdiagonal
}

struct GenPlan {
  int L;        // batch length
  bool global;  // windows in the global scratch (p too large for shared memory)
};

// The longest batch (at most kMaxBatch) whose windows fit the shared memory
// a block of this device may take; where even L = 1 does not fit, kMaxBatch
// with the windows in global memory.
cudaError_t gen_plan(int p, GenPlan& plan) {
  int L = 0;
  const cudaError_t e = psd::longest_batch(
      kMaxBatch, [p](int l) { return gen_window_doubles(p, l) * sizeof(double); }, L);
  plan = {L > 0 ? L : kMaxBatch, L == 0};
  return e;
}

// The same for kernel A-mb, whose windows grow with (nb - 1) gap.
cudaError_t mb_plan(int p, int nb, int gap, GenPlan& plan) {
  int L = 0;
  const cudaError_t e = psd::longest_batch(
      kMaxBatch, [=](int l) { return mb_window_doubles(p, nb, gap, l) * sizeof(double); }, L);
  plan = {L > 0 ? L : kMaxBatch, L == 0};
  return e;
}

// Launch an apply kernel with `smem` bytes of shared memory.  Above 48 KB
// a kernel needs the opt-in, which holds for the device it was asked on:
// asked once per kernel and device (bit d of `asked`).
template <class Kernel, class... Args>
cudaError_t launch_apply(Kernel kernel, size_t smem, std::atomic<unsigned long long>& asked,
                         dim3 grid, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    int d = 0;
    cudaError_t e = cudaGetDevice(&d);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = 1ULL << (d % 64);
    if (!(asked.load() & bit)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      asked.fetch_or(bit);
    }
  }
  kernel<<<grid, kApplyThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int kNb>
cudaError_t launch_left(dim3 grid, cudaStream_t st, double* H, const double* R, int p,
                        int N, int m, int i, int clo, int chi, int ld, int c0) {
  static std::atomic<unsigned long long> asked{0};
  return launch_apply(sweep_left_kernel<kNb>, left_smem(kNb), asked, grid, st, H, R, p, N, m,
                      i, clo, chi, ld, c0);
}

template <int kNb>
cudaError_t launch_right(dim3 grid, cudaStream_t st, double* H, double* Z, const double* R,
                         int p, int N, int m, int i, int rlo, int r0, int nloc) {
  static std::atomic<unsigned long long> asked{0};
  return launch_apply(sweep_right_kernel<kNb>, right_smem(kNb), asked, grid, st, H, Z, R, p,
                      N, m, i, rlo, r0, nloc);
}

// B0 on the global columns [clo, chi) of H, whose rows are ld doubles apart
// and whose local column 0 is global column c0; no launch when the range
// is empty.
cudaError_t left_cols(double* H, const double* R, int p, int N, int m, int i, int nb,
                      int clo, int chi, int ld, int c0, cudaStream_t st) {
  if (chi <= clo) return cudaSuccess;
  dim3 grid((chi - clo + kLeftCols - 1) / kLeftCols, p);
  static_assert(kMaxNb == 4, "one instantiation of each apply kernel per bulge count");
  switch (nb) {
    case 1: return launch_left<1>(grid, st, H, R, p, N, m, i, clo, chi, ld, c0);
    case 2: return launch_left<2>(grid, st, H, R, p, N, m, i, clo, chi, ld, c0);
    case 3: return launch_left<3>(grid, st, H, R, p, N, m, i, clo, chi, ld, c0);
    case 4: return launch_left<4>(grid, st, H, R, p, N, m, i, clo, chi, ld, c0);
    default: return cudaErrorInvalidValue;
  }
}

// B on the rows r0..r0+nloc-1 of H (those in [rlo, i]) and of Z (all).
cudaError_t right_rows(double* H, double* Z, const double* R, int p, int N, int m, int i,
                       int nb, int rlo, int r0, int nloc, cudaStream_t st) {
  dim3 grid((nloc + kRightRows - 1) / kRightRows, p, Z ? 2 : 1);
  switch (nb) {
    case 1: return launch_right<1>(grid, st, H, Z, R, p, N, m, i, rlo, r0, nloc);
    case 2: return launch_right<2>(grid, st, H, Z, R, p, N, m, i, rlo, r0, nloc);
    case 3: return launch_right<3>(grid, st, H, Z, R, p, N, m, i, rlo, r0, nloc);
    case 4: return launch_right<4>(grid, st, H, Z, R, p, N, m, i, rlo, r0, nloc);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* psd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Doubles of the scratch kernel A takes (psd_sweep_generate's work): the
// carried rows, 2 p N, and the windows when they do not fit in shared
// memory; -1 on a CUDA error.
long long psd_sweep_generate_scratch(int p, int N) {
  GenPlan plan;
  if (gen_plan(p, plan) != cudaSuccess) return -1;
  return 2LL * p * N + (plan.global ? (long long)gen_window_doubles(p, plan.L) : 0);
}

// Kernel A.  H: (p, N, N) input (read only); work: psd_sweep_generate_scratch
// (p, N) doubles of scratch; R: (p, N, 9) output log (rows m..i-1 written).
int psd_sweep_generate(const double* H, double* work, double* R, int p, int N,
                       int m, int i, double v00, double v01, double v02,
                       void* stream) {
  GenPlan plan;
  cudaError_t e = gen_plan(p, plan);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = plan.global ? 0 : gen_window_doubles(p, plan.L) * sizeof(double);
  e = cudaFuncSetAttribute(sweep_generate_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  double* gwin = plan.global ? work + 2 * (size_t)p * N : nullptr;
  sweep_generate_kernel<<<1, kGenThreads, smem, (cudaStream_t)stream>>>(
      H, work, gwin, R, p, N, m, i, plan.L, v00, v01, v02);
  return (int)cudaGetLastError();
}

// Doubles of the scratch kernel A-mb takes (psd_sweep_generate_mb's work):
// the carried rows, mb_ring_rows(nb, gap) >= (nb - 1) gap + 3 per (factor,
// column), a copy of a batch's transforms, and the windows
// when they do not fit in shared memory; -1 on a bad configuration or a
// CUDA error.
long long psd_sweep_generate_mb_scratch(int p, int N, int nb, int gap) {
  if (nb < 1 || nb > kMaxNb || gap < 3) return -1;
  GenPlan plan;
  if (mb_plan(p, nb, gap, plan) != cudaSuccess) return -1;
  return (long long)mb_ring_rows(nb, gap) * p * N + 9LL * p * nb * plan.L +
         (plan.global ? (long long)mb_window_doubles(p, nb, gap, plan.L) : 0);
}

// Kernel A for NB bulges.  H: (p, N, N) input (read only); work:
// psd_sweep_generate_mb_scratch(p, N, nb, gap) doubles of scratch; shifts
// (host memory): v0 of bulge 0, then (rt1r, rt1i, rt2r) of each of the nb
// bulges (bulge 0's unused).  R: (nb, p, N, 9) output log, rows m..i-1 of
// slices 0..nbact-1 written.
int psd_sweep_generate_mb(const double* H, double* work, double* R, int p, int N,
                          int m, int i, int nb, int gap, int nbact,
                          const double* shifts, void* stream) {
  if (nb < 1 || nb > kMaxNb || gap < 3 || nbact < 1 || nbact > nb)
    return (int)cudaErrorInvalidValue;
  GenPlan plan;
  cudaError_t e = mb_plan(p, nb, gap, plan);
  if (e != cudaSuccess) return (int)e;
  MbShifts sh;
  for (int q = 0; q < 3; ++q) sh.v0[q] = shifts[q];
  for (int q = 0; q < 3 * kMaxNb; ++q) sh.sig[q] = (q < 3 * nb) ? shifts[3 + q] : 0.0;
  const size_t smem = plan.global ? 0 : mb_window_doubles(p, nb, gap, plan.L) * sizeof(double);
  e = cudaFuncSetAttribute(sweep_generate_mb_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  double* gwin = plan.global
                     ? work + (size_t)mb_ring_rows(nb, gap) * p * N + 9 * (size_t)p * nb * plan.L
                     : nullptr;
  sweep_generate_mb_kernel<<<1, kMbThreads, smem, (cudaStream_t)stream>>>(
      H, work, gwin, R, p, N, m, i, nb, gap, nbact, plan.L, sh);
  return (int)cudaGetLastError();
}

// Kernel B0, in place on H: the logs of bulges 0..nb-1 (stride p N 9), on
// the columns < chi (i + 1 <= chi <= N; the want_t=False window: i + 1).
int psd_sweep_left_bounded(double* H, const double* R, int p, int N, int m, int i,
                           int nb, int chi, void* stream) {
  if (chi < i + 1 || chi > N) return (int)cudaErrorInvalidValue;
  return (int)left_cols(H, R, p, N, m, i, nb, max(m - 1, 0), chi, N, 0, (cudaStream_t)stream);
}

// Kernel B0 on a column shard, in place: H (p, N, ld) holds the global
// columns c0..c0+L-1 (L <= ld, c0 + L <= N) in its local columns 0..L-1;
// the shard's columns in [max(m-1, 0), chi) take the logs, as
// psd_sweep_left_bounded takes them (bit for bit: the same kernel, given
// the stride and the offset).  No launch when the shard holds none.
int psd_sweep_left_shard(double* H, const double* R, int p, int N, int m, int i, int nb,
                         int chi, int ld, int c0, int L, void* stream) {
  if (chi < i + 1 || chi > N || c0 < 0 || L < 0 || L > ld || c0 + L > N)
    return (int)cudaErrorInvalidValue;
  return (int)left_cols(H, R, p, N, m, i, nb, max(max(m - 1, 0), c0), min(chi, c0 + L), ld,
                        c0, (cudaStream_t)stream);
}

// Kernel B0 on every column.
int psd_sweep_left(double* H, const double* R, int p, int N, int m, int i,
                   int nb, void* stream) {
  return psd_sweep_left_bounded(H, R, p, N, m, i, nb, N, stream);
}

// Kernel B, in place on H and (when Z != NULL) Z: the logs of bulges
// 0..nb-1, on H's rows rlo..i (0 <= rlo <= m; the want_t=False window: its
// top row) and every row of Z.
int psd_sweep_right_bounded(double* H, double* Z, const double* R, int p, int N, int m,
                            int i, int nb, int rlo, void* stream) {
  if (rlo < 0 || rlo > m) return (int)cudaErrorInvalidValue;
  return (int)right_rows(H, Z, R, p, N, m, i, nb, rlo, 0, N, (cudaStream_t)stream);
}

// Kernel B on a row shard, in place: H and (when Z != NULL) Z are (p, nloc,
// N) and hold the global rows r0..r0+nloc-1 (r0 + nloc <= N); the shard's
// rows of H in [rlo, i] and all its rows of Z take the logs, and its rows
// of H get the structural zeros by global row, as psd_sweep_right_bounded
// (bit for bit: the same kernel, given the offset).
int psd_sweep_right_shard(double* H, double* Z, const double* R, int p, int N, int m, int i,
                          int nb, int rlo, int r0, int nloc, void* stream) {
  if (rlo < 0 || rlo > m || r0 < 0 || nloc < 1 || r0 + nloc > N)
    return (int)cudaErrorInvalidValue;
  return (int)right_rows(H, Z, R, p, N, m, i, nb, rlo, r0, nloc, (cudaStream_t)stream);
}

// Kernel B on every row.
int psd_sweep_right(double* H, double* Z, const double* R, int p, int N, int m,
                    int i, int nb, void* stream) {
  return psd_sweep_right_bounded(H, Z, R, p, N, m, i, nb, 0, stream);
}

}  // extern "C"
