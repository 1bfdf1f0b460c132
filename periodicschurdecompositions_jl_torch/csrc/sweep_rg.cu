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
//   wrote.  It reads H only (B0 and B apply the log to H afterwards) and
//   runs in ONE block, in batches of L steps (L <= 29, set from p by the
//   shared memory a block may take):
//   - the look-ahead window: for a batch j0..j1-1 each factor keeps rows
//     j0..j1+2 (cut at n-1) and columns j0-1..j1+1 of its working state in
//     dynamic shared memory, (L+3)^2 entries: every entry the batch's
//     generations read or its band updates and ring close write on the
//     way there (factor 0 generates from column j-1, rows j..j+2, and its
//     ring close reaches row j+3; the other factors stay in rows j..j+2
//     and columns j..j+2);
//   - serial phase: one warp runs the batch's L steps x p factors in the
//     reference order (rg_chase_plain's, both branches of S) on the
//     windows only: every lane runs the generation (psd::givens_r's
//     operations, less the division of the larger operand by itself, which
//     is exactly +-1), the band updates take one lane per row, and the
//     lanes apply each left rotation to the window's rows (lanes as
//     columns), with __syncwarp between; it keeps the rotation pair each
//     factor hands on, and the block writes the batch's log from those
//     pairs at its end;
//   - update phase: the columns right of the window receive no right
//     rotation in the batch, only left ones (per factor and step: rows
//     j+1, j+2, then rows j, j+1), so the whole block applies the batch's
//     2L left rotations of each factor to them at its end, in step order.
//     Each thread walks one (factor, column): the two rows still in flux
//     come from a 2 p n scratch (or from H at the first batch) and go back
//     there, or into the next window when the column enters it; the row
//     below comes fresh from H, which no rotation has touched there.
//     Columns right of i are never read by a generation and are not
//     visited.
//   Every entry therefore receives the same operations in the same order as
//   in the reference order on a full working copy (tests/torch_rg_window_host.py
//   models both schedules and checks that their logs agree bit for bit),
//   and the chain waits on no global memory and no block barrier: one
//   __syncthreads pair per batch.  Every rotation is written out as the
//   design before the look-ahead window had it from nvcc (the c product
//   fused, the s product rounded: rot2), so the log is that design's bit
//   for bit.  Where even L = 1 does not fit in shared memory (p above
//   about 1000), the same kernel keeps the windows in a global scratch.
//   What bounds it: the generations, a float64 division, a square root and
//   two more divisions each, one after the other, and the window's
//   shared-memory round trips and __syncwarp between them (p=8 n=256 on an
//   H100: ~2180 cycles per (step, factor); with the clock64 counters of
//   scripts/profile_sweep_generate.py --rg, 2368, 1281 of them the two
//   generations).
// * rg_sweep_left / rg_sweep_right (B0 and B) apply the logged 3x3
//   transforms.  Deferring the left and right products past the generation
//   is exact (left and right multiplications commute) provided every
//   transform acts on the FULL rows and columns: the interleaved order's
//   bounds skip entries that are zero only in that order.  Columns left of
//   m-1 are never touched.  Their design is the one of csrc/sweep.cu's and
//   csrc/sweep_cx.cu's B0/B (see the comment above rg_left_kernel): one
//   walking warp per tile of lines, the positions staged in shared memory
//   by cp.async.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

constexpr int kGenThreads = 512;
constexpr int kMaxBatch = 29;  // kernel rg A: L + 3 <= 32 window columns, one per lane
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

// (x0, x1) <- (c x0 + s x1, c x1 - s x0): a left rotation lmat(c, s) on two
// rows, or a right rotation rmat_adj(c, s) on two columns.  The c product
// is fused, the s product rounded: the form nvcc gave every rotation of
// kernel rg A before the look-ahead window (its log is this kernel's, bit
// for bit).
__device__ __forceinline__ void rot2(double c, double s, double& x0, double& x1) {
  const double y0 = __fma_rn(c, x0, __dmul_rn(s, x1));
  x1 = __fma_rn(c, x1, -__dmul_rn(s, x0));
  x0 = y0;
}

// psd::givens_r's values, on every lane of warp 0 alike.  Of the two
// scaled operands f / sc and g / sc (sc = max(|f|, |g|)) the larger one is
// x / |x|, exactly +-1 for a finite sc, and is not divided: one float64
// division less on the chain (2.39 -> 2.23 ms at p=8 n=256 on an H100); an
// infinite or NaN sc takes psd::givens_r itself.  The sum of squares
// is written in the form nvcc gave psd::givens_r in the kernel before the
// look-ahead window.  Handing the second round's two divisions to lanes 0
// and 1 (shuffles) was slower (2.36 ms).
__device__ __forceinline__ void givens_gen(double f, double g, double& c, double& s,
                                           double& r) {
  if (g == 0.0) {
    c = 1.0;
    s = 0.0;
    r = f;
  } else if (f == 0.0) {
    c = 0.0;
    s = (g >= 0.0) ? 1.0 : -1.0;
    r = fabs(g);
  } else {
    const double af = fabs(f), ag = fabs(g);
    const double sc = fmax(af, ag);
    if (!(sc <= DBL_MAX)) {  // an infinite or NaN operand
      psd::givens_r(f, g, c, s, r);
      return;
    }
    const bool fbig = af == sc;
    const double q = (fbig ? g : f) / sc;
    const double fs = fbig ? copysign(1.0, f) : q;
    const double gs = fbig ? q : copysign(1.0, g);
    const double d = __dmul_rn(sc, sqrt(__fma_rn(fs, fs, __dmul_rn(gs, gs))));
    r = (f >= 0.0) ? d : -d;
    c = af / d;
    s = g / r;
  }
}

// Kernel rg A's working set for batch length L, in bytes: per factor the
// (L+3) x (L+3) window, the 3x3 corner handed to the next batch and the
// batch's L rotation pairs handed on (c1, s1, c2, s2); factor 0's L
// regenerated entries r.
inline size_t window_bytes(int p, int L) {
  return ((size_t)p * ((size_t)(L + 3) * (L + 3) + 9 + 4 * (size_t)L) + L) *
         sizeof(double);
}

// lanes 0..3 of warp 0 store (a, b, c, d) to D[0..3]
__device__ __forceinline__ void put4(double* D, double a, double b, double c,
                                     double d) {
  const int lane = threadIdx.x & 31;
  if (lane < 4) D[lane] = lane == 0 ? a : lane == 1 ? b : lane == 2 ? c : d;
}

// The rotation pair handed into factor f at step t of the batch (hp: the
// pairs each factor hands on, (c1, s1, c2, s2) at 4 (f L + t)): factor 0's
// ring close takes the last factor's (factor 1's), factor p-1 takes factor
// 0's, factor l < p-1 takes factor l+1's.
__device__ __forceinline__ const double* pair_in(const double* hp, int p, int L,
                                                 int f, int t) {
  const int g = (f == 0) ? (p > 1 ? 1 : 0) : (f == p - 1 ? 0 : f + 1);
  return hp + 4 * ((size_t)g * L + t);
}

// row a of a window, columns b, b+1 <- (...) rmat_adj(c, s)
__device__ __forceinline__ void win_right(double* Wf, int SW, int a, int b,
                                          double c, double s) {
  double* y = Wf + a * SW + b;
  double x0 = y[0], x1 = y[1];
  rot2(c, s, x0, x1);
  y[0] = x0;
  y[1] = x1;
}

// rows a, a+1 of a window, columns b0..b1 <- lmat(c, s) rows (lanes as
// columns)
__device__ __forceinline__ void win_left(double* Wf, int SW, int a, int b0,
                                         int b1, double c, double s) {
  for (int b = b0 + (threadIdx.x & 31); b <= b1; b += 32) {
    double* x = Wf + a * SW + b;
    double x0 = x[0], x1 = x[SW];
    rot2(c, s, x0, x1);
    x[0] = x0;
    x[SW] = x1;
  }
}

// Serial phase of the batch j0..j1-1, on warp 0.  win: the p windows
// (factor f's entry (r, c) at win[f SW^2 + (r - j0) SW + c - j0 + 1],
// SW = L+3); hp: the rotation pair each factor hands on at each step (see
// pair_in), and r0: factor 0's regenerated entries, from which the block
// writes the log and takes the left rotations of the update phase; stage:
// the next batch's corners.  Every lane generates and holds the rotations
// handed from factor to factor; lane 0 writes the generated entries.
// Warp-synchronous: __syncwarp only.
__device__ void gen_serial(double* win, double* stage, double* hp, double* r0,
                           const int* __restrict__ S, int p, int n, int i, int L,
                           int j0, int j1) {
  const int lane = threadIdx.x & 31;
  const int SW = L + 3;
  const size_t SS = (size_t)SW * SW;
  const int bmax = j1 - j0 + 2;  // the window column of j1+1
  for (int j = j0; j < j1; ++j) {
    const int t = j - j0;
    // ---- factor 0: the two bulge rotations from column j-1 -------------
    double c1, s1, c2, s2;
    {
      double* W = win;
      double r1, r2;
      givens_gen(W[(t + 1) * SW + t], W[(t + 2) * SW + t], c2, s2, r2);
      givens_gen(W[t * SW + t], r2, c1, s1, r1);
      __syncwarp();
      if (lane == 0) {
        W[t * SW + t] = r1;
        W[(t + 1) * SW + t] = 0.0;
        W[(t + 2) * SW + t] = 0.0;
        r0[t] = r1;
      }
      put4(hp + 4 * (size_t)t, c1, s1, c2, s2);
      // rows j+1, j+2 then j, j+1, columns j..j1+1, fused per column
      for (int b = t + 1 + lane; b <= bmax; b += 32) {
        double* x = W + t * SW + b;
        double x0 = x[0], x1 = x[SW], x2 = x[2 * SW];
        rot2(c2, s2, x1, x2);
        rot2(c1, s1, x0, x1);
        x[0] = x0;
        x[SW] = x1;
        x[2 * SW] = x2;
      }
      __syncwarp();
    }
    // ---- factors p-1..1 ----------------------------------------------------
    for (int l = p - 1; l >= 1; --l) {
      double* W = win + l * SS;
      double c2n, s2n, c1n, s1n, r;
      if (__ldg(S + l)) {
        // incoming rights on columns j+1, j+2 (band rows j..j+2, one per
        // lane), then regenerate from the new column j+1
        if (lane < 3) win_right(W, SW, t + lane, t + 2, c2, s2);
        __syncwarp();
        givens_gen(W[(t + 1) * SW + t + 2], W[(t + 2) * SW + t + 2], c2n, s2n, r);
        __syncwarp();
        if (lane == 0) {
          W[(t + 1) * SW + t + 2] = r;
          W[(t + 2) * SW + t + 2] = 0.0;
        }
        __syncwarp();
        // rows j+1, j+2 from column j+2; the incoming right on columns j,
        // j+1 (band rows j, j+1): disjoint entries
        win_left(W, SW, t + 1, t + 3, bmax, c2n, s2n);
        if (lane < 2) win_right(W, SW, t + lane, t + 1, c1, s1);
        __syncwarp();
        givens_gen(W[t * SW + t + 1], W[(t + 1) * SW + t + 1], c1n, s1n, r);
        __syncwarp();
        if (lane == 0) {
          W[t * SW + t + 1] = r;
          W[(t + 1) * SW + t + 1] = 0.0;
        }
        win_left(W, SW, t, t + 2, bmax, c1n, s1n);  // rows j, j+1 from column j+1
      } else {
        // incoming lefts, then regenerate from the new rows
        win_left(W, SW, t + 1, t + 1, bmax, c2, s2);  // rows j+1, j+2 from column j
        __syncwarp();
        givens_gen(W[(t + 2) * SW + t + 3], -W[(t + 2) * SW + t + 2], c2n, s2n, r);
        __syncwarp();
        if (lane == 0) {
          W[(t + 2) * SW + t + 2] = 0.0;
          W[(t + 2) * SW + t + 3] = r;
        }
        if (lane < 2) win_right(W, SW, t + lane, t + 2, c2n, s2n);  // columns j+1, j+2
        __syncwarp();
        win_left(W, SW, t, t + 1, bmax, c1, s1);  // rows j, j+1 from column j
        __syncwarp();
        givens_gen(W[(t + 1) * SW + t + 2], -W[(t + 1) * SW + t + 1], c1n, s1n, r);
        __syncwarp();
        if (lane == 0) {
          W[(t + 1) * SW + t + 1] = 0.0;
          W[(t + 1) * SW + t + 2] = r;
          win_right(W, SW, t, t + 1, c1n, s1n);  // row j, columns j, j+1
        }
      }
      c1 = c1n;
      s1 = s1n;
      c2 = c2n;
      s2 = s2n;
      put4(hp + 4 * ((size_t)l * L + t), c1, s1, c2, s2);
      __syncwarp();
    }
    // ---- ring close on factor 0: columns j+1, j+2 then j, j+1, band rows
    // j..j+3 (cut at n-1), one per lane -----------------------------------
    if (lane < 4 && j + lane <= n - 1) {
      win_right(win, SW, t + lane, t + 2, c2, s2);
      win_right(win, SW, t + lane, t + 1, c1, s1);
    }
    __syncwarp();
  }
  if (j1 < i - 1) {  // rows j1..j1+2 x columns j1-1..j1+1: the next corners
    const int a = j1 - j0;
    for (int q = lane; q < p * 9; q += 32) {
      const int f = q / 9, da = (q % 9) / 3, db = q % 3;
      stage[q] = win[f * SS + (size_t)(a + da) * SW + a + db];
    }
  }
}

// The log of the batch j0..j1-1, whole block, one thread per (factor, step),
// from the pairs handed on (see gen_serial): factor 0 logs its own pair as
// L and ZR, the pair of its ring close as R and its r; a factor of S[l] = 1
// logs the incoming pair as R and its own as L and ZR; one of S[l] = 0 logs
// the incoming pair as L and its own as R and ZR.
__device__ void write_log(const double* hp, const double* r0, double* __restrict__ Lg,
                          const int* __restrict__ S, int p, int n, int L, int j0,
                          int j1) {
  const int nb = j1 - j0;
  for (int q = threadIdx.x; q < p * nb; q += blockDim.x) {
    const int f = q / nb, t = q % nb;
    const double* own = hp + 4 * ((size_t)f * L + t);
    const double* in = pair_in(hp, p, L, f, t);
    const bool direct = f == 0 || __ldg(S + f);
    const double* lp = direct ? own : in;  // the left pair
    const double* rp = (f > 0 && !direct) ? own : in;  // the right pair
    double* E = Lg + ((size_t)f * n + j0 + t) * kLog;
    put_fuse_left(E, lp[0], lp[1], lp[2], lp[3]);
    put_fuse_right(E + 9, rp[0], rp[1], rp[2], rp[3]);
    put_fuse_right(E + 18, own[0], own[1], own[2], own[3]);
    if (f == 0) E[27] = r0[t];
  }
}

// Window entries (a, b) (row j0+a, column j0-1+b, up to rlast and clast)
// from H, whole block: with first, every entry (the first batch); else all
// but the corner (a, b <= 2) and the carried rows (a <= 1).
__device__ void fill_from_h(const double* __restrict__ H, double* win, int p,
                            int n, int L, int j0, int rlast, int clast,
                            bool first) {
  const int SW = L + 3;
  const int na = rlast - j0 + 1, nb = clast - j0 + 2, per = na * nb;
  for (int q = threadIdx.x; q < p * per; q += blockDim.x) {
    const int f = q / per, a = (q % per) / nb, b = q % nb;
    if (!first && (a <= 1 || (a == 2 && b <= 2))) continue;
    win[((size_t)f * SW + a) * SW + b] = H[((size_t)f * n + j0 + a) * n + j0 - 1 + b];
  }
}

__global__ void __launch_bounds__(kGenThreads)
rg_generate_kernel(const double* __restrict__ H, double* __restrict__ carry,
                   double* __restrict__ gwin, double* __restrict__ Lg,
                   const int* __restrict__ S, int p, int n, int m, int i, int L) {
  extern __shared__ double smem[];
  double* win = gwin ? gwin : smem;
  const int SW = L + 3;
  double* stage = win + (size_t)p * SW * SW;
  double* hp = stage + 9 * (size_t)p;
  double* r0 = hp + 4 * (size_t)p * L;
  int j0 = m, j1 = min(m + L, i - 1);
  fill_from_h(H, win, p, n, L, j0, min(j1 + 2, n - 1), j1 + 1, true);
  __syncthreads();
  for (;;) {
    if (threadIdx.x < 32) gen_serial(win, stage, hp, r0, S, p, n, i, L, j0, j1);
    __syncthreads();
    write_log(hp, r0, Lg, S, p, n, L, j0, j1);
    if (j1 == i - 1) break;
    // update phase: the batch's left rotations on columns j1+2..i of every
    // factor, one thread per (factor, column): rows j0, j0+1 carried (from
    // H at the first batch), rows j0+2..j1+1 fresh from H; rows j1, j1+1 go
    // into the next window or back to the carry.  The first row of each
    // step's second rotation is final and not formed.
    const int j2 = min(j1 + L, i - 1);
    const int nc = i - j1 - 1;
    for (int q = threadIdx.x; q < p * nc; q += blockDim.x) {
      const int f = q / nc, c = j1 + 2 + q % nc;
      const double* Hc = H + (size_t)f * n * n + c;
      double* cy = carry + (size_t)f * 2 * n + c;
      double x0 = (j0 == m) ? Hc[(size_t)j0 * n] : cy[0];
      double x1 = (j0 == m) ? Hc[(size_t)(j0 + 1) * n] : cy[n];
      const bool direct = f == 0 || __ldg(S + f);
      for (int u = 0; u < L; ++u) {
        const double* P = direct ? hp + 4 * ((size_t)f * L + u) : pair_in(hp, p, L, f, u);
        double x2 = Hc[(size_t)(j0 + u + 2) * n];
        rot2(P[2], P[3], x1, x2);
        x0 = __fma_rn(P[0], x1, -__dmul_rn(P[1], x0));  // rot2's second row
        x1 = x2;
      }
      if (c <= j2 + 1) {
        double* w = win + (size_t)f * SW * SW + c - j1 + 1;
        w[0] = x0;
        w[SW] = x1;
      } else {
        cy[0] = x0;
        cy[n] = x1;
      }
    }
    // the rest of the next windows: the corners, then fresh rows of H
    for (int q = threadIdx.x; q < p * 9; q += blockDim.x)
      win[((size_t)(q / 9) * SW + (q % 9) / 3) * SW + q % 3] = stage[q];
    fill_from_h(H, win, p, n, L, j1, min(j2 + 2, n - 1), j2 + 1, false);
    __syncthreads();
    j0 = j1;
    j1 = j2;
  }
}

// Kernels B0 and B.  Both walk lines (B0: the columns >= m-1 of every H[f];
// B: the rows 0..i of H[g] and all rows of Z[g]) along the positions m..i
// (B0: rows, B: columns).  Step j = m..i-2 of a line maps its entries (x0,
// x1, x2) at positions j..j+2 by the logged 3x3 M (B0: L's rows on the
// left, B: R's or ZR's columns on the right), writes the first output at j
// and carries the other two to step j+1; after step i-2 the carried pair
// is positions i-1, i.
//
// Each block stages its lines in chunks of W positions (B0: kLeftChunk, B:
// kRightChunk) through a ring of shared-memory slots filled by 8-byte
// cp.async (a row of H is 16-byte aligned only for even n), kAhead chunks
// in flight ahead of the one in use, each chunk with the log entries its
// steps read (W rows of 9 doubles, staged at a pitch of kLogPitch so that
// they load as double2; a step's 28 logged doubles put R at byte 72, so the
// entries are copied one by one).  Chunk j's steps are q0-2..q0+w-3 (q0 = m
// + j W, w its positions): its first two steps finish the last two
// positions of chunk j-1.  The shared memory a block takes depends on
// these sizes only, never on n or p.  Ragged tiles, chunks and spans are
// masked; windows of one or two steps take the same code.
//
// A block has kApplyThreads threads: warp 0 walks, one line per lane, and
// all of them issue the copies and (B) write finished chunks back, which
// would otherwise sit on the walk's path.  A chunk whose steps all lie
// inside m..i-2 runs from registers: its entries are read before its first
// step (and B's outputs stored after its last), so the log entries load
// ahead of the arithmetic.  A step costs tens of ns on a walking lane and
// a chunk a barrier and the ring's bookkeeping on top, so long chunks and
// many blocks win: at p=8 n=256, 16 lines a block give 128 (B0) and 256
// (B) blocks; of the chunks tried (16 to 64 positions, scripts/
// time_sweep_generate.py --rg --apply --variant), 64 (B0) and 32 (B) were
// the fastest without spills.
//
// The three-term sums are written out with __fma_rn/__dmul_rn in the order
// nvcc contracted `M[0] * x0 + M[1] * x1 + M[2] * x2` (B0) and `x0 * M[0] +
// x1 * M[3] + x2 * M[6]` (B) in the kernels before this design (one thread
// per line; their SASS): the middle product rounded, the first fused onto
// it, then the third.  So every entry goes through the same operations in
// the same order as before, bit for bit (scripts/time_sweep_generate.py
// --rg --apply prints the hashes).
//
// B0 (replaces the JAX package's ops/pallas_sweep_rg.py:372
// _make_rg_left_kernel): a block owns kLeftCols columns of one factor, one
// per lane of warp 0, from column m-1 (the bulge column) on, and walks their
// rows down through the ring; its stores are rows of consecutive columns,
// coalesced, straight to device memory.  B (replaces
// ops/pallas_sweep_rg.py:409 _make_rg_apply_kernel): a block owns
// kRightRows rows of one target, one per lane (H[g] rows 0..i with R of
// factor g, or Z[g] rows 0..n-1 with ZR), and walks the columns; the row
// pitch in shared memory is odd, so the lanes' 8-byte accesses to one
// column fall in distinct banks.  A chunk goes back to device memory as
// coalesced row segments once the next chunk's first two steps have
// finished it, with H's structural zeros (rows r >= m: in H[0] left of
// r-1, in row i left of i-2, keeping the closing bulge H[0][i, i-2]; in
// H[g>0] left of r) and the regenerated H[0][r, r-1] = log r (r <= i-2)
// written exactly in the same pass; column m-1, outside the walked
// positions, takes its zeros and H[0][m, m-1] after the ring.  What bounds
// both: bytes (chip_smoke.py's rg bounds) and the walk's chain of i-1-m
// dependent steps; times in PERF.md §6.  Without T (want_t=False) B0 walks
// only the columns < chi and B only H's rows >= rlo (the *_bounded
// entries): whole lines drop out, and the lines kept are bit for bit the
// unbounded launch's.

constexpr int kLeftChunk = 64;   // B0: positions per chunk
constexpr int kRightChunk = 32;  // B: positions per chunk (its outputs wait in registers)
constexpr int kAhead = 2;        // chunks in flight ahead of the one in use
constexpr int kLeftCols = 16;    // B0: columns per block, one per lane of warp 0
constexpr int kRightRows = 16;   // B: rows per block, one per lane of warp 0
constexpr int kRightPitch = kRightChunk | 1;  // odd: conflict-free columns
constexpr int kLogPitch = 10;    // doubles per staged log row (16-byte rows)
static_assert(kLeftChunk >= 2 && kRightChunk >= 2,
              "a chunk's first two steps finish the chunk before");
static_assert(kRightPitch % 2 == 1, "B's row pitch must be odd");
static_assert(kApplyThreads % 32 == 0 && kApplyThreads >= kLeftCols &&
                  kApplyThreads >= kRightRows && kLeftCols <= 32 && kRightRows <= 32,
              "the walking lanes are warp 0's");

// Shared memory of B0 and B (bytes): kAhead + 1 (B0) or kAhead + 2 (B, the
// previous chunk waits for its write-back) tile slots, kAhead + 1 log slots.
constexpr size_t left_smem() {
  return sizeof(double) * ((size_t)(kAhead + 1) * kLeftChunk * kLeftCols +
                           (size_t)(kAhead + 1) * kLeftChunk * kLogPitch);
}
constexpr size_t right_smem() {
  return sizeof(double) * ((size_t)(kAhead + 2) * kRightRows * kRightPitch +
                           (size_t)(kAhead + 1) * kRightChunk * kLogPitch);
}
static_assert(left_smem() <= 48 * 1024 && right_smem() <= 48 * 1024,
              "the apply kernels launch without the shared-memory opt-in");
static_assert((kLeftChunk * kLeftCols) % 2 == 0 && (kRightRows * kRightPitch) % 2 == 0,
              "the log slots must start 16-byte aligned");

// Stage the log entries chunk j's steps read (at offset `at` of the log
// row: 0 L, 9 R, 18 ZR): step k = q0 - 2 + s at slot row s < W, for the
// steps m..i-2 only.  src: the factor whose log.
template <int W>
__device__ __forceinline__ void stage_log(double* Ls, const double* __restrict__ Lg, int n,
                                          int src, int at, int m, int i, int q0) {
  for (int e = threadIdx.x; e < W * 9; e += blockDim.x) {
    const int s = e / 9, q = e % 9, k = q0 - 2 + s;
    if (k >= m && k <= i - 2)
      __pipeline_memcpy_async(Ls + s * kLogPitch + q, Lg + ((size_t)src * n + k) * kLog + at + q,
                              sizeof(double));
  }
}

// (x0, x1, x) <- M (x0, x1, x)^T for the staged row-major 3x3 M (B0):
// returns the first output, carries the other two
__device__ __forceinline__ double left_step(double& x0, double& x1, double x, const double* F) {
  const double2* F2 = reinterpret_cast<const double2*>(F);
  const double2 f01 = F2[0], f23 = F2[1], f45 = F2[2], f67 = F2[3];
  const double y0 = psd::dot3(x0, x1, x, f01.x, f01.y, f23.x);
  const double y1 = psd::dot3(x0, x1, x, f23.y, f45.x, f45.y);
  const double y2 = psd::dot3(x0, x1, x, f67.x, f67.y, F[8]);
  x0 = y1;
  x1 = y2;
  return y0;
}

// (x0, x1, x) <- (x0, x1, x) M for the staged row-major 3x3 M (B)
__device__ __forceinline__ double right_step(double& x0, double& x1, double x,
                                             const double* F) {
  const double2* F2 = reinterpret_cast<const double2*>(F);
  const double2 f01 = F2[0], f23 = F2[1], f45 = F2[2], f67 = F2[3];
  const double y0 = psd::dot3(x0, x1, x, f01.x, f23.y, f67.x);
  const double y1 = psd::dot3(x0, x1, x, f01.y, f45.x, f67.y);
  const double y2 = psd::dot3(x0, x1, x, f23.x, f45.y, F[8]);
  x0 = y1;
  x1 = y2;
  return y0;
}

// The walk of one line over chunk j's steps (staged log Ls), and after the
// last chunk the carried pair to positions i-1, i.  in(u) reads the chunk's
// position q0+u; out(d, x) takes the finished entry at position q0+d (d >=
// -2: the chunk before); (x0, x1): the carried pair.
template <bool kLeft, int W, class In, class Out>
__device__ __forceinline__ void walk_chunk(int j, int nch, int m, int i, const double* Ls,
                                           double& x0, double& x1, In in, Out out) {
  const int q0 = m + j * W, w = min(W, i + 1 - q0);
  if (j > 0 && w == W) {  // steps q0-2..q0+W-3, all inside m..i-2
    double xin[W];
#pragma unroll
    for (int u = 0; u < W; ++u) xin[u] = in(u);
    if constexpr (kLeft) {  // a store to device memory cannot alias a staged entry
#pragma unroll
      for (int u = 0; u < W; ++u) out(u - 2, left_step(x0, x1, xin[u], Ls + u * kLogPitch));
    } else {  // the outputs go back into shared memory after the last step
      double y[W];
#pragma unroll
      for (int u = 0; u < W; ++u) y[u] = right_step(x0, x1, xin[u], Ls + u * kLogPitch);
#pragma unroll
      for (int u = 0; u < W; ++u) out(u - 2, y[u]);
    }
  } else {
    int u = 0;
    if (j == 0) {  // positions m, m+1: no step reads them as x
      x0 = in(0);
      x1 = in(1);
      u = 2;
    }
    for (; u < w; ++u) {
      const double* F = Ls + u * kLogPitch;  // step q0 - 2 + u
      out(u - 2, kLeft ? left_step(x0, x1, in(u), F) : right_step(x0, x1, in(u), F));
    }
  }
  if (j == nch - 1) {
    out(w - 2, x0);
    out(w - 1, x1);
  }
}

// B0: rows j..j+2 of every H[f] <- L[f, j] rows, for j = m..i-2.  Block (x,
// f): columns m - 1 + x kLeftCols + threadIdx.x < chi of H[f] (chi = n:
// all; the want_t=False window: i + 1).
__global__ void __launch_bounds__(kApplyThreads)
rg_left_kernel(double* __restrict__ H, const double* __restrict__ Lg, int n, int m, int i,
               int chi) {
  constexpr int W = kLeftChunk, NT = kAhead + 1, NL = kAhead + 1;
  extern __shared__ double smem[];
  double* tiles = smem;                          // NT x W rows x kLeftCols
  double* logs = smem + NT * W * kLeftCols;      // NL x W steps x kLogPitch
  const int f = blockIdx.y, tid = threadIdx.x;
  const int cb = m - 1 + blockIdx.x * kLeftCols;  // the tile's first column
  const int nc = min(kLeftCols, chi - cb);
  double* Hf = H + (size_t)f * n * n + cb;
  const int nch = (i + 1 - m + W - 1) / W;
  auto copy = [&](int j) {  // chunk j's rows
    const int q0 = m + j * W, w = min(W, i + 1 - q0);
    double* T = tiles + (j % NT) * W * kLeftCols;
    for (int e = tid; e < w * kLeftCols; e += kApplyThreads)
      if (e % kLeftCols < nc)
        __pipeline_memcpy_async(T + e, Hf + (size_t)(q0 + e / kLeftCols) * n + e % kLeftCols,
                                sizeof(double));
    stage_log<W>(logs + (j % NL) * W * kLogPitch, Lg, n, f, 0, m, i, q0);
  };
  double x0 = 0.0, x1 = 0.0;
  auto walk = [&](int j) {  // stores: rows of consecutive columns, coalesced
    const double* T = tiles + (j % NT) * W * kLeftCols + tid;
    double* out = Hf + (size_t)(m + j * W) * n + tid;
    walk_chunk<true, W>(
        j, nch, m, i, logs + (j % NL) * W * kLogPitch, x0, x1,
        [&](int u) { return T[u * kLeftCols]; },
        [&](int d, double x) {
          if (tid < nc) out[(ptrdiff_t)d * n] = x;
        });
  };
  psd::apply_ring<kAhead>(nch, kLeftCols, copy, walk, [](int) {});
}

// B: columns j..j+2 <- columns M for j = m..i-2.  Block (x, g, 0): rows
// rlo + x kRightRows + threadIdx.x <= i of H[g] (rlo = 0: all; the
// want_t=False window: its top row, m - 1) with R[g, j], then (rows m..i)
// the structural zeros, keeping the closing bulge H[0][i, i-2], and the
// regenerated H[0][r, r-1], written exactly; block (x, g, 1): rows of
// Z[g], all n, with ZR[g, j].
__global__ void __launch_bounds__(kApplyThreads)
rg_right_kernel(double* __restrict__ H, double* __restrict__ Z,
                const double* __restrict__ Lg, int n, int m, int i, int rlo) {
  constexpr int W = kRightChunk, P = kRightPitch, NT = kAhead + 2, NL = kAhead + 1;
  extern __shared__ double smem[];
  double* tiles = smem;                          // NT x kRightRows x P
  double* logs = smem + NT * kRightRows * P;     // NL x W steps x kLogPitch
  const int g = blockIdx.y, tid = threadIdx.x;
  const bool isz = blockIdx.z == 1;
  const int nrows = isz ? n : i + 1;
  const int r0 = (isz ? 0 : rlo) + blockIdx.x * kRightRows;
  if (r0 >= nrows) return;
  const int nr = min(kRightRows, nrows - r0);
  double* A = (isz ? Z : H) + (size_t)g * n * n + (size_t)r0 * n;
  const int nch = (i + 1 - m + W - 1) / W;
  auto copy = [&](int j) {  // chunk j's row segments (its slot's chunk was written back)
    const int q0 = m + j * W, w = min(W, i + 1 - q0);
    double* T = tiles + (j % NT) * kRightRows * P;
    for (int e = tid; e < nr * W; e += kApplyThreads)
      if (e % W < w)
        __pipeline_memcpy_async(T + (e / W) * P + e % W, A + (size_t)(e / W) * n + q0 + e % W,
                                sizeof(double));
    stage_log<W>(logs + (j % NL) * W * kLogPitch, Lg, n, g, isz ? 18 : 9, m, i, q0);
  };
  // chunk j's finished columns back to device memory; in H's rows m..i the
  // structural zeros and H[0]'s regenerated subdiagonal in their place
  auto write_back = [&](int j) {
    const int q0 = m + j * W, w = min(W, i + 1 - q0);
    const double* T = tiles + (j % NT) * kRightRows * P;
    for (int e = tid; e < nr * W; e += kApplyThreads) {
      const int rr = e / W, cc = e % W, r = r0 + rr, c = q0 + cc;
      if (cc >= w) continue;
      double x = T[rr * P + cc];
      if (!isz && r >= m) {
        if (g > 0) {
          if (c < r) x = 0.0;
        } else if (c < (r < i ? r - 1 : i - 2)) {  // (i, i-2) is the closing bulge
          x = 0.0;
        } else if (c == r - 1 && r <= i - 2) {
          x = __ldg(Lg + (size_t)r * kLog + 27);
        }
      }
      A[(size_t)rr * n + c] = x;
    }
  };
  double x0 = 0.0, x1 = 0.0;
  // a finished column goes back into its slot: this chunk's or, for the two
  // positions the chunk's first steps finish, the one before (indexed from
  // q0)
  auto walk = [&](int j) {
    double* T = tiles + (j % NT) * kRightRows * P + tid * P;
    double* Tp = tiles + ((j + NT - 1) % NT) * kRightRows * P + tid * P + W;
    walk_chunk<false, W>(
        j, nch, m, i, logs + (j % NL) * W * kLogPitch, x0, x1,
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
  // column m-1 of H's rows m..i: zeros, and H[0][m, m-1] regenerated
  if (!isz && tid < nr && r0 + tid >= m)
    A[(size_t)tid * n + m - 1] =
        (g == 0 && r0 + tid == m) ? __ldg(Lg + (size_t)m * kLog + 27) : 0.0;
}

struct GenPlan {
  int L;        // batch length
  bool global;  // windows in the global scratch (p too large for shared memory)
};

// The longest batch (at most kMaxBatch) whose working set fits the shared
// memory a block of this device may take; where even L = 1 does not fit,
// kMaxBatch with the windows in global memory.
cudaError_t gen_plan(int p, GenPlan& plan) {
  int L = 0;
  const cudaError_t e =
      psd::longest_batch(kMaxBatch, [p](int l) { return window_bytes(p, l); }, L);
  plan = {L > 0 ? L : kMaxBatch, L == 0};
  return e;
}

}  // namespace

extern "C" {

// Float64 entries of the scratch kernel rg A takes: the two carried rows,
// 2 p n, and the windows when they do not fit in shared memory; -1 on a
// CUDA error.
long long psd_rg_sweep_generate_scratch(int p, int n) {
  GenPlan plan;
  if (gen_plan(p, plan) != cudaSuccess) return -1;
  const long long win = (long long)(window_bytes(p, plan.L) + sizeof(double) - 1) /
                        (long long)sizeof(double);
  return 2LL * p * n + (plan.global ? win : 0);
}

// Kernel rg A.  H: (p, n, n) input (read only); work:
// psd_rg_sweep_generate_scratch(p, n) float64 entries of scratch; Lg:
// (p, n, 28) output log (steps m..i-2 written); S: (p,) int signature on
// the device.
int psd_rg_sweep_generate(const void* H, void* work, void* Lg, const int* S, int p,
                          int n, int m, int i, void* stream) {
  if (i - 2 < m) return 0;  // no step
  GenPlan plan;
  cudaError_t e = gen_plan(p, plan);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = plan.global ? 0 : window_bytes(p, plan.L);
  e = cudaFuncSetAttribute(rg_generate_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  double* gwin = plan.global ? (double*)work + 2 * (size_t)p * n : nullptr;
  rg_generate_kernel<<<1, kGenThreads, smem, (cudaStream_t)stream>>>(
      (const double*)H, (double*)work, gwin, (double*)Lg, S, p, n, m, i, plan.L);
  return (int)cudaGetLastError();
}

// Kernel rg B0, in place on H, on the columns < chi (i + 1 <= chi <= n;
// the want_t=False window: i + 1).  No step (i - 2 < m): nothing to do.
int psd_rg_sweep_left_bounded(void* H, const void* Lg, int p, int n, int m, int i,
                              int chi, void* stream) {
  if (chi < i + 1 || chi > n) return (int)cudaErrorInvalidValue;
  if (i - 2 < m) return 0;
  dim3 grid((chi - m + 1 + kLeftCols - 1) / kLeftCols, p);
  rg_left_kernel<<<grid, kApplyThreads, left_smem(), (cudaStream_t)stream>>>(
      (double*)H, (const double*)Lg, n, m, i, chi);
  return (int)cudaGetLastError();
}

// Kernel rg B0 on every column.
int psd_rg_sweep_left(void* H, const void* Lg, int p, int n, int m, int i,
                      void* stream) {
  return psd_rg_sweep_left_bounded(H, Lg, p, n, m, i, n, stream);
}

// Kernel rg B, in place on H's rows rlo..i (0 <= rlo <= m - 1; the
// want_t=False window: its top row, m - 1) and (when Z != NULL) every row
// of Z.  No step: nothing to do (as rg_apply_log_plain).
int psd_rg_sweep_right_bounded(void* H, void* Z, const void* Lg, int p, int n, int m,
                               int i, int rlo, void* stream) {
  if (rlo < 0 || rlo > m - 1) return (int)cudaErrorInvalidValue;
  if (i - 2 < m) return 0;
  dim3 grid((n + kRightRows - 1) / kRightRows, p, Z ? 2 : 1);
  rg_right_kernel<<<grid, kApplyThreads, right_smem(), (cudaStream_t)stream>>>(
      (double*)H, (double*)Z, (const double*)Lg, n, m, i, rlo);
  return (int)cudaGetLastError();
}

// Kernel rg B on every row.
int psd_rg_sweep_right(void* H, void* Z, const void* Lg, int p, int n, int m,
                       int i, void* stream) {
  return psd_rg_sweep_right_bounded(H, Z, Lg, p, n, m, i, 0, stream);
}

}  // extern "C"
