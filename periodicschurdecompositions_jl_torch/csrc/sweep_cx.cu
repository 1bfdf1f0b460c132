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
//   generations, each reading entries the previous one wrote.  It reads H
//   only (B0 and B apply the log to H afterwards) and runs in ONE block, in
//   batches of L steps (L <= 30, set from p by the shared memory a block
//   may take):
//   - the look-ahead window: for a batch k0..k1-1 each factor keeps rows
//     k0..k1+1 (cut at n-1) and columns k0-1..k1 of its working state in
//     dynamic shared memory, (L+2)^2 entries: every entry the batch's
//     generations read or its band updates write on the way there;
//   - serial phase: one warp runs the batch's L steps x p factors in the
//     reference order on the windows only: the whole warp generates
//     (givens_cx_warp: psd::givens_cx with its independent divisions and
//     square roots on different lanes at once), the band updates take one
//     lane per row, and the lanes apply each left rotation to the window's
//     two rows (lanes as columns), with __syncwarp between;
//   - update phase: the columns right of the window receive no right
//     rotation in the batch, only left ones, so the whole block applies
//     the batch's L left rotations of each factor to them at its end, in
//     step order.  Each thread walks one (factor, column): the row still in
//     flux comes from a p n scratch (or from H at the first batch) and goes
//     back there, or into the next window when the column enters it; the
//     row below comes fresh from H, which no rotation has touched there.
//     Columns right of i are never read by a generation and are not
//     visited.
//   Every entry therefore receives the same operations in the same order as
//   in the reference order on a full working copy (tests/torch_cx_window_host.py
//   models both schedules and checks that their logs agree bit for bit),
//   and the chain waits on no global memory and no block barrier: one
//   __syncthreads pair per batch.  Where even L = 1 does not fit in shared
//   memory (p above about 1000), the same kernel keeps the windows in a
//   global scratch.  Nothing leaves the chip between kernel S and this
//   kernel: the shift rotation is read from a device buffer.  What bounds
//   it: the generation, four rounds of float64 divisions and square roots
//   (~124 and ~88 cycles each) with shuffles between, and about as much
//   again in shared-memory round trips and __syncwarp per (step, factor)
//   (scripts/profile_sweep_generate.py --cx: 1692 cycles per (step,
//   factor), 959 of them the generation, at p=8 n=256 on an H100).
//   Handing the generation's operands over by shuffles instead of shared
//   memory, and spreading the log stores over lanes, made it slower.
// * qz_sweep_left / qz_sweep_right (B0, B) apply the logged rotations:
//   deferring the left and right products past the generation is exact
//   (left and right multiplications commute) provided every rotation acts
//   on the FULL rows and columns: the interleaved order's bounds skip
//   entries that are zero only in that order.  Each block walks 16 lines
//   (B0: columns of one factor, B: rows of one target), one per lane of
//   warp 0, with one live entry in a register, through a ring of chunks of
//   32 (B0) or 24 (B) positions that all four warps stage in shared
//   memory by 16-byte cp.async ahead of the walk, with the log entries each
//   chunk's steps read; B0 stores rows of consecutive columns straight to
//   device memory, B writes each finished chunk back as coalesced row
//   segments, with the structural zeros and the logged subdiagonal
//   H[0][k, k-1] = r in the same pass (the design note above
//   qz_left_kernel).  What bounds them:
//   bytes, p n^2 complex128 read and written once; the walk is a chain of
//   i-m dependent 2x2 steps per line.  The column m-1 of H[0] (the
//   window's boundary subdiagonal) is never touched.
// * qz_shift is a chain of p Givens generations on a few scalars, bound by
//   the launch and the chain: the lanes of one warp stage the chain's 2p+1
//   entries at once, and the warp runs each generation as givens_cx_warp
//   (the design note above qz_shift_kernel).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

using psd::cconj;
using psd::cmul;
using psd::cneg;
using psd::rmul;

constexpr int kGenThreads = 512;
constexpr int kMaxBatch = 30;  // kernel A: L + 2 <= 32 window columns, one per lane
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

// Kernel A's working set for batch length L, in bytes: per factor the
// (L+2) x (L+2) window, the 2x2 corner handed to the next batch and the
// batch's L left rotations (c, s).
inline size_t window_bytes(int p, int L) {
  return (size_t)p * (((size_t)(L + 2) * (L + 2) + 4 + L) * sizeof(double2) +
                      (size_t)L * sizeof(double));
}

// Kernel A's complex products and sums, written out: each part fuses its
// first product (a.x b.x - a.y b.y, a.x b.y + a.y b.x), the form nvcc gave
// every rotation of the kernel before the look-ahead window (its log is
// this kernel's, bit for bit).  Left to contraction the form changed with
// the inlining context: the update phase fused the other product of one
// part, and the log moved by an ulp in a few steps.
__device__ __forceinline__ double2 cmul_a(double2 a, double2 b) {
  return make_double2(__fma_rn(a.x, b.x, -__dmul_rn(a.y, b.y)),
                      __fma_rn(a.x, b.y, __dmul_rn(a.y, b.x)));
}

__device__ __forceinline__ double2 cadd_a(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

__device__ __forceinline__ double shfl(double v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}

// psd::givens_cx on warp 0, every lane taking part and receiving (c, s, r):
// the independent divisions and square roots run on different lanes at
// once.  The same operations, each rounded as there (products and sums in
// the forms nvcc gave psd::givens_cx in the kernel before the look-ahead
// window).
__device__ void givens_cx_warp(double2 f, double2 g, double& c, double2& s,
                               double2& r) {
  const int lane = threadIdx.x & 31;
  const double scale =
      fmax(fmax(fabs(f.x), fabs(f.y)), fmax(fabs(g.x), fabs(g.y)));
  const double sc = (scale == 0.0) ? 1.0 : scale;
  const int q4 = lane & 3;  // lanes 0..3: f.x, f.y, g.x, g.y over sc
  const double qs = (q4 == 0 ? f.x : q4 == 1 ? f.y : q4 == 2 ? g.x : g.y) / sc;
  const double fsr = shfl(qs, 0), fsi = shfl(qs, 1), gsr = shfl(qs, 2),
               gsi = shfl(qs, 3);
  const double f2 = __fma_rn(fsr, fsr, __dmul_rn(fsi, fsi));
  const double g2 = __fma_rn(gsr, gsr, __dmul_rn(gsi, gsi));
  if (g.x == 0.0 && g.y == 0.0) {
    c = 1.0;
    s = czero();
    r = f;
  } else if (f.x == 0.0 && f.y == 0.0) {
    const double ag = sqrt(g2);
    const double agsafe = (ag == 0.0) ? 1.0 : ag;
    c = 0.0;
    s = make_double2(gsr / agsafe, -(gsi / agsafe));
    r = make_double2(__dmul_rn(ag, sc), 0.0);
  } else {
    const double rt = sqrt((lane & 1) ? __dadd_rn(g2, f2) : f2);  // af, d
    const double af = shfl(rt, 0), d = shfl(rt, 1);
    const double dsafe = (d == 0.0) ? 1.0 : d;
    const double afsafe = (af == 0.0) ? 1.0 : af;
    const int q3 = lane % 3;  // lanes 0..2: c, fgr, fgi
    const double qc = (q3 == 0 ? af : q3 == 1 ? fsr : fsi) / (q3 == 0 ? dsafe : afsafe);
    c = shfl(qc, 0);
    const double fgr = shfl(qc, 1), fgi = shfl(qc, 2);
    r = make_double2(__dmul_rn(__dmul_rn(fgr, d), sc), __dmul_rn(__dmul_rn(fgi, d), sc));
    const double nr = __fma_rn(fgr, gsr, __dmul_rn(fgi, gsi));
    const double ni = __fma_rn(fgi, gsr, -__dmul_rn(fgr, gsi));
    const double qn = ((lane & 1) ? ni : nr) / dsafe;  // lanes 0, 1: s
    s = make_double2(shfl(qn, 0), shfl(qn, 1));
  }
}

// rows a, a+1 of a window, columns b0..b1 <- M rows (lanes as columns)
__device__ __forceinline__ void win_left(double2* Wf, int SW, int a, int b0,
                                         int b1, const double2* M) {
  for (int b = b0 + (threadIdx.x & 31); b <= b1; b += 32) {
    double2* x = Wf + a * SW + b;
    const double2 x0 = x[0], x1 = x[SW];
    x[0] = cadd_a(cmul_a(M[0], x0), cmul_a(M[1], x1));
    x[SW] = cadd_a(cmul_a(M[2], x0), cmul_a(M[3], x1));
  }
}

// row a of a window, columns b, b+1 <- (...) M
__device__ __forceinline__ void win_right(double2* Wf, int SW, int a, int b,
                                          const double2* M) {
  double2* y = Wf + a * SW + b;
  const double2 x0 = y[0], x1 = y[1];
  y[0] = cadd_a(cmul_a(x0, M[0]), cmul_a(x1, M[2]));
  y[1] = cadd_a(cmul_a(x0, M[1]), cmul_a(x1, M[3]));
}

// Serial phase of the batch k0..k1-1, on warp 0.  win: the p windows
// (factor f's entry (r, c) at win[f SW^2 + (r - k0) SW + c - k0 + 1],
// SW = L+2); rc, rs: the batch's left rotations (factor f, step k0+s at
// f L + s), for the update phase; stage: the next batch's corners.  Every
// lane holds the rotation handed from factor to factor; lane 0 writes the
// generated entries and the log.  Warp-synchronous: __syncwarp only.
__device__ void gen_serial(double2* win, double2* stage, double* rc, double2* rs,
                           double2* __restrict__ Lg, const double2* __restrict__ cs,
                           const int* __restrict__ S, int p, int n, int m, int i,
                           int L, int k0, int k1) {
  const int lane = threadIdx.x & 31;
  const int SW = L + 2;
  const size_t SS = (size_t)SW * SW;
  const int bmax = k1 - k0 + 1;  // the window column of k1
  double hc = 0.0;               // the rotation handed on (c, s)
  double2 hs = czero();
  double2 M[4];
  for (int k = k0; k < k1; ++k) {
    const int s = k - k0;
    for (int q = 0; q < p; ++q) {
      const int f = (q == 0) ? 0 : p - q;  // factor 0, then p-1..1
      double2* Wf = win + f * SS;
      double2* E = Lg + ((size_t)f * n + k) * kLog;
      const size_t rk = (size_t)f * L + s;
      double2 r;
      if (f == 0 || __ldg(S + f)) {
        if (f > 0) {
          // incoming right rotation on columns k, k+1 (band rows k, k+1,
          // one per lane), then re-triangularize column k
          put_rmat_adj(M, hc, hs);
          if (lane == 0) put_rmat_adj(E + 4, hc, hs);
          if (lane < 2) win_right(Wf, SW, s + lane, s + 1, M);
          __syncwarp();
          givens_cx_warp(Wf[s * SW + s + 1], Wf[(s + 1) * SW + s + 1], hc, hs, r);
          __syncwarp();
          if (lane == 0) {
            Wf[s * SW + s + 1] = r;
            Wf[(s + 1) * SW + s + 1] = czero();
          }
        } else if (k == m) {  // the shift rotation
          hc = cs[0].x;
          hs = cs[1];
          r = czero();
        } else {  // regenerate H[0][k, k-1] from column k-1, rows k, k+1
          givens_cx_warp(Wf[s * SW + s], Wf[(s + 1) * SW + s], hc, hs, r);
          __syncwarp();
          if (lane == 0) {
            Wf[s * SW + s] = r;
            Wf[(s + 1) * SW + s] = czero();
          }
        }
        if (lane == 0) {
          put_lmat(E, hc, hs);
          put_rmat_adj(E + 8, hc, hs);
          if (f == 0) E[12] = r;
          rc[rk] = hc;
          rs[rk] = hs;
        }
        // left: rows k, k+1 from column k (factor 0) or k+1
        put_lmat(M, hc, hs);
        win_left(Wf, SW, s, (f == 0) ? s + 1 : s + 2, bmax, M);
      } else {
        // incoming rotation from the left on rows k, k+1 from column k,
        // then re-triangularize row k+1; (cn, -sn) is handed on
        put_lmat(M, hc, hs);
        if (lane == 0) {
          put_lmat(E, hc, hs);
          rc[rk] = hc;
          rs[rk] = hs;
        }
        win_left(Wf, SW, s, s + 1, bmax, M);
        __syncwarp();
        double cn;
        double2 sg;
        givens_cx_warp(Wf[(s + 1) * SW + s + 2], Wf[(s + 1) * SW + s + 1], cn, sg, r);
        __syncwarp();
        put_lmat(M, cn, sg);
        hc = cn;
        hs = cneg(sg);
        if (lane == 0) {
          Wf[(s + 1) * SW + s + 1] = czero();
          Wf[(s + 1) * SW + s + 2] = r;
          put_lmat(E + 4, cn, sg);
          win_right(Wf, SW, s, s + 1, M);
          put_rmat_adj(E + 8, hc, hs);
        }
      }
    }  // factors
    // ring close on factor 0: columns k, k+1, band rows k..k+2 (cut at
    // n-1), one per lane
    __syncwarp();
    put_rmat_adj(M, hc, hs);
    if (lane == 0) put_rmat_adj(Lg + (size_t)k * kLog + 4, hc, hs);
    if (lane < 3 && k + lane <= n - 1) win_right(win, SW, s + lane, s + 1, M);
    __syncwarp();
  }
  if (k1 < i) {  // rows k1, k1+1 x columns k1-1, k1: the next corners
    for (int t = lane; t < p * 4; t += 32) {
      const int f = t / 4, a = L + (t % 4) / 2, b = L + t % 2;
      stage[t] = win[f * SS + (size_t)a * SW + b];
    }
  }
}

// Window entries (a, b) (row k0+a, column k0-1+b, up to rlast and clast)
// from H, whole block: with first, every entry of columns >= k0 (the first
// batch); else all but the corner (a, b <= 1) and the carried row (a == 0).
__device__ void fill_from_h(const double2* __restrict__ H, double2* win, int p,
                            int n, int L, int k0, int rlast, int clast,
                            bool first) {
  const int SW = L + 2;
  const int na = rlast - k0 + 1, nb = clast - k0 + 2, per = na * nb;
  for (int t = threadIdx.x; t < p * per; t += blockDim.x) {
    const int f = t / per, a = (t % per) / nb, b = t % nb;
    if (first ? b == 0 : (a == 0 || (a == 1 && b <= 1))) continue;
    win[((size_t)f * SW + a) * SW + b] = H[((size_t)f * n + k0 + a) * n + k0 - 1 + b];
  }
}

__global__ void __launch_bounds__(kGenThreads)
qz_generate_kernel(const double2* __restrict__ H, double2* __restrict__ carry,
                   double2* __restrict__ gwin, double2* __restrict__ Lg,
                   const double2* __restrict__ cs, const int* __restrict__ S,
                   int p, int n, int m, int i, int L) {
  extern __shared__ double2 smem[];
  double2* win = gwin ? gwin : smem;
  const int SW = L + 2;
  double2* stage = win + (size_t)p * SW * SW;
  double2* rs = stage + 4 * (size_t)p;
  double* rc = (double*)(rs + (size_t)p * L);
  int k0 = m, k1 = min(m + L, i);
  fill_from_h(H, win, p, n, L, k0, min(k1 + 1, n - 1), k1, true);
  __syncthreads();
  for (;;) {
    if (threadIdx.x < 32)
      gen_serial(win, stage, rc, rs, Lg, cs, S, p, n, m, i, L, k0, k1);
    if (k1 == i) break;
    __syncthreads();
    // update phase: the batch's L left rotations on columns k1+1..i of
    // every factor, one thread per (factor, column): row k0 carried (from H
    // at the first batch), rows k0+1..k1 fresh from H; row k1 goes into the
    // next window or back to the carry.  Only the second row of each
    // rotation is still needed: the first is final.
    const int k2 = min(k1 + L, i);
    const int nc = i - k1;
    for (int t = threadIdx.x; t < p * nc; t += blockDim.x) {
      const int f = t / nc, c = k1 + 1 + t % nc;
      const double2* Hc = H + (size_t)f * n * n + c;
      double2* cy = carry + (size_t)f * n + c;
      double2 x0 = (k0 == m) ? Hc[(size_t)k0 * n] : *cy;
      for (int q = 0; q < L; ++q) {
        double2 M[4];
        put_lmat(M, rc[f * L + q], rs[f * L + q]);
        const double2 x1 = Hc[(size_t)(k0 + q + 1) * n];
        x0 = cadd_a(cmul_a(M[2], x0), cmul_a(M[3], x1));
      }
      if (c <= k2)
        win[(size_t)f * SW * SW + c - k1 + 1] = x0;
      else
        *cy = x0;
    }
    // the rest of the next windows: the corners, then fresh rows of H
    for (int t = threadIdx.x; t < p * 4; t += blockDim.x)
      win[((size_t)(t / 4) * SW + (t % 4) / 2) * SW + t % 2] = stage[t];
    fill_from_h(H, win, p, n, L, k1, min(k2 + 1, n - 1), k2, false);
    __syncthreads();
    k0 = k1;
    k1 = k2;
  }
}

// Kernels B0 and B.  Both walk lines (B0: the columns >= m of every H[f];
// B: the rows 0..i of H[g] and all rows of Z[g]) along the positions m..i
// (B0: rows, B: columns).  Step k of a line maps its entries (x0, x1) at
// positions k, k+1 by the logged 2x2 M (B0: M rows on the left, B: M
// columns on the right), writes the first at k and carries the second to
// step k+1; after step i-1 the carried entry is position i.  Column m-1 of
// H[0] (the window's boundary subdiagonal) is never touched.
//
// Each block stages its lines in chunks of W positions (B0: kLeftChunk, B:
// kRightChunk) through a ring of shared-memory slots filled by 16-byte
// cp.async (a complex128 entry is 16 bytes, so every copy is aligned
// whatever n), kAhead chunks in flight ahead of the one in use, each chunk
// with the log entries its steps read (W steps of 4 complex128: L, R or
// ZR).  Chunk j's steps are q0-1..q0+w-2 (q0 = m + j W, w its positions),
// so its first step finishes the last position of chunk j-1.  The shared
// memory a block takes depends on these sizes only, never on n or p.
// Ragged tiles, chunks and spans are masked; p = 1, m = 0, i = n-1 and
// windows of one or two steps take the same code.
//
// A block has kApplyThreads threads: warp 0 walks, one line per lane, and
// all of them issue the copies and (B) write finished chunks back, which
// would otherwise sit on the walk's path.  A chunk whose steps all lie
// inside m..i-1 runs from registers: its entries are read before its first
// step (and B's outputs stored after its last), so the log entries load
// ahead of the arithmetic.  A step costs ~50-90 ns on a walking lane and a
// chunk a barrier and the ring's bookkeeping on top, so long chunks and
// many blocks win: at p=8 n=256, 16 lines a block give 128 (B0) and 256
// (B) blocks; B's chunk is shorter than B0's because its outputs wait in
// registers (254 of them at 24 positions).
//
// The complex products are written out with __fma_rn/__dmul_rn as nvcc
// contracted them in the kernels before this design (one thread per line,
// psd::cmul and psd::cadd; read off their SASS): each part fuses its first
// product, the sums are plain (cmul_a, cadd_a).  So every entry goes
// through the same operations in the same order as before, bit for bit
// (scripts/time_sweep_generate.py --cx --apply prints the hashes).
//
// B0 (replaces the JAX package's ops/pallas_sweep_cx.py:507
// _make_qz_left_kernel): a block owns kLeftCols columns of one factor, one
// per lane of warp 0, and walks their rows down through the ring; its
// stores are rows of consecutive columns, coalesced, straight to device
// memory.  B (replaces ops/pallas_sweep_cx.py:549 _make_qz_apply_kernel): a
// block owns kRightRows rows of one target, one per lane (H[g] rows 0..i
// with R of factor g, or Z[g] rows 0..n-1 with ZR), and walks the columns;
// the row pitch in shared memory is odd in 16-byte entries, so a
// quarter-warp's accesses to one column fall in distinct banks.  A chunk
// goes back to device memory as coalesced row segments once the next
// chunk's first step has finished it, with H's structural zeros and the
// logged subdiagonal H[0][r, r-1] = r (m < r < i) written exactly in the
// same pass.  What bounds both: bytes (chip_smoke.py::cx_apply_bounds) and
// the walk's chain of i-m dependent steps; times in PERF.md §6.  Without T
// (want_t=False) B0 walks only the columns < chi and B only H's rows >=
// rlo (the *_bounded entries): whole lines drop out, and the lines kept
// are bit for bit the unbounded launch's.

constexpr int kLeftChunk = 32;   // B0: positions per chunk
constexpr int kRightChunk = 24;  // B: positions per chunk (its outputs wait in registers)
constexpr int kAhead = 2;        // chunks in flight ahead of the one in use
constexpr int kLeftCols = 16;    // B0: columns per block, one per lane of warp 0
constexpr int kRightRows = 16;   // B: rows per block, one per lane of warp 0
constexpr int kRightPitch = kRightChunk | 1;  // odd: conflict-free columns
constexpr int kStep = 4;         // complex128 entries of one step's 2x2
static_assert(kRightPitch % 2 == 1, "B's row pitch must be odd");
static_assert(kApplyThreads % 32 == 0 && kApplyThreads >= kLeftCols &&
                  kApplyThreads >= kRightRows && kLeftCols <= 32 && kRightRows <= 32,
              "the walking lanes are warp 0's");

// Shared memory of B0 and B (bytes): kAhead + 1 (B0) or kAhead + 2 (B, the
// previous chunk waits for its write-back) tile slots, kAhead + 1 log slots.
constexpr size_t left_smem() {
  return sizeof(double2) * ((size_t)(kAhead + 1) * kLeftChunk * kLeftCols +
                            (size_t)(kAhead + 1) * kLeftChunk * kStep);
}
constexpr size_t right_smem() {
  return sizeof(double2) * ((size_t)(kAhead + 2) * kRightRows * kRightPitch +
                            (size_t)(kAhead + 1) * kRightChunk * kStep);
}
static_assert(left_smem() <= 48 * 1024 && right_smem() <= 48 * 1024,
              "the apply kernels launch without the shared-memory opt-in");

// Stage the log entries chunk j's steps read (at offset `at` of the log
// row: 0 L, 4 R, 8 ZR): step k = q0 - 1 + s at slot row s < W, for the
// steps m..i-1 only.  src: the factor whose log.
template <int W>
__device__ __forceinline__ void stage_log(double2* Ls, const double2* __restrict__ Lg, int n,
                                          int src, int at, int m, int i, int q0) {
  for (int e = threadIdx.x; e < W * kStep; e += blockDim.x) {
    const int k = q0 - 1 + e / kStep;
    if (k >= m && k < i)
      __pipeline_memcpy_async(Ls + e, Lg + ((size_t)src * n + k) * kLog + at + e % kStep,
                              sizeof(double2));
  }
}

// (x0, x1) <- M (x0, x1)^T for a row-major 2x2 M (B0)
__device__ __forceinline__ double2 left_step(double2& x0, double2 x1, const double2* M) {
  const double2 y0 = cadd_a(cmul_a(M[0], x0), cmul_a(M[1], x1));
  x0 = cadd_a(cmul_a(M[2], x0), cmul_a(M[3], x1));
  return y0;
}

// (x0, x1) <- (x0, x1) M for a row-major 2x2 M (B)
__device__ __forceinline__ double2 right_step(double2& x0, double2 x1, const double2* M) {
  const double2 y0 = cadd_a(cmul_a(x0, M[0]), cmul_a(x1, M[2]));
  x0 = cadd_a(cmul_a(x0, M[1]), cmul_a(x1, M[3]));
  return y0;
}

// The walk of one line over chunk j's steps (staged log Ls), and after the
// last chunk the carried entry to position i.  in(u) reads the chunk's
// position q0+u; out(d, x) takes the finished entry at position q0+d (d >=
// -1: the chunk before); x0: the carried entry.
template <bool kLeft, int W, class In, class Out>
__device__ __forceinline__ void walk_chunk(int j, int nch, int m, int i, const double2* Ls,
                                           double2& x0, In in, Out out) {
  const int q0 = m + j * W, w = min(W, i + 1 - q0);
  if (j > 0 && w == W) {  // steps q0-1..q0+W-2, all inside m..i-1
    double2 xin[W];
#pragma unroll
    for (int u = 0; u < W; ++u) xin[u] = in(u);
    if constexpr (kLeft) {  // a store to device memory cannot alias a staged entry
#pragma unroll
      for (int u = 0; u < W; ++u) out(u - 1, left_step(x0, xin[u], Ls + u * kStep));
    } else {  // the outputs go back into shared memory after the last step
      double2 y[W];
#pragma unroll
      for (int u = 0; u < W; ++u) y[u] = right_step(x0, xin[u], Ls + u * kStep);
#pragma unroll
      for (int u = 0; u < W; ++u) out(u - 1, y[u]);
    }
  } else {
    int u = 0;
    if (j == 0) x0 = in(u++);  // position m: no step reads it as x1
    for (; u < w; ++u) {
      const double2* M = Ls + u * kStep;  // step q0 - 1 + u
      out(u - 1, kLeft ? left_step(x0, in(u), M) : right_step(x0, in(u), M));
    }
  }
  if (j == nch - 1) out(w - 1, x0);
}

// B0: rows k, k+1 of every H[f] <- L[f, k] rows, for k = m..i-1.  Block (x,
// f): columns m + x kLeftCols + threadIdx.x < chi of H[f] (chi = n: all;
// the want_t=False window: i + 1).
__global__ void __launch_bounds__(kApplyThreads)
qz_left_kernel(double2* __restrict__ H, const double2* __restrict__ Lg, int n, int m,
               int i, int chi) {
  constexpr int W = kLeftChunk, NT = kAhead + 1, NL = kAhead + 1;
  extern __shared__ double2 smem[];
  double2* tiles = smem;                         // NT x W rows x kLeftCols
  double2* logs = smem + NT * W * kLeftCols;     // NL x W steps
  const int f = blockIdx.y, tid = threadIdx.x;
  const int cb = m + blockIdx.x * kLeftCols;     // the tile's first column
  const int nc = min(kLeftCols, chi - cb);
  double2* Hf = H + (size_t)f * n * n + cb;
  const int nch = (i + 1 - m + W - 1) / W;
  auto copy = [&](int j) {  // chunk j's rows
    const int q0 = m + j * W, w = min(W, i + 1 - q0);
    double2* T = tiles + (j % NT) * W * kLeftCols;
    for (int e = tid; e < w * kLeftCols; e += kApplyThreads)
      if (e % kLeftCols < nc)
        __pipeline_memcpy_async(T + e, Hf + (size_t)(q0 + e / kLeftCols) * n + e % kLeftCols,
                                sizeof(double2));
    stage_log<W>(logs + (j % NL) * W * kStep, Lg, n, f, 0, m, i, q0);
  };
  double2 x0 = czero();
  auto walk = [&](int j) {  // stores: rows of consecutive columns, coalesced
    const double2* T = tiles + (j % NT) * W * kLeftCols + tid;
    double2* out = Hf + (size_t)(m + j * W) * n + tid;
    walk_chunk<true, W>(
        j, nch, m, i, logs + (j % NL) * W * kStep, x0, [&](int u) { return T[u * kLeftCols]; },
        [&](int d, double2 x) {
          if (tid < nc) out[(ptrdiff_t)d * n] = x;
        });
  };
  psd::apply_ring<kAhead>(nch, kLeftCols, copy, walk, [](int) {});
}

// B: columns k, k+1 <- columns M for k = m..i-1.  Block (x, g, 0): rows rlo
// + x kRightRows + threadIdx.x <= i of H[g] (rlo = 0: all; the want_t=False
// window: its top row) with R[g, k], then (rows m+1..i) the structural
// zeros and the logged subdiagonal of H[0], written exactly; block (x, g,
// 1): rows of Z[g], all n, with ZR[g, k].
__global__ void __launch_bounds__(kApplyThreads)
qz_right_kernel(double2* __restrict__ H, double2* __restrict__ Z,
                const double2* __restrict__ Lg, int n, int m, int i, int rlo) {
  constexpr int W = kRightChunk, P = kRightPitch, NT = kAhead + 2, NL = kAhead + 1;
  extern __shared__ double2 smem[];
  double2* tiles = smem;                         // NT x kRightRows x P
  double2* logs = smem + NT * kRightRows * P;    // NL x W steps
  const int g = blockIdx.y, tid = threadIdx.x;
  const bool isz = blockIdx.z == 1;
  const int nrows = isz ? n : i + 1;
  const int r0 = (isz ? 0 : rlo) + blockIdx.x * kRightRows;
  if (r0 >= nrows) return;
  const int nr = min(kRightRows, nrows - r0);
  double2* A = (isz ? Z : H) + (size_t)g * n * n + (size_t)r0 * n;
  const int nch = (i + 1 - m + W - 1) / W;
  auto copy = [&](int j) {  // chunk j's row segments (its slot's chunk was written back)
    const int q0 = m + j * W, w = min(W, i + 1 - q0);
    double2* T = tiles + (j % NT) * kRightRows * P;
    for (int e = tid; e < nr * W; e += kApplyThreads)
      if (e % W < w)
        __pipeline_memcpy_async(T + (e / W) * P + e % W, A + (size_t)(e / W) * n + q0 + e % W,
                                sizeof(double2));
    stage_log<W>(logs + (j % NL) * W * kStep, Lg, n, g, isz ? 8 : 4, m, i, q0);
  };
  // chunk j's finished columns back to device memory; in H's rows m+1..i
  // the zeros below the (sub)diagonal and H[0]'s logged subdiagonal in
  // their place
  auto write_back = [&](int j) {
    const int q0 = m + j * W, w = min(W, i + 1 - q0);
    const double2* T = tiles + (j % NT) * kRightRows * P;
    for (int e = tid; e < nr * W; e += kApplyThreads) {
      const int rr = e / W, cc = e % W, r = r0 + rr, c = q0 + cc;
      if (cc >= w) continue;
      double2 x = T[rr * P + cc];
      if (!isz && r > m) {
        if (c < (g == 0 ? r - 1 : r)) x = czero();
        else if (g == 0 && c == r - 1 && r < i) x = __ldg(Lg + (size_t)r * kLog + 12);
      }
      A[(size_t)rr * n + c] = x;
    }
  };
  double2 x0 = czero();
  // a finished column goes back into its slot: this chunk's or, for the
  // position the chunk's first step finishes, the one before (indexed from
  // q0)
  auto walk = [&](int j) {
    double2* T = tiles + (j % NT) * kRightRows * P + tid * P;
    double2* Tp = tiles + ((j + NT - 1) % NT) * kRightRows * P + tid * P + W;
    walk_chunk<false, W>(
        j, nch, m, i, logs + (j % NL) * W * kStep, x0, [&](int u) { return T[u]; },
        [&](int d, double2 x) {
          if (d >= 0) T[d] = x;
          else Tp[d] = x;
        });
  };
  psd::apply_ring<kAhead>(nch, kRightRows, copy, walk, [&](int j) {
    __syncthreads();  // chunk j-1 (and at the end chunk j) finished
    if (j >= 1) write_back(j - 1);
    if (j == nch - 1) write_back(j);
  });
}

// S: the shift rotation of one sweep (act_sweep's chain): Givens through
// factors p-1..1 following S, then the closing Givens on H[0].  One warp:
// the lanes stage H[l][ifirst, ifirst], H[l][ilast, ilast] and S[l] of up
// to kShiftChunk factors (l = p-1 down, a lane every 32nd) and H[0]'s three
// entries in shared memory by cp.async, all issued at once; after
// __syncwarp the warp runs the chain on them in the parent's order, a chunk
// after the other (one chunk up to p = kShiftChunk + 1), each generation
// as givens_cx_warp (its independent divisions and square roots on
// different lanes).  The parent ran the chain on one thread: psd::givens_cx
// in the forms givens_cx_warp writes out, and a * conj(s) as cmul_conj, the
// closing difference fused (its SASS), so (c, s) stays the parent's bit for
// bit.
constexpr int kShiftChunk = 256;

// a * conj(s): the real part's first product fused, the imaginary part's
// second (the form nvcc gave psd::cmul(a, cconj(s)) in the one-thread S).
__device__ __forceinline__ double2 cmul_conj(double2 a, double2 s) {
  return make_double2(__fma_rn(a.x, s.x, __dmul_rn(a.y, s.y)),
                      __fma_rn(a.y, s.x, -__dmul_rn(a.x, s.y)));
}

__global__ void __launch_bounds__(32)
qz_shift_kernel(const double2* __restrict__ H, double2* __restrict__ cs,
                const int* __restrict__ S, int p, int n, int ifirst, int ilast) {
  __shared__ double2 hf_s[kShiftChunk], hl_s[kShiftChunk], h0_s[3];
  __shared__ int S_s[kShiftChunk];
  const int lane = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t df = (size_t)ifirst * n + ifirst, dl = (size_t)ilast * n + ilast;
  if (lane == 0) {  // committed with the first chunk
    __pipeline_memcpy_async(&h0_s[0], &H[df], sizeof(double2));
    __pipeline_memcpy_async(&h0_s[1], &H[dl], sizeof(double2));
    __pipeline_memcpy_async(&h0_s[2], &H[(size_t)(ifirst + 1) * n + ifirst], sizeof(double2));
  }
  const double2 one = make_double2(1.0, 0.0);
  double c;
  double2 s, r;
  givens_cx_warp(one, one, c, s, r);
  for (int hi = p - 1; hi >= 1; hi -= kShiftChunk) {
    const int cnt = min(hi, kShiftChunk);  // factors hi, hi-1, ..., hi-cnt+1
    for (int k = lane; k < cnt; k += 32) {
      const size_t f = (size_t)(hi - k) * nn;
      __pipeline_memcpy_async(&hf_s[k], &H[f + df], sizeof(double2));
      __pipeline_memcpy_async(&hl_s[k], &H[f + dl], sizeof(double2));
      __pipeline_memcpy_async(&S_s[k], &S[hi - k], sizeof(int));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    for (int k = 0; k < cnt; ++k) {
      const double2 hf = hf_s[k], hl = hl_s[k];
      if (S_s[k]) {
        givens_cx_warp(rmul(c, hf), cmul_conj(hl, s), c, s, r);
      } else {
        givens_cx_warp(rmul(c, hl), cneg(cmul_conj(hf, s)), c, s, r);
        s = cneg(s);
      }
    }
    __syncwarp();  // the chunk's slots are free again
  }
  __pipeline_commit();  // p == 1: H[0]'s entries alone
  __pipeline_wait_prior(0);
  __syncwarp();
  const double2 h0f = h0_s[0], h0l = h0_s[1], h0sub = h0_s[2];
  const double2 t = cmul_conj(h0l, s);
  givens_cx_warp(make_double2(__fma_rn(c, h0f.x, -t.x), __fma_rn(c, h0f.y, -t.y)),
                 rmul(c, h0sub), c, s, r);
  if (lane == 0) {
    cs[0] = make_double2(c, 0.0);
    cs[1] = s;
  }
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

// Complex128 entries of the scratch kernel A takes: the carried
// row, p n, and the windows when they do not fit in shared memory; -1 on a
// CUDA error.
long long psd_qz_sweep_generate_scratch(int p, int n) {
  GenPlan plan;
  if (gen_plan(p, plan) != cudaSuccess) return -1;
  const long long win = (long long)(window_bytes(p, plan.L) + sizeof(double2) - 1) /
                        (long long)sizeof(double2);
  return (long long)p * n + (plan.global ? win : 0);
}

// Kernel A.  H: (p, n, n) input (read only); work:
// psd_qz_sweep_generate_scratch(p, n) complex128 entries of scratch; Lg:
// (p, n, 16) output log (steps m..i-1 written); cs: the shift rotation
// (c, s) on the device; S: (p,) int signature on the device.
int psd_qz_sweep_generate(const void* H, void* work, void* Lg, const void* cs,
                          const int* S, int p, int n, int m, int i,
                          void* stream) {
  GenPlan plan;
  cudaError_t e = gen_plan(p, plan);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = plan.global ? 0 : window_bytes(p, plan.L);
  e = cudaFuncSetAttribute(qz_generate_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  double2* gwin = plan.global ? (double2*)work + (size_t)p * n : nullptr;
  qz_generate_kernel<<<1, kGenThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)H, (double2*)work, gwin, (double2*)Lg, (const double2*)cs, S, p,
      n, m, i, plan.L);
  return (int)cudaGetLastError();
}

// Kernel B0, in place on H, on the columns < chi (i + 1 <= chi <= n; the
// want_t=False window: i + 1).
int psd_qz_sweep_left_bounded(void* H, const void* Lg, int p, int n, int m, int i,
                              int chi, void* stream) {
  if (chi < i + 1 || chi > n) return (int)cudaErrorInvalidValue;
  dim3 grid((chi - m + kLeftCols - 1) / kLeftCols, p);
  qz_left_kernel<<<grid, kApplyThreads, left_smem(), (cudaStream_t)stream>>>(
      (double2*)H, (const double2*)Lg, n, m, i, chi);
  return (int)cudaGetLastError();
}

// Kernel B0 on every column.
int psd_qz_sweep_left(void* H, const void* Lg, int p, int n, int m, int i,
                      void* stream) {
  return psd_qz_sweep_left_bounded(H, Lg, p, n, m, i, n, stream);
}

// Kernel B, in place on H's rows rlo..i (0 <= rlo <= m; the want_t=False
// window: its top row) and (when Z != NULL) every row of Z.
int psd_qz_sweep_right_bounded(void* H, void* Z, const void* Lg, int p, int n, int m,
                               int i, int rlo, void* stream) {
  if (rlo < 0 || rlo > m) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kRightRows - 1) / kRightRows, p, Z ? 2 : 1);
  qz_right_kernel<<<grid, kApplyThreads, right_smem(), (cudaStream_t)stream>>>(
      (double2*)H, (double2*)Z, (const double2*)Lg, n, m, i, rlo);
  return (int)cudaGetLastError();
}

// Kernel B on every row.
int psd_qz_sweep_right(void* H, void* Z, const void* Lg, int p, int n, int m,
                       int i, void* stream) {
  return psd_qz_sweep_right_bounded(H, Z, Lg, p, n, m, i, 0, stream);
}

// Kernel S: writes (c, s) of the sweep's shift rotation to cs[0..1].
int psd_qz_shift(const void* H, void* cs, const int* S, int p, int n,
                 int ifirst, int ilast, void* stream) {
  qz_shift_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const double2*)H, (double2*)cs, S, p, n, ifirst, ilast);
  return (int)cudaGetLastError();
}

}  // extern "C"
