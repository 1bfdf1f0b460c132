// Per-iteration glue of the real periodic QR core (kernel G), float64.
//
// Replaces the Pallas kernel _make_glue_kernel of the JAX package's
// ops/pallas_glue.py.  From the ghost-padded (p, N, N) stack H (N = n + 1)
// it computes, in one launch, the per-iteration glue of the float64 real
// periodic QR core (ops/pqr_real.py, which reads it back each iteration):
//   * the band entries hdiag, hsub, hsup of the cycle product (unscaled, as
//     in the float64 core);
//   * the deflation scan over rows l+1..i (tightened Ahues-Tisseur test
//     with the smlnum terms, the stagnation relaxation at its >= 16, or
//     slicot_convg) and its bottom-most hit lnew;
//   * the normalized double-shift first column v0 at m = lnew (_shift_v0:
//     dlahqr shifts, the exceptional shifts at its == 10 and its % 10 == 0,
//     slicot_shifts);
// and packs them, with the factor entries the repair test and the 2x2
// deflation read, into one buffer the host copies back in one transfer:
//   out[0] = lnew, out[1..3] = v0, out[4 .. 4+3n) = hdiag, hsub, hsup;
//   out[4+3n + 3f + {0,1,2}] = D[f][i-1], D[f][i], U[f][i-1]  (f < p);
//   out[4+3n+3p + {0,1,2,3}] = S0[i], D[0][lnew-1], D[0][lnew], S0[lnew]
// (D: diagonal, U: superdiagonal, S0[r] = H[0][r, r-1]; an entry left of
// column 0 is 0).
//
// Every product, sum and quotient is written with __dmul_rn / __dadd_rn /
// __dsub_rn / __ddiv_rn / __dsqrt_rn in numpy's left-to-right order, so
// that nvcc contracts nothing into FMA and G reproduces the numpy glue of
// the float64 core bit for bit: the deflation decisions hang on these values.
//
// What bounds it: it reads 3 p n doubles (diagonals 0 and 1 of every factor,
// diagonal 2 of H[1..p-1], the subdiagonal of H[0]), a fraction of a
// microsecond of memory traffic; the launch and the round trips to memory
// set its time.  The diagonals have a stride of N + 1 doubles: a row's D, U,
// V share one or two 32-byte sectors, and each row of each factor is sectors
// of its own, ~1.5 p n in all (12k at p=16 n=512).  One block cannot pull
// them in fast: a one-block design that staged them all by cp.async took as
// long as the parent's serial loads (~15 against ~14 µs on an H100).  So:
//   * the rows are cut into chunks of kGlueRows, one chunk a block; a
//     block stages the three diagonals of factors 1..p-1
//     at its chunk's rows and a halo of two rows above and three below
//     (rows r+1 and r+2 enter row r's recurrence; the chunk's scan reads
//     the band at row r0-1, the band the products at r0-2..r0+R) into shared
//     memory by 8-byte cp.async, in groups of K factors through a ring of
//     kAhead + 1 slots (psd::apply_ring), kAhead groups in flight; the host
//     takes K so that kAhead groups hold all p-1 factors where the shared
//     memory allows it;
//   * H[0]'s diagonal, superdiagonal and subdiagonal at the chunk's rows
//     come with the first group, and block 0 stages the factor entries of
//     the repair test (a factor a thread, grid-stride over p) with it;
//   * a thread a row runs the recurrence through the factors on the staged
//     entries, then the product with H[0] and the scan of the chunk's rows
//     (each warp's bottom-most hit by __reduce_max_sync, then the block's);
//     each block writes its band rows and its hit to device memory;
//   * the last block to finish (a counter in the scratch, which psd_glue
//     zeroes on the stream before each launch: no grid barrier, so a plain
//     launch) takes the bottom-most hit of the blocks, and its thread 0 computes
//     the shift from the band in device memory (L2) in the parent's order
//     and writes the tail from H.  (A cooperative launch with a grid
//     barrier took as long on the card, and its launch costs the host
//     ~10 µs more a call.)
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

constexpr int kGlueThreads = 64;
constexpr int kGlueRows = 32;  // rows a block scans; <= kGlueThreads - 3
constexpr int kAhead = 3;      // factor groups in flight
constexpr int kSlots = kAhead + 1;
static_assert(kGlueRows + 3 <= kGlueThreads && kGlueThreads % 32 == 0, "a thread a row");

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

struct Shift {
  double h44E, h33E, h43h34E, rt1r, rt1i, rt2r, rt2i;
  bool use_exc;
};

// The unnormalized first column of _shift_v0's first_col.
__device__ void first_col(const Shift& s, double h11, double h12, double h21,
                          double h22, double h32, double v[3]) {
  if (s.use_exc) {
    const double h44s = sub(s.h44E, h11);
    const double h33s = sub(s.h33E, h11);
    const double h21s_ = (h21 == 0.0) ? 1.0 : h21;
    v[0] = add(dvd(sub(mul(h33s, h44s), s.h43h34E), h21s_), h12);
    v[1] = sub(sub(sub(h22, h11), h33s), h44s);
    v[2] = h32;
    return;
  }
  const double sv = add(add(fabs(sub(h11, s.rt2r)), fabs(s.rt2i)), fabs(h21));
  const double svs = (sv == 0.0) ? 1.0 : sv;
  const double h21s = dvd(h21, svs);
  v[0] = sub(add(mul(h21s, h12), mul(sub(h11, s.rt1r), dvd(sub(h11, s.rt2r), svs))),
             mul(s.rt1i, dvd(s.rt2i, svs)));
  v[1] = mul(h21s, sub(sub(add(h11, h22), s.rt1r), s.rt2r));
  v[2] = mul(h21s, h32);
}

// Staged rows of a factor: the chunk's R rows, two above, three below.
constexpr int kW = kGlueRows + 5;

// Doubles of a block's dynamic shared memory: the ring (kSlots slots of K
// factors, each D, U, V at kW rows), the factor entries (3p), the products
// (3 (R+3) rows r0-2..r0+R), the band and H[0]'s D, U, S0 (3 (R+1) each,
// rows r0-1..r0+R-1), the warps' hits and the last block's flag (ints).
inline size_t glue_doubles(int p, int K) {
  return (size_t)kSlots * K * 3 * kW + 3 * (size_t)p + 3 * (kGlueRows + 3) +
         6 * (kGlueRows + 1) + kGlueThreads / 32 + 1;
}

__global__ void __launch_bounds__(kGlueThreads)
glue_kernel(const double* __restrict__ H, double* __restrict__ out,
            double* __restrict__ ws, int p, int n, int l, int i, int its,
            int slicot_convg, int slicot_shifts, double ulp, double ulpx,
            double smlnum, int K) {
  extern __shared__ double smem[];
  constexpr int R = kGlueRows, W = kW;
  const int N = n + 1;
  const size_t NN = (size_t)N * N;
  const size_t ghost = (size_t)n * N + n;  // a padded entry that stays zero
  const int tid = threadIdx.x;
  auto iD = [&](int f, int r) { return f * NN + (size_t)r * N + r; };
  auto iU = [&](int f, int r) { return f * NN + (r < n - 1 ? (size_t)r * N + r + 1 : ghost); };
  auto iV = [&](int f, int r) { return f * NN + (r < n - 2 ? (size_t)r * N + r + 2 : ghost); };
  auto iS0 = [&](int r) { return r >= 1 ? (size_t)r * N + r - 1 : ghost; };
  auto stage = [](double* dst, const double* src) {
    __pipeline_memcpy_async(dst, src, sizeof(double));
  };
  const int ng = (p - 1 + K - 1) / K;  // factor groups (none at p == 1)
  double* ring = smem;
  double* sfac = ring + (size_t)kSlots * K * 3 * W;
  double* P1 = sfac + 3 * p;  // rows r0-2 .. r0+R at 0 .. R+2
  double* P2 = P1 + R + 3;
  double* P3 = P2 + R + 3;
  double* hd = P3 + R + 3;  // rows r0-1 .. r0+R-1 at 0 .. R
  double* hs = hd + R + 1;
  double* hu = hs + R + 1;
  double* D0 = hu + R + 1;
  double* U0 = D0 + R + 1;
  double* S0 = U0 + R + 1;
  int* s_best = (int*)(S0 + R + 1);  // a warp's hit
  int* s_last = s_best + kGlueThreads / 32;
  double* hdiag = out + 4;
  double* hsub = hdiag + n;
  double* hsup = hsub + n;
  double* fac = hsup + n;

  if (blockIdx.x == 0) {  // committed with the first group
    for (int f = tid; f < p; f += kGlueThreads) {
      if (i >= 1) {
        stage(&sfac[3 * f], &H[iD(f, i - 1)]);
        stage(&sfac[3 * f + 2], &H[iU(f, i - 1)]);
      }
      stage(&sfac[3 * f + 1], &H[iD(f, i)]);
    }
  }
  const int r0 = blockIdx.x * R;  // the block's chunk
  for (int t = tid; t < R + 1; t += kGlueThreads) {  // H[0] at rows r0-1 ..
    const int r = r0 - 1 + t;
    if (r >= 0 && r < n) {
      stage(&D0[t], &H[iD(0, r)]);
      stage(&U0[t], &H[iU(0, r)]);
      stage(&S0[t], &H[iS0(r)]);
    }
  }
  // ---- band products of H[1] @ ... @ H[p-1] at rows r0-2 .. r0+R ------
  auto slot = [&](int g) { return ring + (size_t)(g % kSlots) * K * 3 * W; };
  auto copy = [&](int g) {
    const int f0 = 1 + g * K, kg = min(K, p - f0);
    double* s = slot(g);
    for (int t = tid; t < kg * W; t += kGlueThreads) {
      const int fl = t / W, rr = t % W, r = r0 - 2 + rr, f = f0 + fl;
      if (r < 0 || r >= n) continue;  // never read: the recurrence takes 0 there
      double* sf = s + (size_t)fl * 3 * W;
      stage(&sf[rr], &H[iD(f, r)]);
      if (rr < W - 1) stage(&sf[W + rr], &H[iU(f, r)]);
      if (rr < W - 2) stage(&sf[2 * W + rr], &H[iV(f, r)]);
    }
  };
  double p1 = 1.0, p2 = 0.0, p3 = 0.0;
  const int rp = r0 - 2 + tid;  // this thread's row of the products
  const bool mine = tid < R + 3 && rp >= 0 && rp < n;
  auto walk = [&](int g) {
    if (!mine) return;
    const int f0 = 1 + g * K, kg = min(K, p - f0);
    const double* sf = slot(g);
    for (int fl = 0; fl < kg; ++fl, sf += 3 * W) {
      const double* Ds = sf + tid;
      const double* Us = sf + W + tid;
      const double* Vs = sf + 2 * W + tid;
      const double d1 = (rp + 1 < n) ? Ds[1] : 0.0;
      const double u1 = (rp + 1 < n) ? Us[1] : 0.0;
      const double d2 = (rp + 2 < n) ? Ds[2] : 0.0;
      const double q3 = add(add(mul(p1, Vs[0]), mul(p2, u1)), mul(p3, d2));
      const double q2 = add(mul(p1, Us[0]), mul(p2, d1));
      p1 = mul(p1, Ds[0]);
      p2 = q2;
      p3 = q3;
    }
  };
  psd::apply_ring<kAhead>(ng, kGlueThreads, copy, walk, [](int) {});
  __pipeline_wait_prior(0);
  if (mine) {
    P1[tid] = p1;
    P2[tid] = p2;
    P3[tid] = p3;
  }
  __syncthreads();
  if (blockIdx.x == 0) {  // its first group brought the factor entries
    for (int f = tid; f < p; f += kGlueThreads) {
      fac[3 * f] = (i >= 1) ? sfac[3 * f] : 0.0;
      fac[3 * f + 1] = sfac[3 * f + 1];
      fac[3 * f + 2] = (i >= 1) ? sfac[3 * f + 2] : 0.0;
    }
  }
  // ---- times H[0], rows r0-1 .. r0+R-1 ------------------------------------
  if (tid < R + 1) {
    const int r = r0 - 1 + tid;
    if (r >= 0 && r < n) {
      const double s0 = S0[tid], d0 = D0[tid], u0 = U0[tid];
      const double p1m = (r >= 1) ? P1[tid] : 1.0;
      const double p2m = (r >= 1) ? P2[tid] : 0.0;
      const double p3m = (r >= 1) ? P3[tid] : 0.0;
      const double p11 = (r + 1 < n) ? P1[tid + 2] : 0.0;
      const double h_s = mul(s0, p1m);
      const double h_d = add(mul(s0, p2m), mul(d0, P1[tid + 1]));
      const double h_u = add(add(mul(s0, p3m), mul(d0, P2[tid + 1])), mul(u0, p11));
      hs[tid] = h_s;
      hd[tid] = h_d;
      hu[tid] = h_u;
      if (tid >= 1) {  // row r0-1 is the chunk before's
        hsub[r] = h_s;
        hdiag[r] = h_d;
        hsup[r] = h_u;
      }
    }
  }
  __syncthreads();
  // ---- deflation scan of the chunk: the bottom-most hit in [l+1, i] -------
  int best = -1;
  const int r = r0 + tid;
  if (tid < R && r < n && r >= l + 1 && r <= i) {
    const double hh11 = (r >= 1) ? hd[tid] : 0.0;
    const double hh12 = (r >= 1) ? hu[tid] : 0.0;
    const double hh22 = hd[tid + 1];
    const double a21 = fabs(hs[tid + 1]);
    const double tst1 = add(fabs(hh11), fabs(hh22));
    const double relax = fmax(mul(ulp, tst1), smlnum);
    bool found;
    if (slicot_convg) {
      found = a21 <= relax;
    } else {
      const double a12 = fabs(hh12);
      const double ab = fmax(a21, a12), ba = fmin(a21, a12);
      const double dd = fabs(sub(hh11, hh22));
      const double aa = fmax(fabs(hh22), dd), bb = fmin(fabs(hh22), dd);
      const double stmp = add(aa, ab);
      const double stmps = (stmp == 0.0) ? 1.0 : stmp;
      const bool at_ok = mul(ba, dvd(ab, stmps)) <=
                         fmax(smlnum, mul(ulpx, mul(bb, dvd(aa, stmps))));
      found = (a21 <= smlnum) || ((a21 <= mul(ulp, tst1)) && at_ok);
      if (its >= 16) found = found || (a21 <= relax);
    }
    if (found) best = r;
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if ((tid & 31) == 0) s_best[tid >> 5] = best;
  // ---- the last block to finish: the blocks' hits, the shift, the tail ------
  unsigned* arrived = (unsigned*)ws;  // zeroed by psd_glue before the launch
  int* bests = (int*)ws + 1;
  __threadfence();  // this thread's band rows and factor entries, for that block
  __syncthreads();
  if (tid == 0) {
    int b = -1;
    for (int w = 0; w < kGlueThreads / 32; ++w) b = max(b, s_best[w]);
    bests[blockIdx.x] = b;
    __threadfence();
    *s_last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!*s_last || tid != 0) return;
  int b = -1;
  for (int k = 0; k < (int)gridDim.x; ++k) b = max(b, __ldcg(&bests[k]));
  const int lnew = (i > l) ? (b >= 0 ? b : l) : i;

  // ---- double-shift first column at m = lnew (the band from L2) -------------
  auto cl = [n](int j) { return min(max(j, 0), n - 1); };
  auto HD = [&](int r) { return __ldcg(&hdiag[r]); };
  auto HS = [&](int r) { return __ldcg(&hsub[r]); };
  auto HU = [&](int r) { return __ldcg(&hsup[r]); };
  const bool exc1 = its == 10;
  const bool exc = exc1 || (its % 10 == 0);
  const double sE = exc1 ? add(fabs(HS(cl(lnew + 1))), fabs(HS(cl(lnew + 2))))
                         : add(fabs(HS(i)), fabs(HS(cl(i - 1))));
  Shift s;
  s.h44E = add(mul(0.75, sE), exc1 ? HD(lnew) : HD(i));
  s.h33E = s.h44E;
  s.h43h34E = mul(mul(-0.4375, sE), sE);
  const double h44 = HD(i), h33 = HD(cl(i - 1));
  const double h43 = HS(i), h34 = HU(cl(i - 1));
  const double ssh = add(add(add(fabs(h33), fabs(h34)), fabs(h43)), fabs(h44));
  const double sshs = (ssh == 0.0) ? 1.0 : ssh;
  const double h33n = dvd(h33, sshs), h44n = dvd(h44, sshs);
  const double h34n = dvd(h34, sshs), h43n = dvd(h43, sshs);
  const double trc = mul(add(h33n, h44n), 0.5);
  const double disc = sub(mul(sub(h33n, trc), sub(h44n, trc)), mul(h34n, h43n));
  const double rtdisc = __dsqrt_rn(fabs(disc));
  if (ssh == 0.0) {
    s.rt1r = 0.0;
    s.rt1i = 0.0;
  } else if (disc >= 0.0) {
    s.rt1r = mul(trc, ssh);
    s.rt1i = mul(rtdisc, ssh);
  } else {
    const double r1 = add(trc, rtdisc), r2 = sub(trc, rtdisc);
    s.rt1r = mul((fabs(sub(r1, h44n)) <= fabs(sub(r2, h44n))) ? r1 : r2, ssh);
    s.rt1i = 0.0;
  }
  s.rt2r = s.rt1r;
  s.rt2i = -s.rt1i;
  s.use_exc = exc || slicot_shifts;
  const int m = lnew;
  double v[3];
  first_col(s, HD(m), HU(m), HS(cl(m + 1)), HD(cl(m + 1)), HS(cl(m + 2)), v);
  const double sn = add(add(fabs(v[0]), fabs(v[1])), fabs(v[2]));
  const double sns = (sn == 0.0) ? 1.0 : sn;
  out[0] = (double)lnew;
  out[1] = dvd(v[0], sns);
  out[2] = dvd(v[1], sns);
  out[3] = dvd(v[2], sns);

  // ---- the entries of the repair test and the 2x2 deflation at lnew ---------
  double* tail = fac + 3 * p;
  tail[0] = H[iS0(i)];
  tail[1] = (lnew >= 1) ? H[iD(0, lnew - 1)] : 0.0;
  tail[2] = H[iD(0, lnew)];
  tail[3] = H[iS0(lnew)];
}

// The launch's factor group K: the largest up to the one that puts all p-1
// factors in kAhead groups whose ring fits the shared memory.
cudaError_t glue_plan(int p, int& K, size_t& bytes) {
  int optin = 0;
  const cudaError_t e = psd::smem_optin(optin);
  if (e != cudaSuccess) return e;
  for (K = p > 1 ? (p - 1 + kAhead - 1) / kAhead : 1; K >= 1; --K) {
    bytes = sizeof(double) * glue_doubles(p, K);
    if (bytes <= (size_t)optin) return cudaSuccess;
  }
  return cudaErrorInvalidValue;  // 3p factor entries beyond the shared memory
}

}  // namespace

extern "C" {

// Kernel G.  H: (p, N, N) ghost-padded stack (read only); out: 8 + 3n + 3p
// doubles (the layout above); ws: 3n doubles of scratch (the blocks' hits
// and their counter, which it zeroes on the stream before the launch).
int psd_glue(const double* H, double* out, double* ws, int p, int n, int l,
             int i, int its, int slicot_convg, int slicot_shifts, double ulp,
             double ulpx, double smlnum, void* stream) {
  int K = 1;
  size_t bytes = 0;
  cudaError_t e = glue_plan(p, K, bytes);
  if (e != cudaSuccess) return (int)e;
  // the kernel's shared-memory limit, raised once per device as far as needed
  static size_t limit[64] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > 48 * 1024 && bytes > limit[dev & 63]) {
    e = cudaFuncSetAttribute(glue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    limit[dev & 63] = bytes;
  }
  e = cudaMemsetAsync(ws, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  glue_kernel<<<(n + kGlueRows - 1) / kGlueRows, kGlueThreads, bytes, (cudaStream_t)stream>>>(
      H, out, ws, p, n, l, i, its, slicot_convg, slicot_shifts, ulp, ulpx, smlnum, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
