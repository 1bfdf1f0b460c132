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
// One block: the band recurrence is local to each row (row r reads rows r,
// r+1, r+2 of every factor), so the rows spread over the threads and the
// p-loop runs serially inside each; the products go through a scratch ws
// (3n) for the neighbouring rows, the band through out itself.  Thread 0
// computes the shift.  Bound: it reads 3 p n doubles (diagonals 0 and 1 of
// every factor, diagonal 2 of H[1..p-1], the subdiagonal of H[0]), a
// fraction of a microsecond of memory traffic; launch latency and the serial
// p-loop of dependent loads set its time.
#include <cuda_runtime.h>

namespace {

constexpr int kGlueThreads = 512;

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

__global__ void __launch_bounds__(kGlueThreads)
glue_kernel(const double* __restrict__ H, double* __restrict__ out,
            double* __restrict__ ws, int p, int n, int l, int i, int its,
            int slicot_convg, int slicot_shifts, double ulp, double ulpx,
            double smlnum) {
  __shared__ int s_best;
  const int N = n + 1;
  const size_t NN = (size_t)N * N;
  const size_t ghost = (size_t)n * N + n;  // a padded entry that stays zero
  const int tid = threadIdx.x;
  auto Dg = [&](int f, int r) { return H[f * NN + (size_t)r * N + r]; };
  auto Ug = [&](int f, int r) {
    return H[f * NN + (r < n - 1 ? (size_t)r * N + r + 1 : ghost)];
  };
  auto Vg = [&](int f, int r) {
    return H[f * NN + (r < n - 2 ? (size_t)r * N + r + 2 : ghost)];
  };
  auto S0g = [&](int r) { return H[r >= 1 ? (size_t)r * N + r - 1 : ghost]; };
  double* P1 = ws;
  double* P2 = ws + n;
  double* P3 = ws + 2 * n;
  double* hdiag = out + 4;
  double* hsub = out + 4 + n;
  double* hsup = out + 4 + 2 * n;
  if (tid == 0) s_best = -1;

  // ---- band products of H[1] @ ... @ H[p-1], row by row ------------------
  for (int r = tid; r < n; r += blockDim.x) {
    double p1 = 1.0, p2 = 0.0, p3 = 0.0;
    for (int f = 1; f < p; ++f) {
      const double d1 = (r + 1 < n) ? Dg(f, r + 1) : 0.0;
      const double u1 = (r + 1 < n) ? Ug(f, r + 1) : 0.0;
      const double d2 = (r + 2 < n) ? Dg(f, r + 2) : 0.0;
      const double q3 = add(add(mul(p1, Vg(f, r)), mul(p2, u1)), mul(p3, d2));
      const double q2 = add(mul(p1, Ug(f, r)), mul(p2, d1));
      p1 = mul(p1, Dg(f, r));
      p2 = q2;
      p3 = q3;
    }
    P1[r] = p1;
    P2[r] = p2;
    P3[r] = p3;
  }
  __syncthreads();
  // ---- times H[0] -----------------------------------------------------------
  for (int r = tid; r < n; r += blockDim.x) {
    const double s0 = S0g(r), d0 = Dg(0, r), u0 = Ug(0, r);
    const double p1m = (r >= 1) ? P1[r - 1] : 1.0;
    const double p2m = (r >= 1) ? P2[r - 1] : 0.0;
    const double p3m = (r >= 1) ? P3[r - 1] : 0.0;
    const double p11 = (r + 1 < n) ? P1[r + 1] : 0.0;
    hsub[r] = mul(s0, p1m);
    hdiag[r] = add(mul(s0, p2m), mul(d0, P1[r]));
    hsup[r] = add(add(mul(s0, p3m), mul(d0, P2[r])), mul(u0, p11));
  }
  __syncthreads();
  // ---- deflation scan: the bottom-most hit in [l+1, i] ----------------------
  int best = -1;
  for (int r = tid; r <= i; r += blockDim.x) {
    if (r < l + 1) continue;
    const double hh11 = (r >= 1) ? hdiag[r - 1] : 0.0;
    const double hh12 = (r >= 1) ? hsup[r - 1] : 0.0;
    const double hh22 = hdiag[r];
    const double a21 = fabs(hsub[r]);
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
    if (found) best = r;  // r grows along the loop
  }
  if (best >= 0) atomicMax(&s_best, best);
  __syncthreads();
  if (tid != 0) return;
  const int lnew = (i > l) ? (s_best >= 0 ? s_best : l) : i;

  // ---- double-shift first column at m = lnew --------------------------------
  auto cl = [n](int j) { return min(max(j, 0), n - 1); };
  const bool exc1 = its == 10;
  const bool exc = exc1 || (its % 10 == 0);
  const double sE = exc1 ? add(fabs(hsub[cl(lnew + 1)]), fabs(hsub[cl(lnew + 2)]))
                         : add(fabs(hsub[i]), fabs(hsub[cl(i - 1)]));
  Shift s;
  s.h44E = add(mul(0.75, sE), exc1 ? hdiag[lnew] : hdiag[i]);
  s.h33E = s.h44E;
  s.h43h34E = mul(mul(-0.4375, sE), sE);
  const double h44 = hdiag[i], h33 = hdiag[cl(i - 1)];
  const double h43 = hsub[i], h34 = hsup[cl(i - 1)];
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
  first_col(s, hdiag[m], hsup[m], hsub[cl(m + 1)], hdiag[cl(m + 1)],
            hsub[cl(m + 2)], v);
  const double sn = add(add(fabs(v[0]), fabs(v[1])), fabs(v[2]));
  const double sns = (sn == 0.0) ? 1.0 : sn;
  out[0] = (double)lnew;
  out[1] = dvd(v[0], sns);
  out[2] = dvd(v[1], sns);
  out[3] = dvd(v[2], sns);

  // ---- factor entries of the repair test and the 2x2 deflation --------------
  double* fac = out + 4 + 3 * n;
  for (int f = 0; f < p; ++f) {
    fac[3 * f] = (i >= 1) ? Dg(f, i - 1) : 0.0;
    fac[3 * f + 1] = Dg(f, i);
    fac[3 * f + 2] = (i >= 1) ? Ug(f, i - 1) : 0.0;
  }
  double* tail = fac + 3 * p;
  tail[0] = S0g(i);
  tail[1] = (lnew >= 1) ? Dg(0, lnew - 1) : 0.0;
  tail[2] = Dg(0, lnew);
  tail[3] = S0g(lnew);
}

}  // namespace

extern "C" {

// Kernel G.  H: (p, N, N) ghost-padded stack (read only); out: 8 + 3n + 3p
// doubles (the layout above); ws: 3n doubles of scratch.
int psd_glue(const double* H, double* out, double* ws, int p, int n, int l,
             int i, int its, int slicot_convg, int slicot_shifts, double ulp,
             double ulpx, double smlnum, void* stream) {
  glue_kernel<<<1, kGlueThreads, 0, (cudaStream_t)stream>>>(
      H, out, ws, p, n, l, i, its, slicot_convg, slicot_shifts, ulp, ulpx,
      smlnum);
  return (int)cudaGetLastError();
}

}  // extern "C"
