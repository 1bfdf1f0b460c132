// Shared device helpers of the periodic Schur kernels: reflector and Givens
// generation with the semantics of the JAX package's ops/householder.py
// (LAPACK xLARFG with the underflow rescue) and ops/rotations.py
// (givens_real, givens_complex), and complex128 arithmetic on double2.
// Correctly rounded division and sqrt only: build without --use_fast_math
// (the generations set the backward error).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cfloat>

namespace psd {

// Host: the shared memory a block of the current device may take (its
// opt-in limit).
inline cudaError_t smem_optin(int& optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

// Host: whether `bytes` of dynamic shared memory fit a block of the current
// device; if they do, kernel's limit is raised to them.
template <class K>
inline cudaError_t fit_smem(K kernel, size_t bytes, bool& fits) {
  int optin = 0;
  cudaError_t e = smem_optin(optin);
  fits = e == cudaSuccess && bytes <= (size_t)optin;
  if (fits)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return e;
}

// Host: the blocks of a cooperative launch of kernel (threads and smem
// bytes a block) that the current device holds at once, at most want.
template <class K>
inline cudaError_t coop_blocks(K kernel, int threads, size_t smem, long want, int& blocks) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  blocks = (long)per_sm * nsm < want ? per_sm * nsm : (int)want;
  return cudaSuccess;
}

// Host: the longest batch length L <= max_batch whose working set bytes(L)
// fits the shared memory a block of the current device may take; L = 0
// when not even L = 1 fits.
template <class Bytes>
inline cudaError_t longest_batch(int max_batch, Bytes bytes, int& L) {
  int optin = 0;
  const cudaError_t e = smem_optin(optin);
  if (e != cudaSuccess) return e;
  for (L = max_batch; L >= 1 && bytes(L) > (size_t)optin; --L) {
  }
  return cudaSuccess;
}

// sqrt(x^2 + z^2) by max-scaling (the JAX package's hyp3 with y == 0).
__device__ __forceinline__ double hyp2(double x, double z) {
  const double m = fmax(fabs(x), fabs(z));
  const double ms = (m == 0.0) ? 1.0 : m;
  const double xs = x / ms, zs = z / ms;
  return m * sqrt(xs * xs + zs * zs);
}

// -copysign(|mag|, sgn) with sign(0) = +1.
__device__ __forceinline__ double neg_copysign(double mag, double sgn) {
  return (sgn >= 0.0) ? -fabs(mag) : fabs(mag);
}

// xLARFG on (alpha, x) for a tail x of any length, from its max-scaled norm:
// m = max|x_r| and rs = sqrt(sum (x_r / m)^2) (m == 0 for a zero or empty
// tail).  The same arithmetic as the JAX package's _reflector_from: the
// tail's norm is m * rs, the single-round rescue multiplies by the power of
// two 1/sfmin (so the rescaled norm is (m / sfmin) * rs exactly).  The
// essential part of w is w_r = (x_r * scl) / den; a zero tail gives tau = 0,
// beta = alpha and w = 0.
__device__ __forceinline__ void reflector_from_norm(double alpha, double m,
                                                    double rs, double& tau,
                                                    double& beta, double& scl,
                                                    double& den) {
  const double sfmin = 2.0 * DBL_MIN / DBL_EPSILON;
  const double rsfmin = 1.0 / sfmin;
  const double xnorm = m * rs;
  if (xnorm == 0.0) {
    tau = 0.0;
    beta = alpha;
    scl = 0.0;
    den = 1.0;
    return;
  }
  double b = neg_copysign(hyp2(alpha, xnorm), alpha);
  double ar = alpha;
  scl = 1.0;
  const bool need = fabs(b) < sfmin;
  if (need) {  // one rescaling round suffices in binary64
    scl = rsfmin;
    ar *= rsfmin;
    b = neg_copysign(hyp2(ar, (m * rsfmin) * rs), ar);
  }
  const double bs = (b == 0.0) ? 1.0 : b;
  tau = (b - ar) / bs;
  const double d = ar - b;
  den = (d == 0.0) ? 1.0 : d;
  beta = need ? b * sfmin : b;
}

// sqrt(x^2 + y^2 + z^2) by max-scaling (the JAX package's hyp3).
__device__ __forceinline__ double hyp3(double x, double y, double z) {
  const double m = fmax(fmax(fabs(x), fabs(y)), fabs(z));
  const double ms = (m == 0.0) ? 1.0 : m;
  const double xs = x / ms, ys = y / ms, zs = z / ms;
  return m * sqrt(xs * xs + ys * ys + zs * zs);
}

// zlarfg on (alpha, x) from the tail's max-scaled norm (m = max over the
// tail of |re| and |im|, rs = sqrt(sum |x_r / m|^2)): the arithmetic of the
// JAX package's _reflector_from_complex.  beta is real, tau complex; the
// essential part of w is w_r = (x_r * scl) * dinv with dinv = 1 / (alpha -
// beta) as conj(d) / |d|^2.  Trivial (tau = 0, beta = re(alpha), w = 0)
// only for a zero tail with a real alpha.
__device__ __forceinline__ void reflector_from_norm_cx(double2 alpha, double m,
                                                       double rs, double2& tau,
                                                       double& beta, double& scl,
                                                       double2& dinv) {
  const double sfmin = 2.0 * DBL_MIN / DBL_EPSILON;
  const double rsfmin = 1.0 / sfmin;
  const double xnorm = m * rs;
  double ar = alpha.x, ai = alpha.y;
  if (xnorm == 0.0 && ai == 0.0) {
    tau = make_double2(0.0, 0.0);
    beta = ar;
    scl = 0.0;
    dinv = make_double2(1.0, 0.0);
    return;
  }
  double b = neg_copysign(hyp3(ar, ai, xnorm), ar);
  scl = 1.0;
  const bool need = fabs(b) < sfmin;
  if (need) {  // one rescaling round suffices in binary64
    scl = rsfmin;
    ar *= rsfmin;
    ai *= rsfmin;
    b = neg_copysign(hyp3(ar, ai, (m * rsfmin) * rs), ar);
  }
  const double bs = (b == 0.0) ? 1.0 : b;
  tau = make_double2((b - ar) / bs, -(ai / bs));
  double dr = ar - b;
  const double di = ai;
  if (dr == 0.0 && di == 0.0) dr = 1.0;
  const double d2 = dr * dr + di * di;
  dinv = make_double2(dr / d2, -di / d2);
  beta = need ? b * sfmin : b;
}

// xLARFG on (alpha, x1, x2): P = I - tau w w^T with w = (1, v1, v2) and
// P (alpha, x1, x2)^T = (beta, 0, 0)^T.  A 2-vector is (alpha, x1, 0).
__device__ __forceinline__ void gen_reflector(double alpha, double x1, double x2,
                                              double& tau, double& beta,
                                              double& v1, double& v2) {
  const double a1 = fabs(x1), a2 = fabs(x2);
  const double m = fmax(a1, a2);
  const double ms = (m == 0.0) ? 1.0 : m;
  const double r1 = a1 / ms, r2 = a2 / ms;
  double scl, den;
  reflector_from_norm(alpha, m, sqrt(r1 * r1 + r2 * r2), tau, beta, scl, den);
  v1 = (m == 0.0) ? 0.0 : (x1 * scl) / den;
  v2 = (m == 0.0) ? 0.0 : (x2 * scl) / den;
}

// 3x3 reflector matrix I - tau w w^T, row-major, w = (1, v1, v2).
__device__ __forceinline__ void refl_mat3(double tau, double v1, double v2,
                                          double* M) {
  const double w[3] = {1.0, v1, v2};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      M[r * 3 + c] = (r == c ? 1.0 : 0.0) - tau * (w[r] * w[c]);
}

// Real Givens (c, s) with [c s; -s c] (f, g)^T = (r, 0)^T, c >= 0;
// g == 0 gives (1, 0) exactly, f == 0 gives (0, sign(g)).
__device__ __forceinline__ void givens(double f, double g, double& c,
                                       double& s) {
  const double af = fabs(f), ag = fabs(g);
  const double scale = fmax(af, ag);
  const double sc = (scale == 0.0) ? 1.0 : scale;
  const double fs = f / sc, gs = g / sc;
  const double d = sc * sqrt(fs * fs + gs * gs);
  const double dsafe = (d == 0.0) ? 1.0 : d;
  const double r = (f >= 0.0) ? d : -d;
  if (g == 0.0) {
    c = 1.0;
    s = 0.0;
  } else if (f == 0.0) {
    c = 0.0;
    s = (g >= 0.0) ? 1.0 : -1.0;
  } else {
    c = af / dsafe;
    s = g / ((r == 0.0) ? 1.0 : r);
  }
}

// givens with r: [c s; -s c] (f, g)^T = (r, 0)^T (the JAX package's
// givens_real, operation for operation).
__device__ __forceinline__ void givens_r(double f, double g, double& c,
                                         double& s, double& r) {
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
    const double fs = f / sc, gs = g / sc;
    const double d = sc * sqrt(fs * fs + gs * gs);
    r = (f >= 0.0) ? d : -d;
    c = af / d;
    s = g / r;
  }
}

// ---- complex128 as double2 (x = re, y = im: torch's complex128 layout) ----

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 cconj(double2 a) {
  return make_double2(a.x, -a.y);
}

__device__ __forceinline__ double2 cneg(double2 a) {
  return make_double2(-a.x, -a.y);
}

// real c times complex a
__device__ __forceinline__ double2 rmul(double c, double2 a) {
  return make_double2(c * a.x, c * a.y);
}

// Complex Givens (zlartg semantics, the JAX package's givens_complex):
// c real >= 0, [c s; -conj(s) c] (f, g)^T = (r, 0)^T.  g == 0 gives
// (1, 0, f) exactly; f == 0 gives (0, conj(g)/|g|, |g|).
__device__ __forceinline__ void givens_cx(double2 f, double2 g, double& c,
                                          double2& s, double2& r) {
  const double scale =
      fmax(fmax(fabs(f.x), fabs(f.y)), fmax(fabs(g.x), fabs(g.y)));
  const double sc = (scale == 0.0) ? 1.0 : scale;
  const double fsr = f.x / sc, fsi = f.y / sc, gsr = g.x / sc, gsi = g.y / sc;
  const double f2 = fsr * fsr + fsi * fsi;
  const double g2 = gsr * gsr + gsi * gsi;
  if (g.x == 0.0 && g.y == 0.0) {
    c = 1.0;
    s = make_double2(0.0, 0.0);
    r = f;
  } else if (f.x == 0.0 && f.y == 0.0) {
    const double ag = sqrt(g2);
    const double agsafe = (ag == 0.0) ? 1.0 : ag;
    c = 0.0;
    s = make_double2(gsr / agsafe, -(gsi / agsafe));
    r = make_double2(ag * sc, 0.0);
  } else {
    const double af = sqrt(f2);
    const double d = sqrt(f2 + g2);
    const double dsafe = (d == 0.0) ? 1.0 : d;
    const double afsafe = (af == 0.0) ? 1.0 : af;
    c = af / dsafe;
    const double fgr = fsr / afsafe, fgi = fsi / afsafe;
    r = make_double2(fgr * d * sc, fgi * d * sc);
    s = make_double2((fgr * gsr + fgi * gsi) / dsafe,
                     (fgi * gsr - fgr * gsi) / dsafe);
  }
}

// ---- Givens chains (hess_signed.cu, pqz_deflate.cu): scalars T = double or
// double2 (complex128), c real; every 2x2 product written out with
// __fma_rn / __dmul_rn, so that no contraction is left to nvcc ----

constexpr int kBatch = 8;  // loads in flight per thread in a chain

__device__ __forceinline__ double cj(double x) { return x; }
__device__ __forceinline__ double2 cj(double2 x) { return make_double2(x.x, -x.y); }
__device__ __forceinline__ double ng(double x) { return -x; }
__device__ __forceinline__ double2 ng(double2 x) { return make_double2(-x.x, -x.y); }

// s * b, rounded as written
__device__ __forceinline__ double prod(double s, double b) { return __dmul_rn(s, b); }
__device__ __forceinline__ double2 prod(double2 s, double2 b) {
  return make_double2(__fma_rn(s.x, b.x, -__dmul_rn(s.y, b.y)),
                      __fma_rn(s.x, b.y, __dmul_rn(s.y, b.x)));
}

// c * a + t (c real)
__device__ __forceinline__ double axpy(double c, double a, double t) {
  return __fma_rn(c, a, t);
}
__device__ __forceinline__ double2 axpy(double c, double2 a, double2 t) {
  return make_double2(__fma_rn(c, a.x, t.x), __fma_rn(c, a.y, t.y));
}

// lmat(c, s) on a row pair: (a, b) <- (c a + s b, c b - conj(s) a)
template <class T>
__device__ __forceinline__ void rot(double c, T s, T& a, T& b) {
  const T a0 = a;
  a = axpy(c, a0, prod(s, b));
  b = axpy(c, b, ng(prod(cj(s), a0)));
}

// rmat_adj(c, s) on a column pair: (x, y) <- (c x + conj(s) y, c y - s x)
template <class T>
__device__ __forceinline__ void rot_r(double c, T s, T& x, T& y) {
  rot(c, cj(s), x, y);
}

__device__ __forceinline__ void gen(double f, double g, double& c, double& s, double& r) {
  givens_r(f, g, c, s, r);
}
__device__ __forceinline__ void gen(double2 f, double2 g, double& c, double2& s,
                                    double2& r) {
  givens_cx(f, g, c, s, r);
}

// A chain of rotations on the entries e[ihi], e[ihi-1], ... of one column
// (stride n: row updates, lmat(gc[i], gs[i]) on rows i-1, i) or one row
// (stride 1: column updates, rmat_adj(gc[i], gs[i]) on columns i-1, i), for
// i = ihi down to lo; e[i] is final after step i, e[i-1] is carried.
// Returns the carried entry (e[lo-1]'s new value) for the caller to store.
// Each entry is read before any step writes it, so a batch's loads are
// issued together.
template <bool kRight, class T>
__device__ __forceinline__ T chain(T* e, size_t stride, int ihi, int lo, const double* gc,
                                   const T* gs) {
  T b = e[(size_t)ihi * stride];
  for (int i0 = ihi; i0 >= lo; i0 -= kBatch) {
    const int m = i0 - lo + 1 < kBatch ? i0 - lo + 1 : kBatch;
    T a[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t)
      if (t < m) a[t] = e[(size_t)(i0 - 1 - t) * stride];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      if (t < m) {
        const int i = i0 - t;
        rot(gc[i], kRight ? cj(gs[i]) : gs[i], a[t], b);
        e[(size_t)i * stride] = b;
        b = a[t];
      }
    }
  }
  return b;
}

// x0 * f0 + x1 * f1 + x2 * f2 with the middle product rounded, the first
// fused onto it, then the third: the form nvcc gave that sum (and `f0 * x0
// + ...`) in the earlier designs of the real and real generalized sweep
// kernels (their SASS).  Written out, so that a redesign keeps their
// results bit for bit whatever nvcc would contract now.
__device__ __forceinline__ double dot3(double x0, double x1, double x2, double f0,
                                       double f1, double f2) {
  return __fma_rn(x2, f2, __fma_rn(x0, f0, __dmul_rn(x1, f1)));
}

// The ring of the apply kernels B0 and B (sweep.cu, sweep_cx.cu,
// sweep_rg.cu): a block's nch chunks, copy(j) issuing chunk j's
// asynchronous copies (tile and log entries), one commit group per chunk,
// kAhead chunks ahead of the one in use; walk(j) runs on the first `lines`
// threads once chunk j has landed, after(j) on every thread after it.
template <int kAhead, class Copy, class Walk, class After>
__device__ __forceinline__ void apply_ring(int nch, int lines, Copy copy, Walk walk,
                                           After after) {
  for (int j = 0; j < kAhead; ++j) {
    if (j < nch) copy(j);
    __pipeline_commit();
  }
  for (int j = 0; j < nch; ++j) {
    __pipeline_wait_prior(kAhead - 1);
    __syncthreads();  // chunk j has landed; the slot chunk j + kAhead takes is free
    if (j + kAhead < nch) copy(j + kAhead);
    __pipeline_commit();
    if (threadIdx.x < lines) walk(j);
    after(j);
  }
}

}  // namespace psd
