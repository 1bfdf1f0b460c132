// The deflation actions of the periodic QZ iterations (a negligible diagonal
// entry of a triangular factor, and the controlled zero shift), float64 and
// complex128, each in one launch of one block.
//
// The JAX package runs them in jnp inside its jitted cores, with no Pallas
// kernel: make_deflate_cores (ops/pqz_deflate.py:30-550), pos_core at :73
// (DEFLATE_POS), neg_core at :266 (DEFLATE_NEG, chase_down :274, chase_up
// :360) and czshift_core at :454 (CZSHIFT).  Semantics: pos_core_plain,
// neg_core_plain and czshift_core_plain of the port's ops/pqz_deflate.py, on
// the (p, n, n) row-major stacks H (in place) and ZT (ZT[l] = Z[l]^T, or
// NULL), with the signature S (p ints, S[0] = 1).
//
// Each action is a transcription of its plain body, in the plain order, in
// four block-wide primitives that clamp their indices as the plain version's
// givens_at, rowsk, colsk and setel (ops/rotations.py) do:
//   gen_at  every thread reads the two clamped entries, and after a barrier
//           generates the same rotation (psd::givens_r / psd::givens_cx) in
//           registers;
//   row2    lmat(c, s) on rows i, i+1 (i clamped to [0, n-2]) over the
//           clamped column span, one column a thread;
//   col2    rmat_adj(c, s) on columns j, j+1 over the clamped row span, one
//           row a thread (lmat on the right is rmat_adj(c, -s));
//   setel   a clamped write by the thread that owns the entry in the update
//           that follows it, so that the update sees it with no barrier.
// A thread owns the rows and columns r == threadIdx.x (mod blockDim.x).  A
// block barrier separates an update from the generation that reads it, and
// an update from the next update of the same factor.  Where a chain's
// rotations are all known before it is applied (Z's chains, CZSHIFT's
// stage C, DEFLATE_POS's final chains on H[0]), each thread applies them to
// its own rows or columns in the chain's order with no barrier: every entry
// sees the plain version's operations in the plain order.  Z's column
// updates are row updates of ZT, whose loads coalesce.  The rotations of a
// chain (n of them) live in shared memory, or in the global scratch ws when
// they do not fit (n above ~14.5k real, ~9.6k complex on an H100; from ws
// CZSHIFT takes ~5% longer, PERF.md §6).
//
// Numerics: every 2x2 product written out with __fma_rn / __dmul_rn
// (psd::rot); no fast math; the annihilated entries are written as exact
// zeros; CZSHIFT's negligibility test takes the modulus (hypot) of a
// complex entry, as the plain version's abs does.
//
// Bound: each rotation updates at most 2 n entries of H and 2 n of Z (6
// real operations an entry), so an action moves a few MB at most and its
// bound is a few microseconds; one block instead runs a chain of up to p m
// dependent generations (m the window's length), each behind a barrier.
#include <cuda_runtime.h>

#include "psd_common.cuh"

namespace {

using psd::chain;
using psd::cj;
using psd::gen;
using psd::ng;
using psd::rot;

constexpr int kMaxThreads = 512;

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }
__device__ __forceinline__ bool is_zero(double x) { return x == 0.0; }
__device__ __forceinline__ bool is_zero(double2 x) { return x.x == 0.0 && x.y == 0.0; }
__device__ __forceinline__ double mag(double x) { return fabs(x); }
__device__ __forceinline__ double mag(double2 x) { return hypot(x.x, x.y); }

// One action's view of the problem: the stacks, the signature and the
// rotations of the chain in flight (gc: c, gs: s, indexed by position).
template <class T>
struct Act {
  T* H;
  T* ZT;
  const int* S;
  double* gc;
  T* gs;
  int p, n, tid, nt;

  __device__ T* fac(int l) const { return H + (size_t)l * n * n; }
  __device__ T& at(T* M, int i, int j) const {
    return M[(size_t)clampi(i, 0, n - 1) * n + clampi(j, 0, n - 1)];
  }
  // the first index >= a that this thread owns
  __device__ int first(int a) const { return a + ((tid - a) % nt + nt) % nt; }

  // every thread reads the two entries before the barrier, so that none
  // sees the setel that follows
  __device__ void gen_at(T* M, int i0, int j0, int i1, int j1, double& c, T& s,
                         T& r) const {
    const T f = at(M, i0, j0), g = at(M, i1, j1);
    __syncthreads();
    gen(f, g, c, s, r);
  }
  // setel before a row update (the column's owner) or a column update (the row's)
  __device__ void set_r(T* M, int i, int j, T v) const {
    if (clampi(j, 0, n - 1) % nt == tid) at(M, i, j) = v;
  }
  __device__ void set_c(T* M, int i, int j, T v) const {
    if (clampi(i, 0, n - 1) % nt == tid) at(M, i, j) = v;
  }
  // rowsk(M, i, lmat(c, s), lo, hi)
  __device__ void row2(T* M, int i, double c, T s, int lo, int hi) const {
    i = clampi(i, 0, n - 2);
    const int a = clampi(lo, 0, n), b = clampi(hi, 0, n);
    T* r0 = M + (size_t)i * n;
    for (int k = first(a); k < b; k += nt) rot(c, s, r0[k], r0[n + k]);
  }
  // colsk(M, j, rmat_adj(c, s), lo, hi)
  __device__ void col2(T* M, int j, double c, T s, int lo, int hi) const {
    j = clampi(j, 0, n - 2);
    const int a = clampi(lo, 0, n), b = clampi(hi, 0, n);
    for (int r = first(a); r < b; r += nt) rot(c, cj(s), M[(size_t)r * n + j],
                                              M[(size_t)r * n + j + 1]);
  }
  // Z[l] <- Z[l] G(base, base+1, c, s)': a row update of ZT[l]
  __device__ void zup(int l, int base, double c, T s) const {
    if (ZT) row2(ZT + (size_t)l * n * n, base, c, cj(s), 0, n);
  }
  // M <- M prod_k G(k, k+1, gc[k], gs[k])' for k = klo..khi ascending, on
  // the rows r <= k + 1 of each step k (colsk's hi=k+2): one chain a row
  __device__ void right_up(T* M, int klo, int khi) const {
    for (int r = tid; r < n; r += nt) {
      const int k0 = max(klo, r - 1);
      if (k0 <= khi) chain_up(M + (size_t)r * n, 1, k0, khi);
    }
  }
  // Z[l] <- Z[l] prod G(k, k+1)' ascending (klo..khi) on ZT's columns
  __device__ void z_up(int l, int klo, int khi) const {
    if (!ZT || klo > khi) return;
    T* Zl = ZT + (size_t)l * n * n;
    for (int r = tid; r < n; r += nt) chain_up(Zl + r, n, klo, khi);
  }
  // Z[l] <- Z[l] prod G(k-1, k)' for k = khi..klo descending
  __device__ void z_down(int l, int klo, int khi) const {
    if (!ZT || klo > khi) return;
    T* Zl = ZT + (size_t)l * n * n;
    for (int r = tid; r < n; r += nt)
      Zl[(size_t)(klo - 1) * n + r] = chain<true>(Zl + r, n, khi, klo, gc, gs);
  }
  // rmat_adj(gc[k], gs[k]) on the entries (e[k], e[k+1]) for k = klo..khi;
  // e[k] is final after step k, e[k+1] carried
  __device__ void chain_up(T* e, size_t stride, int klo, int khi) const {
    T a = e[(size_t)klo * stride];
    for (int k0 = klo; k0 <= khi; k0 += psd::kBatch) {
      const int m = khi - k0 + 1 < psd::kBatch ? khi - k0 + 1 : psd::kBatch;
      T b[psd::kBatch];
#pragma unroll
      for (int t = 0; t < psd::kBatch; ++t)
        if (t < m) b[t] = e[(size_t)(k0 + t + 1) * stride];
#pragma unroll
      for (int t = 0; t < psd::kBatch; ++t) {
        if (t < m) {
          const int k = k0 + t;
          rot(gc[k], cj(gs[k]), a, b[t]);
          e[(size_t)k * stride] = a;
          a = b[t];
        }
      }
    }
    e[(size_t)(khi + 1) * stride] = a;
  }
  __device__ void put(int k, double c, T s) const {
    if (tid == 0) {
      gc[k] = c;
      gs[k] = s;
    }
  }
};

// The rotations' storage: gs (n of T) first, so that a double2 lies on a
// 16-byte boundary at any n, then gc (n doubles).
template <class T>
__device__ Act<T> make_act(T* H, T* ZT, const int* S, double* ws, int p, int n, int in_smem) {
  extern __shared__ double2 smem[];
  T* gs = in_smem ? reinterpret_cast<T*>(smem) : reinterpret_cast<T*>(ws);
  return Act<T>{H, ZT, S, reinterpret_cast<double*>(gs + n), gs, p, n, (int)threadIdx.x,
                (int)blockDim.x};
}

// ---- CZSHIFT (czshift_core_plain) ----
template <class T>
__global__ void __launch_bounds__(kMaxThreads)
    czshift_kernel(T* H, T* ZT, const int* __restrict__ S, double* ws, int* zflag, int p,
                   int n, int jlo, int ilast, double ulp, double smlnum, int in_smem) {
  const Act<T> A = make_act(H, ZT, S, ws, p, n, in_smem);
  const T zero = T();
  T* H0 = A.fac(0);
  // stage A: triangularize the Hessenberg factor on [jlo, ilast]
  for (int k = jlo; k < ilast; ++k) {
    __syncthreads();
    double c;
    T s, r;
    A.gen_at(H0, k, k, k + 1, k, c, s, r);
    A.set_r(H0, k, k, r);
    A.set_r(H0, k + 1, k, zero);
    A.put(k, c, s);
    A.row2(H0, k, c, s, k + 1, n);
  }
  __syncthreads();
  A.z_up(0, jlo, ilast - 1);
  // stage B: backwards through the triangular factors; an incoming s of
  // exactly zero skips the step, a negligible entry gives the identity
  for (int l = p - 1; l >= 1; --l) {
    T* Hl = A.fac(l);
    const bool dir = S[l] != 0;
    for (int k = jlo; k < ilast; ++k) {
      const double c0 = A.gc[k];
      const T s0 = A.gs[k];
      if (is_zero(s0)) continue;
      if (dir)
        A.col2(Hl, k, c0, s0, 0, k + 2);
      else
        A.row2(Hl, k, c0, s0, k, n);
      __syncthreads();
      const T d0 = A.at(Hl, k, k), d1 = A.at(Hl, k + 1, k + 1), g = A.at(Hl, k + 1, k);
      __syncthreads();
      const double t = ulp * (mag(d0) + mag(d1));
      const bool negl = mag(g) <= (smlnum > t ? smlnum : t);
      double c;
      T s, r;
      gen(dir ? d0 : d1, g, c, s, r);
      if (dir) {
        if (!negl) A.set_r(Hl, k, k, r);
        A.set_r(Hl, k + 1, k, zero);
        if (!negl) A.row2(Hl, k, c, s, k + 1, n);
      } else {
        if (!negl) A.set_c(Hl, k + 1, k + 1, r);
        A.set_c(Hl, k + 1, k, zero);
        if (!negl) A.col2(Hl, k, c, ng(s), 0, k + 1);
      }
      A.put(k, negl ? 1.0 : c, negl ? zero : (dir ? s : ng(s)));
      __syncthreads();
    }
    __syncthreads();
    A.z_up(l, jlo, ilast - 1);
  }
  // stage C: the final chain on the right side of H[0] (rows <= k+1)
  __syncthreads();
  A.right_up(H0, jlo, ilast - 1);
  if (A.tid == 0) {
    int any = 0;
    for (int k = jlo; k < ilast; ++k) any |= is_zero(A.gs[k]);
    *zflag = any;
  }
}

// ---- DEFLATE_POS (pos_core_plain): a zero on a direct factor's diagonal ----
template <class T>
__global__ void __launch_bounds__(kMaxThreads)
    pos_kernel(T* H, T* ZT, const int* __restrict__ S, double* ws, int p, int n, int jlo,
               int ldef, int jdef, int ilast, int in_smem) {
  const Act<T> A = make_act(H, ZT, S, ws, p, n, in_smem);
  const T zero = T();
  T* H0 = A.fac(0);
  if (A.tid == 0) A.at(A.fac(ldef), jdef, jdef) = zero;

  // first unshifted half-sweep (downwards from jlo); G[k], k < jdef
  for (int k = jlo; k < jdef; ++k) {
    __syncthreads();
    double c;
    T s, r;
    A.gen_at(H0, k, k, k + 1, k, c, s, r);
    A.set_r(H0, k, k, r);
    A.set_r(H0, k + 1, k, zero);
    A.put(k, c, s);
    A.row2(H0, k, c, s, k + 1, n);
  }
  __syncthreads();
  A.z_up(0, jlo, jdef - 1);
  for (int l = p - 1; l >= 1; --l) {
    const int ntra = l < ldef ? jdef - 2 : jdef - 1;
    T* Hl = A.fac(l);
    for (int k = jlo; k <= ntra; ++k) {
      const double c0 = A.gc[k];
      const T s0 = A.gs[k];
      double c;
      T s, r;
      if (S[l]) {
        A.col2(Hl, k, c0, s0, 0, k + 2);
        __syncthreads();
        A.gen_at(Hl, k, k, k + 1, k, c, s, r);
        A.set_r(Hl, k, k, r);
        A.set_r(Hl, k + 1, k, zero);
        A.row2(Hl, k, c, s, k + 1, n);
        A.put(k, c, s);
      } else {
        A.row2(Hl, k, c0, s0, k, n);
        __syncthreads();
        A.gen_at(Hl, k + 1, k + 1, k + 1, k, c, s, r);
        A.set_c(Hl, k + 1, k + 1, r);
        A.set_c(Hl, k + 1, k, zero);
        A.col2(Hl, k, c, ng(s), 0, k + 1);
        A.put(k, c, ng(s));
      }
      __syncthreads();
    }
    __syncthreads();
    A.z_up(l, jlo, ntra);
  }
  A.right_up(H0, jlo, jdef - 2);

  // second unshifted half-sweep (upwards from ilast); G2[j], j > jdef
  for (int j = ilast; j > jdef; --j) {
    __syncthreads();
    double c;
    T s, r;
    A.gen_at(H0, j, j, j, j - 1, c, s, r);
    A.set_c(H0, j, j, r);
    A.set_c(H0, j, j - 1, zero);
    A.col2(H0, j - 1, c, ng(s), 0, j);
    A.put(j, c, ng(s));
  }
  __syncthreads();
  A.z_down(1 % p, jdef + 1, ilast);
  for (int l = 1; l < p; ++l) {
    const int ntra = l > ldef ? jdef + 2 : jdef + 1;
    T* Hl = A.fac(l);
    for (int j = ilast; j >= ntra; --j) {
      const double c0 = A.gc[j];
      const T s0 = A.gs[j];
      double c;
      T s, r;
      if (!S[l]) {
        A.col2(Hl, j - 1, c0, s0, 0, j + 1);
        __syncthreads();
        A.gen_at(Hl, j - 1, j - 1, j, j - 1, c, s, r);
        A.set_r(Hl, j - 1, j - 1, r);
        A.set_r(Hl, j, j - 1, zero);
        A.row2(Hl, j - 1, c, s, j, n);
        A.put(j, c, s);
      } else {
        A.row2(Hl, j - 1, c0, s0, j - 1, n);
        __syncthreads();
        A.gen_at(Hl, j, j, j, j - 1, c, s, r);
        A.set_c(Hl, j, j, r);
        A.set_c(Hl, j, j - 1, zero);
        A.col2(Hl, j - 1, c, ng(s), 0, j);
        A.put(j, c, ng(s));
      }
      __syncthreads();
    }
    __syncthreads();
    A.z_down((l + 1) % p, ntra, ilast);
  }
  // rows j-1, j of H[0] from column j-1 on, j = ilast..jdef+2: one chain a column
  for (int k = A.first(jdef + 1); k < n; k += A.nt) {
    const int jhi = min(ilast, k + 1);
    if (jhi >= jdef + 2)
      H0[(size_t)(jdef + 1) * n + k] = chain<false>(H0 + k, n, jhi, jdef + 2, A.gc, A.gs);
  }
}

// ---- DEFLATE_NEG (neg_core_plain): a zero on an inverted factor's diagonal ----
// The ring-walk steps of the plain version's _hess_*, _pos_* and _neg_*;
// each takes the incoming (j, c, s) and returns the next.
enum Kind { kHess, kPos, kNeg };

template <class T>
__device__ __forceinline__ Kind kind_of(const Act<T> A, int l) {
  return l == 0 ? kHess : A.S[l] ? kPos : kNeg;
}

template <class T>
__device__ __forceinline__ void step_down(const Act<T> A, int l, Kind kind, int& j, double& c,
                                          T& s) {
  T* Hl = A.fac(l);
  const T zero = T();
  double cn;
  T sn, r;
  if (kind == kHess) {  // _hess_dn
    A.row2(Hl, j, c, s, j - 1, A.n);
    __syncthreads();
    A.gen_at(Hl, j + 1, j, j + 1, j - 1, cn, sn, r);
    A.set_c(Hl, j + 1, j, r);
    A.set_c(Hl, j + 1, j - 1, zero);
    A.col2(Hl, j - 1, cn, ng(sn), 0, j + 1);
    j -= 1;
    sn = ng(sn);
  } else if (kind == kPos) {  // _pos_dn
    A.row2(Hl, j, c, s, j, A.n);
    __syncthreads();
    A.gen_at(Hl, j + 1, j + 1, j + 1, j, cn, sn, r);
    A.set_c(Hl, j + 1, j + 1, r);
    A.set_c(Hl, j + 1, j, zero);
    A.col2(Hl, j, cn, ng(sn), 0, j + 1);
    sn = ng(sn);
  } else {  // _neg_dn
    A.col2(Hl, j, c, s, 0, j + 2);
    __syncthreads();
    A.gen_at(Hl, j, j, j + 1, j, cn, sn, r);
    A.set_r(Hl, j, j, r);
    A.set_r(Hl, j + 1, j, zero);
    A.row2(Hl, j, cn, sn, j + 1, A.n);
  }
  c = cn;
  s = sn;
}

template <class T>
__device__ __forceinline__ void step_up(const Act<T> A, int l, Kind kind, int& j, double& c,
                                        T& s) {
  T* Hl = A.fac(l);
  const T zero = T();
  double cn;
  T sn, r;
  if (kind == kHess) {  // _hess_up
    A.col2(Hl, j - 1, c, s, 0, j + 2);
    __syncthreads();
    A.gen_at(Hl, j, j - 1, j + 1, j - 1, cn, sn, r);
    A.set_r(Hl, j, j - 1, r);
    A.set_r(Hl, j + 1, j - 1, zero);
    A.row2(Hl, j, cn, sn, j, A.n);
    j += 1;
  } else if (kind == kPos) {  // _pos_up
    A.col2(Hl, j - 1, c, s, 0, j + 1);
    __syncthreads();
    A.gen_at(Hl, j - 1, j - 1, j, j - 1, cn, sn, r);
    A.set_r(Hl, j - 1, j - 1, r);
    A.set_r(Hl, j, j - 1, zero);
    A.row2(Hl, j - 1, cn, sn, j, A.n);
  } else {  // _neg_up
    A.row2(Hl, j - 1, c, s, j - 1, A.n);
    __syncthreads();
    A.gen_at(Hl, j, j, j, j - 1, cn, sn, r);
    A.set_c(Hl, j, j, r);
    A.set_c(Hl, j, j - 1, zero);
    A.col2(Hl, j - 1, cn, ng(sn), 0, j);
    sn = ng(sn);
  }
  c = cn;
  s = sn;
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads)
    neg_kernel(T* H, T* ZT, const int* __restrict__ S, int p, int n, int jlo, int ldef,
               int jdef, int ilast, int down) {
  const Act<T> A = make_act(H, ZT, S, nullptr, p, n, 1);  // no rotations kept
  const T zero = T();
  T* H0 = A.fac(0);
  T* Hd = A.fac(ldef);
  if (A.tid == 0) A.at(Hd, jdef, jdef) = zero;
  double c;
  T s, r;
  if (down) {
    for (int j1 = jdef; j1 < ilast; ++j1) {
      int j = j1;
      __syncthreads();
      A.gen_at(Hd, j, j + 1, j + 1, j + 1, c, s, r);
      A.set_r(Hd, j, j + 1, r);
      A.set_r(Hd, j + 1, j + 1, zero);
      A.row2(Hd, j, c, s, j + 2, n);
      int ln = (ldef + 1) % p;
      A.zup(ln, j, c, s);
      for (int t = 0; t < p - 1; ++t) {
        step_down(A, ln, kind_of(A, ln), j, c, s);
        ln = (ln + 1) % p;
        A.zup(ln, j, c, s);
      }
      A.col2(Hd, j, c, s, 0, j + 1);
    }
    // deflate the last element of the Hessenberg factor
    int j = ilast;
    __syncthreads();
    A.gen_at(H0, j, j, j, j - 1, c, s, r);
    A.set_c(H0, j, j, r);
    A.set_c(H0, j, j - 1, zero);
    A.col2(H0, j - 1, c, ng(s), 0, j);
    s = ng(s);
    A.zup(1 % p, j - 1, c, s);
    // factors 1..ldef-1 with the step of the opposite kind (j stays)
    for (int l = 1; l < ldef; ++l) {
      step_up(A, l, S[l] ? kNeg : kPos, j, c, s);
      A.zup((l + 1) % p, j - 1, c, s);
    }
    A.col2(Hd, j - 1, c, s, 0, j + 1);
  } else {
    for (int j1 = jdef; j1 > jlo; --j1) {
      int j = j1;
      __syncthreads();
      A.gen_at(Hd, j - 1, j, j - 1, j - 1, c, s, r);
      A.set_c(Hd, j - 1, j, r);
      A.set_c(Hd, j - 1, j - 1, zero);
      A.col2(Hd, j - 1, c, ng(s), 0, j - 1);
      s = ng(s);
      A.zup(ldef, j - 1, c, s);
      int ln = (ldef - 1 + p) % p;
      for (int t = 0; t < p - 1; ++t) {
        step_up(A, ln, kind_of(A, ln), j, c, s);
        A.zup(ln, j - 1, c, s);
        ln = (ln - 1 + p) % p;
      }
      A.row2(Hd, j - 1, c, s, j, n);
    }
    // deflate the first element of the Hessenberg factor
    int j = jlo;
    __syncthreads();
    A.gen_at(H0, j, j, j + 1, j, c, s, r);
    A.set_r(H0, j, j, r);
    A.set_r(H0, j + 1, j, zero);
    A.row2(H0, j, c, s, j + 1, n);
    A.zup(0, j, c, s);
    // factors p-1..ldef+1 with the step of the opposite kind (j stays)
    for (int l = p - 1; l > ldef; --l) {
      step_down(A, l, S[l] ? kNeg : kPos, j, c, s);
      A.zup(l, j, c, s);
    }
    A.row2(Hd, j, c, s, j + 1, n);
  }
}

// one thread a row (a column), up to kMaxThreads
__host__ __device__ constexpr int threads_for(int n) {
  return (n + 31) / 32 * 32 < kMaxThreads ? (n + 31) / 32 * 32 : kMaxThreads;
}

__host__ __device__ constexpr size_t rotation_bytes(int n, size_t tsize) {
  return (size_t)n * (sizeof(double) + tsize);
}

// Shared memory for the rotations of an n-chain, 0 when they go to ws.
template <class T, class K>
cudaError_t rotation_smem(K kernel, int n, size_t& smem) {
  const size_t bytes = rotation_bytes(n, sizeof(T));
  bool fits = false;
  const cudaError_t e = psd::fit_smem(kernel, bytes, fits);
  smem = fits ? bytes : 0;
  return e;
}

template <class T>
int czshift(T* H, T* ZT, const int* S, double* ws, int* zflag, int p, int n, int jlo,
            int ilast, double ulp, double smlnum, int* nlaunch, void* stream) {
  *nlaunch = 0;
  auto kernel = czshift_kernel<T>;
  size_t smem = 0;
  cudaError_t e = rotation_smem<T>(kernel, n, smem);
  if (e) return (int)e;
  kernel<<<1, threads_for(n), smem, (cudaStream_t)stream>>>(
      H, ZT, S, ws, zflag, p, n, jlo, ilast, ulp, smlnum, smem > 0);
  e = cudaGetLastError();
  if (e) return (int)e;
  *nlaunch = 1;
  return 0;
}

template <class T>
int pos(T* H, T* ZT, const int* S, double* ws, int p, int n, int jlo, int ldef, int jdef,
        int ilast, int* nlaunch, void* stream) {
  *nlaunch = 0;
  auto kernel = pos_kernel<T>;
  size_t smem = 0;
  cudaError_t e = rotation_smem<T>(kernel, n, smem);
  if (e) return (int)e;
  kernel<<<1, threads_for(n), smem, (cudaStream_t)stream>>>(H, ZT, S, ws, p, n, jlo, ldef,
                                                            jdef, ilast, smem > 0);
  e = cudaGetLastError();
  if (e) return (int)e;
  *nlaunch = 1;
  return 0;
}

template <class T>
int neg(T* H, T* ZT, const int* S, int p, int n, int jlo, int ldef, int jdef, int ilast,
        int down, int* nlaunch, void* stream) {
  *nlaunch = 0;
  auto kernel = neg_kernel<T>;
  kernel<<<1, threads_for(n), 0, (cudaStream_t)stream>>>(H, ZT, S, p, n, jlo, ldef, jdef,
                                                         ilast, down);
  const cudaError_t e = cudaGetLastError();
  if (e) return (int)e;
  *nlaunch = 1;
  return 0;
}

}  // namespace

extern "C" {

// Bytes of scratch the actions take in ws (16-byte aligned): the rotations
// of one chain (n of them), used only when they do not fit the shared
// memory a block may take.
long long psd_deflate_scratch(int n, int cplx) {
  return (long long)rotation_bytes(n, cplx ? sizeof(double2) : sizeof(double));
}

// The controlled zero shift on the window [jlo, ilast], in place, in one
// launch.  H: (p, n, n) periodic Hessenberg-triangular; ZT: (p, n, n) with
// ZT[l] = Z[l]^T, updated (NULL: not accumulated); S: p ints on the device,
// S[0] = 1; ws: psd_deflate_scratch(n, 0) bytes on the device; *zflag (an
// int on the device): 1 when a rotation of the final chain is the identity;
// *nlaunch: the launches enqueued (1).  Returns the first CUDA error code,
// 0 on success.
int psd_deflate_czshift(double* H, double* ZT, const int* S, double* ws, int* zflag, int p,
                        int n, int jlo, int ilast, double ulp, double smlnum, int* nlaunch,
                        void* stream) {
  return czshift<double>(H, ZT, S, ws, zflag, p, n, jlo, ilast, ulp, smlnum, nlaunch, stream);
}

// DEFLATE_POS: the diagonal entry (jdef, jdef) of the direct factor ldef
// is negligible; it is set to zero and deflated, in place, in one launch.
// Arguments as psd_deflate_czshift's.
int psd_deflate_pos(double* H, double* ZT, const int* S, double* ws, int p, int n, int jlo,
                    int ldef, int jdef, int ilast, int* nlaunch, void* stream) {
  return pos<double>(H, ZT, S, ws, p, n, jlo, ldef, jdef, ilast, nlaunch, stream);
}

// DEFLATE_NEG: the same on the inverted factor ldef, the zero chased off
// the bottom (down != 0) or the top of the window [jlo, ilast].  Takes no
// scratch: its rotations are carried one at a time.
int psd_deflate_neg(double* H, double* ZT, const int* S, int p, int n, int jlo, int ldef,
                    int jdef, int ilast, int down, int* nlaunch, void* stream) {
  return neg<double>(H, ZT, S, p, n, jlo, ldef, jdef, ilast, down, nlaunch, stream);
}

// The same three for complex128 stacks (interleaved re, im; ws:
// psd_deflate_scratch(n, 1) bytes).
int psd_deflate_czshift_c128(double2* H, double2* ZT, const int* S, double* ws, int* zflag,
                             int p, int n, int jlo, int ilast, double ulp, double smlnum,
                             int* nlaunch, void* stream) {
  return czshift<double2>(H, ZT, S, ws, zflag, p, n, jlo, ilast, ulp, smlnum, nlaunch,
                          stream);
}

int psd_deflate_pos_c128(double2* H, double2* ZT, const int* S, double* ws, int p, int n,
                         int jlo, int ldef, int jdef, int ilast, int* nlaunch, void* stream) {
  return pos<double2>(H, ZT, S, ws, p, n, jlo, ldef, jdef, ilast, nlaunch, stream);
}

int psd_deflate_neg_c128(double2* H, double2* ZT, const int* S, int p, int n, int jlo,
                         int ldef, int jdef, int ilast, int down, int* nlaunch,
                         void* stream) {
  return neg<double2>(H, ZT, S, p, n, jlo, ldef, jdef, ilast, down, nlaunch, stream);
}

}  // extern "C"
