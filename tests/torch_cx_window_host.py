"""JAX-free numpy model of the complex kernel A's batched schedule
(csrc/sweep_cx.cu::qz_generate_kernel).

The complex kernel A generates the rotation log (p, n, 16) of one
single-shift QZ sweep over the window [m, i] of a (p, n, n) complex128
cycle with signature S.  Two schedules of the same arithmetic are modelled
here, in float64 with one rounding per operation (no fused multiply-add;
complex products as re*re - im*im, re*im + im*re, the order of
csrc/psd_common.cuh):

* ``qz_log_full``: the reference order on a full working copy (the
  kernel's design before the look-ahead window): per (step, factor) the
  left rotation on rows k, k+1 of every column to the right, the right
  rotation on the factor's band and the generation, in the order of
  ``qz_sweep_plain`` (ops/sweep_cx.py).
* ``qz_log_windowed``: the look-ahead window.  Steps go in batches of L.
  For a batch k0..k1-1 (k1 = k0 + L, or i for the last one) each factor
  keeps the block of rows k0..k1+1 (cut at n-1) and columns k0-1..k1, and
  the steps run on those blocks only.  The columns right of the block
  receive no right rotation in the batch, only left ones, so these are
  applied at the batch's end, all L in step order: each column carries its
  one row still in flux (k0 on entry, k1 on exit) and takes the row below
  fresh from H, which no rotation has touched there.  The next batch's
  block is the 2x2 corner of this one (rows k1, k1+1, columns k1-1, k1),
  the carried row of the columns that enter, and fresh rows of H for the
  rest.

Every entry sees the same operations in the same order in both schedules,
so the logs agree bit for bit.  Entries that the window never loads are
NaN, so a read outside the extents shows in the log; the index asserts
state the extents.  Columns right of i are never read by a generation and
are not visited.
"""
import math

import numpy as np

LOG = 16
NAN = complex(math.nan, math.nan)


def cpx(re, im):
    """A complex array (or scalar) from its parts, with no arithmetic."""
    re, im = np.asarray(re, dtype=np.float64), np.asarray(im, dtype=np.float64)
    z = np.empty(np.broadcast(re, im).shape, dtype=np.complex128)
    z.real, z.imag = re, im
    return z if z.shape else complex(z)


def cmul(a, b):
    return cpx(np.real(a) * np.real(b) - np.imag(a) * np.imag(b),
               np.real(a) * np.imag(b) + np.imag(a) * np.real(b))


def cadd(a, b):
    return cpx(np.real(a) + np.real(b), np.imag(a) + np.imag(b))


def givens_cx(f, g):
    """psd::givens_cx (csrc/psd_common.cuh), operation for operation:
    (c, s, r) with [c s; -conj(s) c] (f, g)^T = (r, 0)^T."""
    fx, fy, gx, gy = f.real, f.imag, g.real, g.imag
    scale = max(max(abs(fx), abs(fy)), max(abs(gx), abs(gy)))
    sc = 1.0 if scale == 0.0 else scale
    fsr, fsi, gsr, gsi = fx / sc, fy / sc, gx / sc, gy / sc
    f2 = fsr * fsr + fsi * fsi
    g2 = gsr * gsr + gsi * gsi
    if gx == 0.0 and gy == 0.0:
        return 1.0, 0j, f
    if fx == 0.0 and fy == 0.0:
        ag = math.sqrt(g2)
        agsafe = 1.0 if ag == 0.0 else ag
        return 0.0, complex(gsr / agsafe, -(gsi / agsafe)), complex(ag * sc, 0.0)
    af = math.sqrt(f2)
    d = math.sqrt(f2 + g2)
    dsafe = 1.0 if d == 0.0 else d
    afsafe = 1.0 if af == 0.0 else af
    fgr, fgi = fsr / afsafe, fsi / afsafe
    return (af / dsafe,
            complex((fgr * gsr + fgi * gsi) / dsafe, (fgi * gsr - fgr * gsi) / dsafe),
            complex(fgr * d * sc, fgi * d * sc))


def lmat(c, s):
    """put_lmat: [[c, s], [-conj(s), c]], row-major."""
    return [complex(c, 0.0), s, complex(-s.real, s.imag), complex(c, 0.0)]


def rmat_adj(c, s):
    """put_rmat_adj: [[c, -s], [conj(s), c]], row-major."""
    return [complex(c, 0.0), complex(-s.real, -s.imag), complex(s.real, -s.imag),
            complex(c, 0.0)]


def left2(M, x0, x1):
    """(x0, x1) <- M (x0, x1)^T (scalars or row segments)."""
    return (cadd(cmul(M[0], x0), cmul(M[1], x1)), cadd(cmul(M[2], x0), cmul(M[3], x1)))


def right2(M, x0, x1):
    """(x0, x1) <- (x0, x1) M."""
    return (cadd(cmul(x0, M[0]), cmul(x1, M[2])), cadd(cmul(x0, M[1]), cmul(x1, M[3])))


class _Full:
    """Rows and columns in global coordinates on a full copy of H."""

    def __init__(self, H):
        self.A = H.copy()

    def get(self, f, r, c):
        return complex(self.A[f, r, c])

    def put(self, f, r, c, v):
        self.A[f, r, c] = v

    def row(self, f, r, c0, c1):
        return self.A[f, r, c0:c1 + 1].copy()

    def put_row(self, f, r, c0, vals):
        self.A[f, r, c0:c0 + len(vals)] = vals


class _Window:
    """Each factor's block: rows k0..k0+L+1 (cut at n-1) and columns
    k0-1..k0+L (cut at i).  Reads and writes outside the block fail."""

    def __init__(self, p, L, n, i):
        self.L, self.n, self.i = L, n, i
        self.W = np.full((p, L + 2, L + 2), NAN)
        self.k0 = None

    def _ab(self, r, c):
        a, b = r - self.k0, c - (self.k0 - 1)
        assert 0 <= a <= self.L + 1 and r <= self.n - 1, (r, c)
        assert 0 <= b <= self.L + 1 and c <= self.i, (r, c)
        return a, b

    def get(self, f, r, c):
        return complex(self.W[(f, *self._ab(r, c))])

    def put(self, f, r, c, v):
        self.W[(f, *self._ab(r, c))] = v

    def row(self, f, r, c0, c1):
        a, b0 = self._ab(r, c0)
        self._ab(r, c1)
        return self.W[f, a, b0:b0 + c1 - c0 + 1].copy()

    def put_row(self, f, r, c0, vals):
        a, b0 = self._ab(r, c0)
        self._ab(r, c0 + len(vals) - 1)
        self.W[f, a, b0:b0 + len(vals)] = vals


def _rows_left(st, f, k, c0, cmax, c, s):
    if c0 > cmax:
        return
    y0, y1 = left2(lmat(c, s), st.row(f, k, c0, cmax), st.row(f, k + 1, c0, cmax))
    st.put_row(f, k, c0, y0)
    st.put_row(f, k + 1, c0, y1)


def _band_right(st, f, k, r0, r1, M):
    for r in range(r0, r1 + 1):
        y0, y1 = right2(M, st.get(f, r, k), st.get(f, r, k + 1))
        st.put(f, r, k, y0)
        st.put(f, r, k + 1, y1)


def _steps(st, log, rots, k0, k1, m, n, cs, S, cmax):
    """Steps k0..k1-1 of the reference order on the store ``st``; the left
    rotations reach columns up to ``cmax``.  rots[f][k - k0] gets the (c, s)
    of factor f's left rotation at step k."""
    p = len(S)
    for k in range(k0, k1):
        if k == m:
            c, s, r = cs[0], cs[1], 0j
        else:
            c, s, r = givens_cx(st.get(0, k, k - 1), st.get(0, k + 1, k - 1))
            st.put(0, k, k - 1, r)
            st.put(0, k + 1, k - 1, 0j)
        log[0, k, 0:4] = lmat(c, s)
        log[0, k, 8:12] = rmat_adj(c, s)
        log[0, k, 12] = r
        rots[0][k - k0] = (c, s)
        _rows_left(st, 0, k, k, cmax, c, s)
        for l in range(p - 1, 0, -1):
            if S[l]:
                R = rmat_adj(c, s)
                log[l, k, 4:8] = R
                _band_right(st, l, k, k, k + 1, R)
                c, s, r = givens_cx(st.get(l, k, k), st.get(l, k + 1, k))
                st.put(l, k, k, r)
                st.put(l, k + 1, k, 0j)
                log[l, k, 0:4] = lmat(c, s)
                log[l, k, 8:12] = rmat_adj(c, s)
                rots[l][k - k0] = (c, s)
                _rows_left(st, l, k, k + 1, cmax, c, s)
            else:
                _rows_left(st, l, k, k, cmax, c, s)
                log[l, k, 0:4] = lmat(c, s)
                rots[l][k - k0] = (c, s)
                cn, sn, r = givens_cx(st.get(l, k + 1, k + 1), st.get(l, k + 1, k))
                st.put(l, k + 1, k, 0j)
                st.put(l, k + 1, k + 1, r)
                Rm = lmat(cn, sn)
                log[l, k, 4:8] = Rm
                _band_right(st, l, k, k, k, Rm)
                c, s = cn, complex(-sn.real, -sn.imag)
                log[l, k, 8:12] = rmat_adj(c, s)
        R = rmat_adj(c, s)
        log[0, k, 4:8] = R
        _band_right(st, 0, k, k, min(k + 2, n - 1), R)


def _check_args(H, m, i, cs, S):
    p, n, _ = H.shape
    assert len(S) == p and S[0] and 0 <= m < i <= n - 1
    return p, n, (float(cs[0].real), complex(cs[1]))


def qz_log_full(H, m, i, cs, S):
    """The log of the reference order on a full working copy, and the
    working copy at the end.  ``cs``: (c + 0j, s)."""
    p, n, cs = _check_args(H, m, i, cs, S)
    log = np.full((p, n, LOG), NAN)
    rots = [[None] * (i - m) for _ in range(p)]
    st = _Full(H)
    _steps(st, log, rots, m, i, m, n, cs, S, n - 1)
    return log, st.A


def qz_log_windowed(H, m, i, cs, S, L):
    """The log of the batched schedule with batch length L; also returns
    the blocks of the last batch (p, L+2, L+2) and its first step k0."""
    p, n, cs = _check_args(H, m, i, cs, S)
    assert L >= 1
    log = np.full((p, n, LOG), NAN)
    win = _Window(p, L, n, i)
    carry = np.full((p, n), NAN)
    k0 = m
    win.k0 = k0
    k1 = min(k0 + L, i)
    for f in range(p):  # the first block: column m-1 is never read
        for r in range(k0, min(k1 + 1, n - 1) + 1):
            win.put_row(f, r, k0, H[f, r, k0:k1 + 1])
    while True:
        rots = [[None] * L for _ in range(p)]
        _steps(win, log, rots, k0, k1, m, n, cs, S, k1)
        if k1 == i:
            return log, win.W, k0
        corner = win.W[:, L:L + 2, L:L + 2].copy()  # rows k1, k1+1; columns k1-1, k1
        # the batch's left rotations on the columns right of the block: only
        # the second row of each rotation is still needed (the first is final)
        fresh = {}
        for f in range(p):
            for c in range(k1 + 1, i + 1):
                x0 = complex(H[f, k0, c]) if k0 == m else complex(carry[f, c])
                for s in range(L):
                    M = lmat(*rots[f][s])
                    x0 = cadd(cmul(M[2], x0), cmul(M[3], complex(H[f, k0 + s + 1, c])))
                fresh[f, c] = x0
        k0, k1 = k1, min(k1 + L, i)
        win.W[:] = NAN
        win.k0 = k0
        rlast = min(k1 + 1, n - 1)
        for f in range(p):
            win.W[f, 0:2, 0:2] = corner[f]
            for c in range(k0 + 1, k1 + 1):
                win.put(f, k0, c, fresh[f, c])
                win.put(f, k0 + 1, c, H[f, k0 + 1, c])
            for r in range(k0 + 2, rlast + 1):
                win.put_row(f, r, k0 - 1, H[f, r, k0 - 1:k1 + 1])
            for c in range(k1 + 1, i + 1):
                carry[f, c] = fresh[f, c]
