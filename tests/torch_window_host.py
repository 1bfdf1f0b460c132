"""JAX-free numpy model of kernel A's batched schedule (csrc/sweep.cu).

Kernel A generates the transform log R (p, N, 9) of one double-shift
sweep over the window [m, i] of a ghost-padded (p, N, N) cycle.  Two
schedules of the same arithmetic are modelled here, in float64 numpy with
one rounding per operation (no fused multiply-add):

* ``sweep_log_full``: the reference order on a full working copy of the
  rows m..i+1 (kernel A's design before the look-ahead window): per
  (step, factor) the left transform on rows k..k+2 of every column to the
  right, then the right transform on the band of the next factor.
* ``sweep_log_windowed``: the look-ahead window.  Steps go in batches of
  L.  For a batch k0..k1-1 (k1 = k0 + L, or i for the last one) each factor
  keeps the block of rows k0..k0+L+2 and columns k0-1..k0+L+1 (both cut at
  i+1), and the steps run on those blocks only.  The columns right of the
  block receive no right transform in the batch, so their left transforms
  are applied at the batch's end, all L in step order: each column carries
  its two rows still in flux (k0, k0+1 on entry, k1, k1+1 on exit) and takes
  the rows below them fresh from H, which no transform has touched there.
  The next batch's block is the 3x3 corner of this one (rows k1..k1+2,
  columns k1-1..k1+1), the carried rows of the columns that enter, and
  fresh rows of H for the rest.

Every entry sees the same operations in the same order in both schedules,
so the logs agree bit for bit.  Entries that the window never loads are
NaN, so a read outside the extents shows in the log; the index asserts
state the extents.  Columns right of i+1 are never read by a generation
and are not visited.
"""
import math

import numpy as np

SFMIN = 2.0 * np.finfo(np.float64).tiny / np.finfo(np.float64).eps


def _hyp2(x, z):
    m = max(abs(x), abs(z))
    ms = 1.0 if m == 0.0 else m
    xs, zs = x / ms, z / ms
    return m * math.sqrt(xs * xs + zs * zs)


def _neg_copysign(mag, sgn):
    return -abs(mag) if sgn >= 0.0 else abs(mag)


def gen_reflector(alpha, x1, x2):
    """psd::gen_reflector (csrc/psd_common.cuh): xLARFG on (alpha, x1, x2)
    with the underflow rescue; returns (tau, beta, v1, v2)."""
    a1, a2 = abs(x1), abs(x2)
    m = max(a1, a2)
    ms = 1.0 if m == 0.0 else m
    r1, r2 = a1 / ms, a2 / ms
    rs = math.sqrt(r1 * r1 + r2 * r2)
    xnorm = m * rs
    if xnorm == 0.0:
        return 0.0, alpha, 0.0, 0.0
    b = _neg_copysign(_hyp2(alpha, xnorm), alpha)
    ar, scl = alpha, 1.0
    need = abs(b) < SFMIN
    if need:
        scl = 1.0 / SFMIN
        ar = alpha * scl
        b = _neg_copysign(_hyp2(ar, (m * scl) * rs), ar)
    bs = 1.0 if b == 0.0 else b
    tau = (b - ar) / bs
    d = ar - b
    den = 1.0 if d == 0.0 else d
    beta = b * SFMIN if need else b
    return tau, beta, (x1 * scl) / den, (x2 * scl) / den


def refl_mat3(tau, v1, v2):
    w = (1.0, v1, v2)
    return [(1.0 if r == c else 0.0) - tau * (w[r] * w[c])
            for r in range(3) for c in range(3)]


def gen_factor0(x0, x1, x2, nr3):
    """Factor 0's bulge reflector M3 (9 entries, row-major)."""
    tau, _, w1, w2 = gen_reflector(x0, x1, x2 if nr3 else 0.0)
    return refl_mat3(tau, w1, w2)


def gen_fused(c0, c1, nr3):
    """Factor f >= 1: the 3-reflector of column k (``c0``, rows k..k+2) and,
    when nr3, the 2-reflector of column k+1 (``c1``) after it; returns the
    fused F = M3b diag(1, M2) and betab."""
    tau, _, w1, w2 = gen_reflector(c0[0], c0[1], c0[2] if nr3 else 0.0)
    M3 = refl_mat3(tau, w1, w2)
    M2 = [1.0, 0.0, 0.0, 1.0]
    betab = 0.0
    if nr3:
        y1 = M3[3] * c1[0] + M3[4] * c1[1] + M3[5] * c1[2]
        y2 = M3[6] * c1[0] + M3[7] * c1[1] + M3[8] * c1[2]
        t2, betab, u1, _ = gen_reflector(y1, y2, 0.0)
        M2 = [1.0 - t2 * (1.0 * 1.0), -t2 * (1.0 * u1), -t2 * (u1 * 1.0),
              1.0 - t2 * (u1 * u1)]
    F = []
    for r in range(3):
        F += [M3[r * 3], M3[r * 3 + 1] * M2[0] + M3[r * 3 + 2] * M2[2],
              M3[r * 3 + 1] * M2[1] + M3[r * 3 + 2] * M2[3]]
    return F, betab


def apply_ft(F, x0, x1, x2):
    """F^T on the rows (x0, x1, x2) (scalars or column vectors)."""
    return (F[0] * x0 + F[3] * x1 + F[6] * x2,
            F[1] * x0 + F[4] * x1 + F[7] * x2,
            F[2] * x0 + F[5] * x1 + F[8] * x2)


def apply_f(F, y0, y1, y2):
    """F on the columns (y0, y1, y2) of a row (scalars or row vectors)."""
    return (y0 * F[0] + y1 * F[3] + y2 * F[6],
            y0 * F[1] + y1 * F[4] + y2 * F[7],
            y0 * F[2] + y1 * F[5] + y2 * F[8])


class _Full:
    """Rows and columns in global coordinates on a full copy of H."""

    def __init__(self, H):
        self.A = H.copy()

    def get(self, f, r, c):
        return self.A[f, r, c]

    def rows(self, f, r, c0, c1):
        return self.A[f, r, c0:c1 + 1]

    def put(self, f, r, c0, vals):
        self.A[f, r, c0:c0 + len(vals)] = vals


class _Window:
    """Each factor's block: rows k0..k0+L+2, columns k0-1..k0+L+1, cut at
    i+1.  Reads and writes outside the block fail."""

    def __init__(self, p, L, i):
        self.p, self.L, self.i = p, L, i
        self.W = np.full((p, L + 3, L + 3), np.nan)
        self.k0 = None

    def _ab(self, r, c):
        a, b = r - self.k0, c - (self.k0 - 1)
        assert 0 <= a <= self.L + 2 and r <= self.i + 1, (r, c)
        assert 0 <= b <= self.L + 2 and c <= self.i + 1, (r, c)
        return a, b

    def get(self, f, r, c):
        return self.W[(f, *self._ab(r, c))]

    def rows(self, f, r, c0, c1):
        a, b0 = self._ab(r, c0)
        self._ab(r, c1)
        return self.W[f, a, b0:b0 + c1 - c0 + 1].copy()

    def put(self, f, r, c0, vals):
        a, b0 = self._ab(r, c0)
        self._ab(r, c0 + len(vals) - 1)
        self.W[f, a, b0:b0 + len(vals)] = vals


def _steps(st, R, Fs, k0, k1, m, i, v0, cmax):
    """Steps k0..k1-1 of the reference order on the store ``st``; the left
    transforms reach columns up to ``cmax``.  Fs[f][k - k0] gets F."""
    p = R.shape[0]
    tgt0 = p - 1 if p > 1 else 0
    for k in range(k0, k1):
        nr3 = (i - k + 1) >= 3
        rhi = min(k + 3, i)
        for f in [0] + list(range(p - 1, 0, -1)):
            if f == 0:
                x = v0 if k == m else [st.get(0, k + d, k - 1) for d in range(3)]
                F, betab, cl, tgt = gen_factor0(*x, nr3), 0.0, k, tgt0
            else:
                F, betab = gen_fused([st.get(f, k + d, k) for d in range(3)],
                                     [st.get(f, k + d, k + 1) for d in range(3)], nr3)
                cl, tgt = k + 1, f - 1
            R[f, k] = F
            Fs[f][k - k0] = F
            o = apply_ft(F, *(st.rows(f, k + d, cl, cmax) for d in range(3)))
            if f > 0 and nr3:  # the second reflector's exact image
                o[1][k + 1 - cl] = betab
                o[2][k + 1 - cl] = 0.0
            for d in range(3):
                st.put(f, k + d, cl, o[d])
            for r in range(k, rhi + 1):
                st.put(tgt, r, k, list(apply_f(F, *(st.get(tgt, r, k + d)
                                                      for d in range(3)))))


def sweep_log_full(H, m, i, v0):
    """The log of the reference order on a full working copy, and the
    working copy at the end."""
    p, N, _ = H.shape
    R = np.full((p, N, 9), np.nan)
    Fs = [[None] * (i - m) for _ in range(p)]
    st = _Full(H)
    _steps(st, R, Fs, m, i, m, i, v0, N - 1)
    return R, st.A


def sweep_log_windowed(H, m, i, v0, L):
    """The log of the batched schedule with batch length L; also returns
    the blocks of the last batch (p, L+3, L+3) and its first step k0."""
    assert L >= 1 and 0 <= m < i <= H.shape[1] - 2
    p, N, _ = H.shape
    R = np.full((p, N, 9), np.nan)
    win = _Window(p, L, i)
    carry = np.full((p, 2, N), np.nan)
    k0 = m
    win.k0 = k0
    for f in range(p):  # the first block: column m-1 is never read
        for r in range(k0, min(k0 + L + 2, i + 1) + 1):
            c1 = min(k0 + L + 1, i + 1)
            win.put(f, r, k0, H[f, r, k0:c1 + 1])
    while True:
        k1 = min(k0 + L, i)
        Fs = [[None] * L for _ in range(p)]
        _steps(win, R, Fs, k0, k1, m, i, v0, min(k0 + L + 1, i + 1))
        if k1 == i:
            return R, win.W, k0
        corner = win.W[:, L:L + 3, L:L + 3].copy()  # rows k1.., columns k1-1..
        # the left transforms of the batch on the columns right of the block
        fresh = {}
        for f in range(p):
            for c in range(k0 + L + 2, i + 2):
                x0, x1 = (H[f, k0, c], H[f, k0 + 1, c]) if k0 == m else carry[f, :, c]
                for s in range(L):
                    _, x0, x1 = apply_ft(Fs[f][s], x0, x1, H[f, k0 + s + 2, c])
                fresh[f, c] = (x0, x1)
        k0 = k1
        win.W[:] = np.nan
        win.k0 = k0
        rlast, clast = min(k0 + L + 2, i + 1), min(k0 + L + 1, i + 1)
        for f in range(p):
            win.W[f, 0:3, 0:3] = corner[f]
            for c in range(k0 - 1, clast + 1):
                rtop = k0 + 3 if c <= k0 + 1 else k0 + 2
                if c > k0 + 1:
                    win.put(f, k0, c, [fresh[f, c][0]])
                    win.put(f, k0 + 1, c, [fresh[f, c][1]])
                for r in range(rtop, rlast + 1):
                    win.put(f, r, c, [H[f, r, c]])
            for c in range(clast + 1, i + 2):
                carry[f, :, c] = fresh[f, c]
