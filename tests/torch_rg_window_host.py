"""JAX-free numpy model of kernel rg A's batched schedule
(csrc/sweep_rg.cu::rg_generate_kernel).

Kernel rg A generates the rotation log (p, n, 28) of the chase steps
j = m..i-2 of one double-shift sweep of the real generalized periodic QZ
core, on a real (p, n, n) cycle H (the state the sweep's opening leaves)
with signature S.  Two schedules of the same arithmetic are modelled here,
in float64 with one rounding per operation (no fused multiply-add, the
order of csrc/psd_common.cuh::givens_r and of the kernel's rotations):

* ``rg_log_full``: the reference order on a full working copy (the
  kernel's design before the look-ahead window): per step factor 0's two
  generations and its left rotations on rows j..j+2, then factors p-1..1
  (band right rotations, generations and left rotations in the order of
  ``rg_chase_plain``, ops/sweep_rg.py), then the ring close on factor 0.
* ``rg_log_windowed``: the look-ahead window.  Steps go in batches of L.
  For a batch j0..j1-1 (j1 = j0 + L, or i-1 for the last one) each factor
  keeps the block of rows j0..j1+2 (cut at n-1) and columns j0-1..j1+1
  (which is at most i), and the steps run on those blocks only.  The
  columns right of the block receive no right rotation in the batch, only
  left ones (two a step: rows j+1, j+2, then rows j, j+1), so these are
  applied at the batch's end, all 2L in step order: each column carries
  its two rows still in flux (j0, j0+1 on entry, j1, j1+1 on exit) and
  takes the row below fresh from H, which no rotation has touched there.
  The next batch's block is the 3x3 corner of this one (rows j1..j1+2,
  columns j1-1..j1+1), the carried rows of the columns that enter, and
  fresh rows of H for the rest.

Every entry sees the same operations in the same order in both schedules,
so the logs agree bit for bit.  Entries that the window never loads are
NaN, so a read outside the extents shows in the log; the index asserts
state the extents.  Columns right of i are never read by a generation and
are not visited.
"""
import math

import numpy as np

LOG = 28


def givens_r(f, g):
    """psd::givens_r (csrc/psd_common.cuh), operation for operation:
    (c, s, r) with [c s; -s c] (f, g)^T = (r, 0)^T."""
    f, g = float(f), float(g)
    if g == 0.0:
        return 1.0, 0.0, f
    if f == 0.0:
        return 0.0, (1.0 if g >= 0.0 else -1.0), abs(g)
    af, ag = abs(f), abs(g)
    sc = max(af, ag)
    fs, gs = f / sc, g / sc
    d = sc * math.sqrt(fs * fs + gs * gs)
    r = d if f >= 0.0 else -d
    return af / d, g / r, r


def fuse_left(c1, s1, c2, s2):
    """put_fuse_left: E1(c1, s1) E2(c2, s2), row-major."""
    return [c1, s1 * c2, s1 * s2, -s1, c1 * c2, c1 * s2, 0.0, -s2, c2]


def fuse_right(c1, s1, c2, s2):
    """put_fuse_right: R2e(c2, s2) R1e(c1, s1), row-major."""
    return [c1, -s1, 0.0, c2 * s1, c2 * c1, -s2, s2 * s1, s2 * c1, c2]


class _Full:
    """Rows and columns in global coordinates on a full copy of H."""

    def __init__(self, H):
        self.A = H.copy()

    def get(self, f, r, c):
        return float(self.A[f, r, c])

    def put(self, f, r, c, v):
        self.A[f, r, c] = v

    def row(self, f, r, c0, c1):
        return self.A[f, r, c0:c1 + 1].copy()

    def put_row(self, f, r, c0, vals):
        self.A[f, r, c0:c0 + len(vals)] = vals


class _Window:
    """Each factor's block: rows j0..j0+L+2 (cut at n-1) and columns
    j0-1..j0+L+1 (cut at i).  Reads and writes outside the block fail."""

    def __init__(self, p, L, n, i):
        self.L, self.n, self.i = L, n, i
        self.W = np.full((p, L + 3, L + 3), np.nan)
        self.j0 = None

    def _ab(self, r, c):
        a, b = r - self.j0, c - (self.j0 - 1)
        assert 0 <= a <= self.L + 2 and r <= self.n - 1, (r, c)
        assert 0 <= b <= self.L + 2 and c <= self.i, (r, c)
        return a, b

    def get(self, f, r, c):
        return float(self.W[(f, *self._ab(r, c))])

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
    """rows k, k+1, columns c0..cmax <- lmat(c, s) rows."""
    if c0 > cmax:
        return
    x0, x1 = st.row(f, k, c0, cmax), st.row(f, k + 1, c0, cmax)
    st.put_row(f, k, c0, c * x0 + s * x1)
    st.put_row(f, k + 1, c0, -s * x0 + c * x1)


def _band_right(st, f, k, r0, r1, c, s):
    """rows r0..r1, columns k, k+1 <- (...) rmat_adj(c, s)."""
    for r in range(r0, r1 + 1):
        x0, x1 = st.get(f, r, k), st.get(f, r, k + 1)
        st.put(f, r, k, x0 * c + x1 * s)
        st.put(f, r, k + 1, x0 * (-s) + x1 * c)


def _steps(st, log, rots, j0, j1, n, S, cmax):
    """Steps j0..j1-1 of the reference order on the store ``st``; the left
    rotations reach columns up to ``cmax``.  rots[f][j - j0] gets factor f's
    two left rotations of step j: (c, s) on rows j+1, j+2, then on j, j+1."""
    p = len(S)
    for j in range(j0, j1):
        c2, s2, r2 = givens_r(st.get(0, j + 1, j - 1), st.get(0, j + 2, j - 1))
        c1, s1, r1 = givens_r(st.get(0, j, j - 1), r2)
        st.put(0, j, j - 1, r1)
        st.put(0, j + 1, j - 1, 0.0)
        st.put(0, j + 2, j - 1, 0.0)
        log[0, j, 0:9] = fuse_left(c1, s1, c2, s2)
        log[0, j, 18:27] = fuse_right(c1, s1, c2, s2)
        log[0, j, 27] = r1
        rots[0][j - j0] = (c2, s2, c1, s1)
        if j <= cmax:  # rows j+1, j+2 then j, j+1, fused per column
            x0, x1, x2 = (st.row(0, j + t, j, cmax) for t in range(3))
            y1 = c2 * x1 + s2 * x2
            st.put_row(0, j + 2, j, -s2 * x1 + c2 * x2)
            st.put_row(0, j, j, c1 * x0 + s1 * y1)
            st.put_row(0, j + 1, j, -s1 * x0 + c1 * y1)
        for l in range(p - 1, 0, -1):
            if S[l]:
                log[l, j, 9:18] = fuse_right(c1, s1, c2, s2)
                _band_right(st, l, j + 1, j, j + 2, c2, s2)
                c2n, s2n, r = givens_r(st.get(l, j + 1, j + 1), st.get(l, j + 2, j + 1))
                st.put(l, j + 1, j + 1, r)
                st.put(l, j + 2, j + 1, 0.0)
                _rows_left(st, l, j + 1, j + 2, cmax, c2n, s2n)
                _band_right(st, l, j, j, j + 1, c1, s1)
                c1n, s1n, r = givens_r(st.get(l, j, j), st.get(l, j + 1, j))
                st.put(l, j, j, r)
                st.put(l, j + 1, j, 0.0)
                _rows_left(st, l, j, j + 1, cmax, c1n, s1n)
                log[l, j, 0:9] = fuse_left(c1n, s1n, c2n, s2n)
                log[l, j, 18:27] = fuse_right(c1n, s1n, c2n, s2n)
                rots[l][j - j0] = (c2n, s2n, c1n, s1n)
            else:
                _rows_left(st, l, j + 1, j, cmax, c2, s2)
                log[l, j, 0:9] = fuse_left(c1, s1, c2, s2)
                rots[l][j - j0] = (c2, s2, c1, s1)
                c2n, s2n, r = givens_r(st.get(l, j + 2, j + 2), -st.get(l, j + 2, j + 1))
                st.put(l, j + 2, j + 1, 0.0)
                st.put(l, j + 2, j + 2, r)
                _band_right(st, l, j + 1, j, j + 1, c2n, s2n)
                _rows_left(st, l, j, j, cmax, c1, s1)
                c1n, s1n, r = givens_r(st.get(l, j + 1, j + 1), -st.get(l, j + 1, j))
                st.put(l, j + 1, j, 0.0)
                st.put(l, j + 1, j + 1, r)
                _band_right(st, l, j, j, j, c1n, s1n)
                log[l, j, 9:18] = fuse_right(c1n, s1n, c2n, s2n)
                log[l, j, 18:27] = fuse_right(c1n, s1n, c2n, s2n)
            c1, s1, c2, s2 = c1n, s1n, c2n, s2n
        r1 = min(j + 3, n - 1)  # the ring close on factor 0
        _band_right(st, 0, j + 1, j, r1, c2, s2)
        _band_right(st, 0, j, j, r1, c1, s1)
        log[0, j, 9:18] = fuse_right(c1, s1, c2, s2)


def _check_args(H, m, i, S):
    p, n, _ = H.shape
    assert len(S) == p and S[0] and 1 <= m and m <= i - 2 and i <= n - 1
    return p, n


def rg_log_full(H, m, i, S):
    """The log of the reference order on a full working copy, and the
    working copy at the end."""
    p, n = _check_args(H, m, i, S)
    log = np.full((p, n, LOG), np.nan)
    rots = [[None] * (i - 1 - m) for _ in range(p)]
    st = _Full(H)
    _steps(st, log, rots, m, i - 1, n, S, n - 1)
    return log, st.A


def rg_log_windowed(H, m, i, S, L):
    """The log of the batched schedule with batch length L; also returns
    the blocks of the last batch (p, L+3, L+3) and its first step j0."""
    p, n = _check_args(H, m, i, S)
    assert L >= 1
    log = np.full((p, n, LOG), np.nan)
    win = _Window(p, L, n, i)
    carry = np.full((p, 2, n), np.nan)
    j0 = m
    win.j0 = j0
    j1 = min(j0 + L, i - 1)
    for f in range(p):  # the first block
        for r in range(j0, min(j1 + 2, n - 1) + 1):
            win.put_row(f, r, j0 - 1, H[f, r, j0 - 1:j1 + 2])
    while True:
        rots = [[None] * L for _ in range(p)]
        _steps(win, log, rots, j0, j1, n, S, j1 + 1)
        if j1 == i - 1:
            return log, win.W, j0
        a = j1 - j0  # rows j1..j1+2, columns j1-1..j1+1
        corner = win.W[:, a:a + 3, a:a + 3].copy()
        # the batch's left rotations on the columns right of the block, in
        # step order; the first row of each step's second rotation is final
        # and not formed
        fresh = {}
        for f in range(p):
            for c in range(j1 + 2, i + 1):
                if j0 == m:
                    x0, x1 = float(H[f, j0, c]), float(H[f, j0 + 1, c])
                else:
                    x0, x1 = float(carry[f, 0, c]), float(carry[f, 1, c])
                for s in range(L):
                    cA, sA, cB, sB = rots[f][s]
                    x2 = float(H[f, j0 + s + 2, c])
                    y1 = cA * x1 + sA * x2
                    x0, x1 = -sB * x0 + cB * y1, -sA * x1 + cA * x2
                fresh[f, c] = (x0, x1)
        j0, j1 = j1, min(j1 + L, i - 1)
        win.W[:] = np.nan
        win.j0 = j0
        rlast = min(j1 + 2, n - 1)
        for f in range(p):
            win.W[f, 0:3, 0:3] = corner[f]
            for c in range(j0 + 2, j1 + 2):
                win.put(f, j0, c, fresh[f, c][0])
                win.put(f, j0 + 1, c, fresh[f, c][1])
            win.put_row(f, j0 + 2, j0 + 2, H[f, j0 + 2, j0 + 2:j1 + 2])
            for r in range(j0 + 3, rlast + 1):
                win.put_row(f, r, j0 - 1, H[f, r, j0 - 1:j1 + 2])
            for c in range(j1 + 2, i + 1):
                carry[f, :, c] = fresh[f, c]
