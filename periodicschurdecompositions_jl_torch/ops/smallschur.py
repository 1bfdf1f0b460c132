"""Fixed-budget eigenvalues of a small real upper-Hessenberg matrix.

The shift engine of the multi-bulge sweep (``pqr_real.pqr_real_core`` with
``AlgoConfig.nbulges > 1``): the shifts of NB bulges are the eigenvalues of
the trailing 2 NB x 2 NB window of the cycle product (small-bulge
multishift semantics, as LAPACK dlaqr0 takes them from dlahqr on the
window).

Port of the JAX package's ``ops/smallschur.py``: the same masked,
fixed-budget Francis double-shift iteration with bottom deflation on an
M x M matrix (M <= 8), the same relative deflation threshold and the same
positional readout of the 2x2 blocks.  It runs on the host in numpy
float64 (the window is a few dozen numbers).  The one change is an early
stop once every eigenvalue has deflated: the remaining budget would leave
the matrix as it is.
"""
from __future__ import annotations

import numpy as np

_TOL = 1e-10  # relative deflation threshold; shift estimates need no more


def _eig2x2(a, b, c, d):
    """Eigenvalues (re1, im1, re2) of [[a, b], [c, d]]; im2 = -im1."""
    s = abs(a) + abs(b) + abs(c) + abs(d)
    ss = 1.0 if s == 0 else s
    an, bn, cn, dn = a / ss, b / ss, c / ss, d / ss
    tc = (an + dn) * 0.5
    h = (an - dn) * 0.5
    disc = h * h + bn * cn
    rt = float(np.sqrt(abs(disc)))
    if disc >= 0:
        return (tc + rt) * s, 0.0 * s, (tc - rt) * s
    return tc * s, rt * s, tc * s


def _negligible(W):
    """neg[j]: the subdiagonal W[j, j-1] is deflatable (j >= 1)."""
    A = np.abs(W)
    d = A.diagonal()
    floor = _TOL * max(A.max(), 1e-300)
    neg = np.ones(W.shape[0], dtype=bool)
    neg[1:] = A.diagonal(-1) <= _TOL * (d[1:] + d[:-1]) + floor
    return neg


def _chase_step(W, k, ib, x0, x1, x2):
    """One 3x3 reflector (2x2 at k == ib - 1) from (x0, x1, x2), applied to
    rows and columns k..k+2 of W in place."""
    r = 3 if k <= ib - 2 else 2
    if r == 2:
        x2 = 0.0
    nx = float(np.sqrt(x0 * x0 + x1 * x1 + x2 * x2))
    beta = -(nx if x0 >= 0 else -nx)
    v0 = x0 - (beta if nx > 0 else 1.0)
    vn2 = v0 * v0 + x1 * x1 + x2 * x2
    tau = 2.0 / vn2 if (nx > 0 and vn2 > 0) else 0.0
    if tau == 0.0:
        return  # the identity
    v = np.array((v0, x1, x2)[:r])
    rows = W[k:k + r]
    rows -= (tau * v)[:, None] * (v @ rows)[None, :]
    cols = W[:, k:k + r]
    cols -= (tau * (cols @ v))[:, None] * v[None, :]


def _sweep(W, ib, its, neg, low):
    """One Francis double-shift sweep on the active block [lw, ib] (ib >= 2);
    ``low`` masks the entries below the first subdiagonal."""
    g = W.item

    # start after the last negligible subdiagonal in [1, ib-1]
    lw = 0
    for j in range(ib - 1, 0, -1):
        if neg[j]:
            lw = j
            break
    a, b, c, d = g(ib - 1, ib - 1), g(ib - 1, ib), g(ib, ib - 1), g(ib, ib)
    if its > 0 and its % 10 == 0:  # exceptional shift
        sE = abs(c) + abs(g(ib - 1, ib - 2))
        a = 0.75 * sE + d
        b, c, d = -0.4375 * sE, sE, a
    s1r, s1i, s2r = _eig2x2(a, b, c, d)

    # first column of (W - s1)(W - s2) e_lw, rows lw..lw+2
    h11, h12, h21, h22 = g(lw, lw), g(lw, lw + 1), g(lw + 1, lw), g(lw + 1, lw + 1)
    h32 = g(lw + 2, lw + 1) if lw + 2 <= ib else 0.0
    sv = abs(h11 - s2r) + abs(s1i) + abs(h21)
    svs = 1.0 if sv == 0 else sv
    h21s = h21 / svs
    x = (h21s * h12 + (h11 - s1r) * ((h11 - s2r) / svs) + s1i * (s1i / svs),
         h21s * (h11 + h22 - s1r - s2r), h21s * h32)
    for k in range(lw, ib):
        if k > lw:
            x = (g(k, k - 1), g(k + 1, k - 1), g(k + 2, k - 1) if k + 2 <= ib else 0.0)
        _chase_step(W, k, ib, *x)
    # exact Hessenberg zeros below the first subdiagonal
    W[low] = 0.0


def hess_eigs_small(W, niter: int | None = None):
    """Eigenvalues (wr, wi) of a small real Hessenberg matrix, in diagonal
    order (a conjugate pair occupies its block's two positions).

    Runs at most ``niter`` (default ``15 * M``) masked Francis double-shift
    iterations with bottom deflation, then reads the eigenvalues
    positionally off the resulting (quasi-)triangular matrix.
    """
    W = np.array(W, dtype=np.float64)
    M = W.shape[0]
    if M == 1:
        return W[0, :1].copy(), np.zeros(1)
    K = 15 * M if niter is None else niter
    ib, its = M - 1, 0
    low = np.tri(M, M, -2, dtype=bool)
    for _ in range(K):
        if ib <= 0:
            break  # all deflated: the rest of the budget changes nothing
        neg = _negligible(W)
        if neg[ib]:
            ib -= 1
            W[ib + 1, ib] *= 0.0
            its = 0
        elif ib >= 2 and neg[ib - 1]:
            ib -= 2
            W[ib + 1, ib] *= 0.0
            its = 0
        elif ib == 1:
            ib, its = -1, 0  # a 2x2 block left at the top: nothing to chase
        else:
            _sweep(W, ib, its, neg, low)
            its += 1

    # positional readout: 2x2 blocks where the subdiagonal survived
    d = np.abs(np.diagonal(W))
    subs = np.abs(np.diagonal(W, -1))
    floor = _TOL * max(np.max(np.abs(W)), 1e-300)
    t = subs > _TOL * (d[:-1] + d[1:]) + floor  # t[j]: a block at rows j, j+1
    wr = np.diagonal(W).copy()
    wi = np.zeros(M)
    g = W.item
    for j in range(M - 1):
        if t[j]:  # the first member unless a block also starts at j-1
            re1, im1, re2 = _eig2x2(g(j, j), g(j, j + 1), g(j + 1, j), g(j + 1, j + 1))
            if j == 0 or not t[j - 1]:
                wr[j], wi[j] = re1, im1
            wr[j + 1], wi[j + 1] = re2, -im1
    return wr, wi
