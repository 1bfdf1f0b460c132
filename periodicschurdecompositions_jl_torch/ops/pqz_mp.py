"""Arbitrary-precision (mpmath) host path: generic-eltype periodic QZ.

The port's own copy of the JAX package's ``ops/pqz_mp.py`` (host code in
both packages: numpy and mpmath, no device work).  ``pschur_mp`` also takes
a torch tensor on any device and reads it to the host.  Without mpmath
(the card machine has none) the module imports and ``pschur_mp`` raises
RuntimeError.

Capability parity with the reference's generic-eltype (BigFloat) pipeline:
the reference runs extended precision end to end through its generic signed
Hessenberg-triangular reduction (reference src/generalized.jl:1085-1179)
and its eltype-generic complex periodic QZ core
(reference src/generalized.jl:166-931), exercised with BigFloat in its
test matrix (reference test/runtests.jl, test/generalized.jl).  The card
computes in float64 at most, so — exactly like the reference — the generic
path is a HOST path: a scalar mpmath implementation of the same two stages at any
working precision (``mpmath.mp.dps``).

Scope and conventions (all mirror the f64 cores of this package):

* complex (unitary) decomposition for any input eltype: real cycles are
  decomposed in complex arithmetic (the reference's generic REAL core keeps
  a real quasi-triangular form; this path trades that structural nicety for
  one generic core — a documented deviation).
* signatures per :mod:`.pqz_complex` (``S[0]`` must be True); eigenvalues in
  decomposed ``alpha / beta * 2^scale`` form with ``|alpha| ∈ [1,2) ∪ {0}``
  and ``beta ∈ {0,1}``.
* algorithm identical to :func:`.pqz_complex.pqz_complex_core` (MB03BZ
  semantics: deflation tests 1-3, controlled zero shift, deflate_pos/neg,
  single-shift QZ sweeps, diagonal phase-rescale postprocess), written as
  plain scalar Python over mpmath numbers.

This is a small-n convenience/verification path (object arithmetic is
O(n^3 p) Python-scalar work); the production paths are the device cores.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    from mpmath import mp, mpc, mpf
    HAVE_MPMATH = True
except ImportError:  # no mpmath: the module imports, pschur_mp raises
    HAVE_MPMATH = False


# --------------------------------------------------------------------------
# scalar kernels

def _givens(f, g):
    """Complex Givens: (c real >= 0, s, r) with [c s; -s̄ c] @ [f, g] = [r, 0].

    Same convention as ops/rotations.givens_complex (g == 0 -> (1, 0, f)
    exactly; f == 0 -> (0, ḡ/|g|, |g|)); mpmath needs no over/underflow
    scaling.
    """
    f = mpc(f)
    g = mpc(g)
    if g == 0:
        return mp.one, mpc(0), f
    if f == 0:
        ag = abs(g)
        return mp.zero, g.conjugate() / ag, mpc(ag)
    af = abs(f)
    d = mp.sqrt(af * af + abs(g) ** 2)
    c = af / d
    fs = f / af
    return c, fs * g.conjugate() / d, fs * d


def _lmat(c, s):
    """Left action of G(c, s) on a row pair: [[c, s], [-s̄, c]] (c real)."""
    return (c, s, -s.conjugate(), mpc(c))


def _rmat_adj(c, s):
    """Right action of G(c, s)^H on a column pair: [[c, -s], [s̄, c]]."""
    return (c, -s, s.conjugate(), mpc(c))


def _rows2(A, i, M, lo=0, hi=None):
    """A[i:i+2, lo:hi] = M @ A[i:i+2, lo:hi] (M a flat 2x2 tuple)."""
    a, b, c, d = M
    hi = len(A) if hi is None else hi
    Ai, Ai1 = A[i], A[i + 1]
    for j in range(lo, hi):
        x, y = Ai[j], Ai1[j]
        Ai[j] = a * x + b * y
        Ai1[j] = c * x + d * y


def _cols2(A, j, M, lo=0, hi=None):
    """A[lo:hi, j:j+2] = A[lo:hi, j:j+2] @ M."""
    a, b, c, d = M
    hi = len(A) if hi is None else hi
    for i in range(lo, hi):
        Ai = A[i]
        x, y = Ai[j], Ai[j + 1]
        Ai[j] = x * a + y * c
        Ai[j + 1] = x * b + y * d


def _to_mp(A) -> List[List[List[mpc]]]:
    A = np.asarray(A)
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected a (p, n, n) cycle, got shape {A.shape}")
    if A.dtype == object:
        # arbitrary-precision input (mpf/mpc entries): convert exactly —
        # a complex() round-trip would truncate to f64 and silently cap
        # the achievable backward error at ~1e-16 regardless of dps
        return [[[mpc(A[l, i, j]) for j in range(A.shape[2])]
                 for i in range(A.shape[1])] for l in range(A.shape[0])]
    return [[[mpc(complex(A[l, i, j])) for j in range(A.shape[2])]
             for i in range(A.shape[1])] for l in range(A.shape[0])]


def _eye_mp(n):
    return [[mpc(1) if i == j else mpc(0) for j in range(n)]
            for i in range(n)]


def _safeprod_signed_mp(x, S):
    """Scaled signed product: (alpha, beta, scale), |alpha| in [1,2) u {0}.

    Mirrors utils/safeprod.safeprod_signed (reference `_safeprod`,
    src/generalized.jl:933-976): beta = 0 encodes an infinite eigenvalue
    from a singular inverted factor.
    """
    alpha = mpc(1)
    beta = 1
    for xl, sl in zip(x, S):
        if sl:
            alpha = alpha * xl
        elif xl == 0:
            beta = 0
        else:
            alpha = alpha / xl
    scale = 0
    a = abs(alpha)
    if a != 0:
        e = mp.floor(mp.log(a, 2))
        scale = int(e)
        alpha = alpha / mpf(2) ** scale
        # guard log rounding at binade boundaries
        while abs(alpha) >= 2:
            alpha /= 2
            scale += 1
        while abs(alpha) < 1:
            alpha *= 2
            scale -= 1
    return alpha, beta, scale


# --------------------------------------------------------------------------
# reduction: signed periodic Hessenberg-triangular, Givens-based

def phessenberg_mp(A, S: Sequence[bool], want_q: bool = True):
    """Generic periodic Hessenberg(-triangular) reduction in mp arithmetic.

    Same contract as ops/hessenberg.phessenberg_signed_core (reference
    generic `_phessenberg!`, src/generalized.jl:1085-1179): on return
    ``H[0]`` is upper Hessenberg, ``H[1:]`` upper triangular, with
    ``Q[l]^H A[l] Q[(l+1)%p] = H[l]`` for direct factors and
    ``Q[(l+1)%p]^H A[l] Q[l] = H[l]`` for inverted ones.  ``A`` is a list
    of mp matrices and is MUTATED; pass a fresh copy.
    """
    p = len(A)
    n = len(A[0])
    if not S[0]:
        raise ValueError("signature entry S[0] must be True")
    Q = [_eye_mp(n) for _ in range(p)] if want_q else None

    # ---- stage 1: triangularize factors p-1..1 (Givens QR / RQ) ---------
    for l in range(p - 1, 0, -1):
        if S[l]:
            # QR: A[l] <- Qf^H A[l]; neighbor A[l-1] takes Qf on its S-side
            for j in range(n):
                for i in range(n - 1, j, -1):
                    c, s, r = _givens(A[l][i - 1][j], A[l][i][j])
                    if s == 0:
                        continue
                    A[l][i - 1][j] = r
                    A[l][i][j] = mpc(0)
                    _rows2(A[l], i - 1, _lmat(c, s), lo=j + 1)
                    if S[l - 1]:
                        _cols2(A[l - 1], i - 1, _rmat_adj(c, s))
                    else:
                        _rows2(A[l - 1], i - 1, _lmat(c, s))
                    if want_q:
                        _cols2(Q[l], i - 1, _rmat_adj(c, s))
        else:
            # RQ: A[l] <- A[l] Qf^H via right lmat rotations (row i zeroed
            # left-to-right with column pairs (j, j+1), rows bottom-up)
            for i in range(n - 1, 0, -1):
                for j in range(i):
                    c, s, r = _givens(A[l][i][j + 1], A[l][i][j])
                    if s == 0:
                        continue
                    A[l][i][j] = mpc(0)
                    A[l][i][j + 1] = r
                    _cols2(A[l], j, _lmat(c, s), hi=i)
                    if S[l - 1]:
                        _cols2(A[l - 1], j, _lmat(c, s))
                    else:
                        _rows2(A[l - 1], j, _rmat_adj(c, s))
                    if want_q:
                        _cols2(Q[l], j, _lmat(c, s))

    if n <= 2:
        for l in range(1, p):
            for i in range(1, n):
                for j in range(i):
                    A[l][i][j] = mpc(0)
        return A, Q

    # ---- stage 2: Givens Hessenberg reduction of factor 0 ----------------
    G: List[Tuple] = [(mp.one, mpc(0))] * n
    for j in range(n - 2):
        for i in range(n - 1, j + 1, -1):
            c, s, r = _givens(A[0][i - 1][j], A[0][i][j])
            A[0][i - 1][j] = r
            A[0][i][j] = mpc(0)
            _rows2(A[0], i - 1, _lmat(c, s), lo=j + 1)
            G[i] = (c, s)
        if want_q:
            for i in range(n - 1, j + 1, -1):
                _cols2(Q[0], i - 1, _rmat_adj(*G[i]))
        for l in range(p - 1, 0, -1):
            if S[l]:
                for i in range(n - 1, j + 1, -1):
                    _cols2(A[l], i - 1, _rmat_adj(*G[i]), hi=i + 1)
                    c, s, r = _givens(A[l][i - 1][i - 1], A[l][i][i - 1])
                    A[l][i - 1][i - 1] = r
                    A[l][i][i - 1] = mpc(0)
                    _rows2(A[l], i - 1, _lmat(c, s), lo=i)
                    G[i] = (c, s)
            else:
                for i in range(n - 1, j + 1, -1):
                    _rows2(A[l], i - 1, _lmat(*G[i]), lo=i - 1)
                    c, s, r = _givens(A[l][i][i], A[l][i][i - 1])
                    A[l][i][i] = r
                    A[l][i][i - 1] = mpc(0)
                    _cols2(A[l], i - 1, _lmat(c, s), hi=i)
                    G[i] = (c, -s)
            if want_q:
                for i in range(n - 1, j + 1, -1):
                    _cols2(Q[l], i - 1, _rmat_adj(*G[i]))
        for i in range(n - 1, j + 1, -1):
            _cols2(A[0], i - 1, _rmat_adj(*G[i]))
    return A, Q


# --------------------------------------------------------------------------
# QZ core (scalar mirror of ops/pqz_complex.pqz_complex_core +
# ops/pqz_deflate.make_deflate_cores)

def _deflate_pos_mp(H, Z, S, jlo, ldef, jdef, ilast, want_z):
    """Non-inverted singular factor: two unshifted half-sweeps meet at the
    zero (mirror of pqz_deflate.pos_core; reference deflate_pos,
    src/generalized.jl:453-566)."""
    p = len(H)
    H[ldef][jdef][jdef] = mpc(0)

    # first half-sweep downwards from jlo
    G = {}
    for k in range(jlo, jdef):
        c, s, r = _givens(H[0][k][k], H[0][k + 1][k])
        H[0][k][k] = r
        H[0][k + 1][k] = mpc(0)
        _rows2(H[0], k, _lmat(c, s), lo=k + 1)
        G[k] = (c, s)
    if want_z:
        for k in range(jlo, jdef):
            _cols2(Z[0], k, _rmat_adj(*G[k]))
    for l in range(p - 1, 0, -1):
        ntra = jdef - 2 if l < ldef else jdef - 1
        if S[l]:
            for k in range(jlo, ntra + 1):
                _cols2(H[l], k, _rmat_adj(*G[k]), hi=k + 2)
                c, s, r = _givens(H[l][k][k], H[l][k + 1][k])
                H[l][k][k] = r
                H[l][k + 1][k] = mpc(0)
                _rows2(H[l], k, _lmat(c, s), lo=k + 1)
                G[k] = (c, s)
        else:
            for k in range(jlo, ntra + 1):
                _rows2(H[l], k, _lmat(*G[k]), lo=k)
                c, s, r = _givens(H[l][k + 1][k + 1], H[l][k + 1][k])
                H[l][k + 1][k + 1] = r
                H[l][k + 1][k] = mpc(0)
                _cols2(H[l], k, _lmat(c, s), hi=k + 1)
                G[k] = (c, -s)
        if want_z:
            for k in range(jlo, ntra + 1):
                _cols2(Z[l], k, _rmat_adj(*G[k]))
    for k in range(jlo, jdef - 1):
        _cols2(H[0], k, _rmat_adj(*G[k]), hi=k + 2)

    # second half-sweep upwards from ilast
    G2 = {}
    for j in range(ilast, jdef, -1):
        c, s, r = _givens(H[0][j][j], H[0][j][j - 1])
        H[0][j][j] = r
        H[0][j][j - 1] = mpc(0)
        _cols2(H[0], j - 1, _lmat(c, s), hi=j)
        G2[j] = (c, -s)
    if want_z:
        for j in range(ilast, jdef, -1):
            _cols2(Z[1 % p], j - 1, _rmat_adj(*G2[j]))
    for l in range(1, p):
        ntra = jdef + 2 if l > ldef else jdef + 1
        if not S[l]:
            for j in range(ilast, ntra - 1, -1):
                _cols2(H[l], j - 1, _rmat_adj(*G2[j]), hi=j + 1)
                c, s, r = _givens(H[l][j - 1][j - 1], H[l][j][j - 1])
                H[l][j - 1][j - 1] = r
                H[l][j][j - 1] = mpc(0)
                _rows2(H[l], j - 1, _lmat(c, s), lo=j)
                G2[j] = (c, s)
        else:
            for j in range(ilast, ntra - 1, -1):
                _rows2(H[l], j - 1, _lmat(*G2[j]), lo=j - 1)
                c, s, r = _givens(H[l][j][j], H[l][j][j - 1])
                H[l][j][j] = r
                H[l][j][j - 1] = mpc(0)
                _cols2(H[l], j - 1, _lmat(c, s), hi=j)
                G2[j] = (c, -s)
        if want_z:
            for j in range(ilast, ntra - 1, -1):
                _cols2(Z[(l + 1) % p], j - 1, _rmat_adj(*G2[j]))
    for j in range(ilast, jdef + 1, -1):
        _rows2(H[0], j - 1, _lmat(*G2[j]), lo=j - 1)


def _deflate_neg_mp(H, Z, S, jlo, ldef, jdef, ilast, want_z):
    """Inverted singular factor: chase the zero off the window bottom/top
    (mirror of pqz_deflate.neg_core; reference deflate_neg,
    src/generalized.jl:568-740)."""
    p = len(H)
    n = len(H[0])
    H[ldef][jdef][jdef] = mpc(0)

    def zup(l, base, c, s):
        if want_z:
            _cols2(Z[l], base, _rmat_adj(c, s))

    if jdef + 1 > (ilast - jlo + 1) / 2:
        # ---------------- chase down ----------------
        for j1 in range(jdef, ilast):
            j = j1
            c, s, r = _givens(H[ldef][j][j + 1], H[ldef][j + 1][j + 1])
            H[ldef][j][j + 1] = r
            H[ldef][j + 1][j + 1] = mpc(0)
            _rows2(H[ldef], j, _lmat(c, s), lo=j + 2)
            ln = (ldef + 1) % p
            zup(ln, j, c, s)
            for _ in range(p - 1):
                Hl = H[ln]
                if ln == 0:
                    _rows2(Hl, j, _lmat(c, s), lo=j - 1)
                    c, s, r = _givens(Hl[j + 1][j], Hl[j + 1][j - 1])
                    Hl[j + 1][j] = r
                    Hl[j + 1][j - 1] = mpc(0)
                    _cols2(Hl, j - 1, _lmat(c, s), hi=j + 1)
                    j, s = j - 1, -s
                elif S[ln]:
                    _rows2(Hl, j, _lmat(c, s), lo=j)
                    c, s, r = _givens(Hl[j + 1][j + 1], Hl[j + 1][j])
                    Hl[j + 1][j + 1] = r
                    Hl[j + 1][j] = mpc(0)
                    _cols2(Hl, j, _lmat(c, s), hi=j + 1)
                    s = -s
                else:
                    _cols2(Hl, j, _rmat_adj(c, s), hi=j + 2)
                    c, s, r = _givens(Hl[j][j], Hl[j + 1][j])
                    Hl[j][j] = r
                    Hl[j + 1][j] = mpc(0)
                    _rows2(Hl, j, _lmat(c, s), lo=j + 1)
                ln = (ln + 1) % p
                zup(ln, j, c, s)
            _cols2(H[ldef], j, _rmat_adj(c, s), hi=j + 1)
        # deflate the last element of the Hessenberg factor
        j = ilast
        c, s, r = _givens(H[0][j][j], H[0][j][j - 1])
        H[0][j][j] = r
        H[0][j][j - 1] = mpc(0)
        _cols2(H[0], j - 1, _lmat(c, s), hi=j)
        c2, s2 = c, -s
        zup(1 % p, j - 1, c2, s2)
        for l in range(1, p):
            if l >= ldef:
                continue
            Hl = H[l]
            if not S[l]:
                _cols2(Hl, j - 1, _rmat_adj(c2, s2), hi=j + 1)
                cn, sn, r = _givens(Hl[j - 1][j - 1], Hl[j][j - 1])
                Hl[j - 1][j - 1] = r
                Hl[j][j - 1] = mpc(0)
                _rows2(Hl, j - 1, _lmat(cn, sn), lo=j)
                c2, s2 = cn, sn
            else:
                _rows2(Hl, j - 1, _lmat(c2, s2), lo=j - 1)
                cn, sn, r = _givens(Hl[j][j], Hl[j][j - 1])
                Hl[j][j] = r
                Hl[j][j - 1] = mpc(0)
                _cols2(Hl, j - 1, _lmat(cn, sn), hi=j)
                c2, s2 = cn, -sn
            zup((l + 1) % p, j - 1, c2, s2)
        _cols2(H[ldef], j - 1, _rmat_adj(c2, s2), hi=j + 1)
    else:
        # ---------------- chase up ----------------
        for j1 in range(jdef, jlo, -1):
            j = j1
            c, s, r = _givens(H[ldef][j - 1][j], H[ldef][j - 1][j - 1])
            H[ldef][j - 1][j] = r
            H[ldef][j - 1][j - 1] = mpc(0)
            _cols2(H[ldef], j - 1, _lmat(c, s), hi=j - 1)
            s = -s
            zup(ldef, j - 1, c, s)
            ln = (ldef - 1) % p
            for _ in range(p - 1):
                Hl = H[ln]
                if ln == 0:
                    _cols2(Hl, j - 1, _rmat_adj(c, s), hi=j + 2)
                    c, s, r = _givens(Hl[j][j - 1], Hl[j + 1][j - 1])
                    Hl[j][j - 1] = r
                    Hl[j + 1][j - 1] = mpc(0)
                    _rows2(Hl, j, _lmat(c, s), lo=j)
                    j = j + 1
                elif S[ln]:
                    _cols2(Hl, j - 1, _rmat_adj(c, s), hi=j + 1)
                    c, s, r = _givens(Hl[j - 1][j - 1], Hl[j][j - 1])
                    Hl[j - 1][j - 1] = r
                    Hl[j][j - 1] = mpc(0)
                    _rows2(Hl, j - 1, _lmat(c, s), lo=j)
                else:
                    _rows2(Hl, j - 1, _lmat(c, s), lo=j - 1)
                    c, s, r = _givens(Hl[j][j], Hl[j][j - 1])
                    Hl[j][j] = r
                    Hl[j][j - 1] = mpc(0)
                    _cols2(Hl, j - 1, _lmat(c, s), hi=j)
                    s = -s
                zup(ln, j - 1, c, s)
                ln = (ln - 1) % p
            _rows2(H[ldef], j - 1, _lmat(c, s), lo=j)
        # deflate the first element of the Hessenberg factor
        j = jlo
        c, s, r = _givens(H[0][j][j], H[0][j + 1][j])
        H[0][j][j] = r
        H[0][j + 1][j] = mpc(0)
        _rows2(H[0], j, _lmat(c, s), lo=j + 1)
        c2, s2 = c, s
        zup(0, j, c2, s2)
        for l in range(p - 1, 0, -1):
            if l <= ldef:
                continue
            Hl = H[l]
            if S[l]:
                _cols2(Hl, j, _rmat_adj(c2, s2), hi=j + 2)
                cn, sn, r = _givens(Hl[j][j], Hl[j + 1][j])
                Hl[j][j] = r
                Hl[j + 1][j] = mpc(0)
                _rows2(Hl, j, _lmat(cn, sn), lo=j + 1)
                c2, s2 = cn, sn
            else:
                _rows2(Hl, j, _lmat(c2, s2), lo=j)
                cn, sn, r = _givens(Hl[j + 1][j + 1], Hl[j + 1][j])
                Hl[j + 1][j + 1] = r
                Hl[j + 1][j] = mpc(0)
                _cols2(Hl, j, _lmat(cn, sn), hi=j + 1)
                c2, s2 = cn, -sn
            zup(l, j, c2, s2)
        _rows2(H[ldef], j, _lmat(c2, s2), lo=j + 1)


def _czshift_mp(H, Z, S, jlo, ilast, ulp, smlnum, want_z):
    """Controlled zero shift (mirror of pqz_deflate.czshift_core; reference
    src/generalized.jl:356-448).  Returns True if a deflation surfaced."""
    p = len(H)
    G = {}
    # stage A: triangularize the Hessenberg factor on the window
    for k in range(jlo, ilast):
        c, s, r = _givens(H[0][k][k], H[0][k + 1][k])
        H[0][k][k] = r
        H[0][k + 1][k] = mpc(0)
        _rows2(H[0], k, _lmat(c, s), lo=k + 1)
        G[k] = (c, s)
    if want_z:
        for k in range(jlo, ilast):
            _cols2(Z[0], k, _rmat_adj(*G[k]))
    # stage B: propagate backwards through the triangular factors
    for l in range(p - 1, 0, -1):
        for k in range(jlo, ilast):
            c, s = G[k]
            if s == 0:
                continue
            if S[l]:
                _cols2(H[l], k, _rmat_adj(c, s), hi=k + 2)
                tol = max(ulp * (abs(H[l][k][k]) + abs(H[l][k + 1][k + 1])),
                          smlnum)
                if abs(H[l][k + 1][k]) <= tol:
                    H[l][k + 1][k] = mpc(0)
                    G[k] = (mp.one, mpc(0))
                else:
                    c, s, r = _givens(H[l][k][k], H[l][k + 1][k])
                    H[l][k][k] = r
                    H[l][k + 1][k] = mpc(0)
                    _rows2(H[l], k, _lmat(c, s), lo=k + 1)
                    G[k] = (c, s)
            else:
                _rows2(H[l], k, _lmat(c, s), lo=k)
                tol = max(ulp * (abs(H[l][k][k]) + abs(H[l][k + 1][k + 1])),
                          smlnum)
                if abs(H[l][k + 1][k]) <= tol:
                    H[l][k + 1][k] = mpc(0)
                    G[k] = (mp.one, mpc(0))
                else:
                    c, s, r = _givens(H[l][k + 1][k + 1], H[l][k + 1][k])
                    H[l][k + 1][k + 1] = r
                    H[l][k + 1][k] = mpc(0)
                    _cols2(H[l], k, _lmat(c, s), hi=k + 1)
                    G[k] = (c, -s)
        if want_z:
            for k in range(jlo, ilast):
                _cols2(Z[l], k, _rmat_adj(*G[k]))
    # stage C: final chain to the right of the Hessenberg factor
    zflag = False
    for k in range(jlo, ilast):
        _cols2(H[0], k, _rmat_adj(*G[k]), hi=k + 2)
        zflag = zflag or (G[k][1] == 0)
    return zflag


def pqz_complex_core_mp(H, S: Sequence[bool], Z=None, want_z: bool = True,
                        maxitfac: int = 30, seed: int = 1234):
    """Generic-precision single-shift periodic QZ on mp matrices.

    Scalar mirror of :func:`.pqz_complex.pqz_complex_core` (reference
    MB03BZ-style core, src/generalized.jl:166-931); ``H`` (list of p mp
    matrices, H[0] Hessenberg, H[1:] triangular) and ``Z`` are MUTATED.

    Returns (H, Z, alpha, beta, scale, ok).
    """
    p = len(H)
    n = len(H[0])
    if not S[0]:
        raise ValueError("signature entry S[0] must be True")
    ulp = mp.eps
    smlnum = mpf(2) ** (-(1 << 20))  # mp exponents are unbounded
    safmin = smlnum
    maxit = maxitfac * n
    rng = random.Random(seed)
    if want_z and Z is None:
        Z = [_eye_mp(n) for _ in range(p)]

    alpha = [mpc(0)] * n
    beta = [1] * n
    scal = [0] * n

    def split1x1(ilast):
        a, b, sc = _safeprod_signed_mp([H[l][ilast][ilast] for l in range(p)],
                                       S)
        alpha[ilast] = a
        beta[ilast] = b
        scal[ilast] = sc

    ilast = n - 1
    iiter = 0
    ziter = 0
    jiter = 0
    while ilast >= 0 and jiter < maxit:
        jiter += 1
        if ilast == 0:
            split1x1(0)
            ilast -= 1
            iiter = 0
            ziter = 0
            continue
        # ---- test 1: negligible Hessenberg subdiagonal (bottom-most) ----
        jlo = 0
        for j in range(ilast, 0, -1):
            tol = max(ulp * (abs(H[0][j - 1][j - 1]) + abs(H[0][j][j])),
                      smlnum)
            if abs(H[0][j][j - 1]) <= tol:
                H[0][j][j - 1] = mpc(0)
                jlo = j
                break
        if jlo == ilast:
            split1x1(ilast)
            ilast -= 1
            iiter = 0
            ziter = 0
            continue
        # ---- tests 2/3: negligible triangular diagonal -------------------
        ldef = jdef = -1
        for wantpos in (True, False):
            for l in range(1, p):
                if bool(S[l]) != wantpos:
                    continue
                for j in range(ilast, jlo - 1, -1):
                    if j == ilast:
                        tol = abs(H[l][j - 1][j]) if j > 0 else mpf(0)
                    elif j == jlo:
                        tol = abs(H[l][j][j + 1])
                    else:
                        tol = abs(H[l][j - 1][j]) + abs(H[l][j][j + 1])
                    tol = max(ulp * tol, smlnum)
                    if abs(H[l][j][j]) <= tol:
                        ldef, jdef = l, j
                        break
                if ldef >= 0:
                    break
            if ldef >= 0:
                break
        if ldef >= 0:
            if S[ldef]:
                _deflate_pos_mp(H, Z, S, jlo, ldef, jdef, ilast, want_z)
            else:
                _deflate_neg_mp(H, Z, S, jlo, ldef, jdef, ilast, want_z)
            continue
        # ---- controlled zero shift ---------------------------------------
        if ziter >= 7:
            zflag = _czshift_mp(H, Z, S, jlo, ilast, ulp, smlnum, want_z)
            ziter = 1 if zflag else 0
            continue
        # ---- single-shift QZ sweep ----------------------------------------
        iiter += 1
        ziter += 1
        ifirst = jlo
        c, s, _ = _givens(mpc(1), mpc(1))
        for l in range(p - 1, 0, -1):
            hf = H[l][ifirst][ifirst]
            hl_ = H[l][ilast][ilast]
            if S[l]:
                c, s, _ = _givens(hf * c, hl_ * s.conjugate())
            else:
                c, s, _ = _givens(hl_ * c, -hf * s.conjugate())
                s = -s
        h0f = H[0][ifirst][ifirst]
        h0l = H[0][ilast][ilast]
        h0sub = H[0][ifirst + 1][ifirst]
        c, s, _ = _givens(h0f * c - h0l * s.conjugate(), h0sub * c)
        if iiter % 10 == 0:
            # exceptional shift: random rotation
            c, s, _ = _givens(mpc(rng.gauss(0, 1), rng.gauss(0, 1)),
                              mpc(rng.gauss(0, 1), rng.gauss(0, 1)))
        for k in range(ifirst, ilast):
            if k > ifirst:
                c, s, r = _givens(H[0][k][k - 1], H[0][k + 1][k - 1])
                H[0][k][k - 1] = r
                H[0][k + 1][k - 1] = mpc(0)
            _rows2(H[0], k, _lmat(c, s), lo=k)
            if want_z:
                _cols2(Z[0], k, _rmat_adj(c, s))
            for l in range(p - 1, 0, -1):
                if S[l]:
                    _cols2(H[l], k, _rmat_adj(c, s), hi=k + 2)
                    c, s, r = _givens(H[l][k][k], H[l][k + 1][k])
                    H[l][k][k] = r
                    H[l][k + 1][k] = mpc(0)
                    _rows2(H[l], k, _lmat(c, s), lo=k + 1)
                else:
                    _rows2(H[l], k, _lmat(c, s), lo=k)
                    c, s, r = _givens(H[l][k + 1][k + 1], H[l][k + 1][k])
                    H[l][k + 1][k + 1] = r
                    H[l][k + 1][k] = mpc(0)
                    _cols2(H[l], k, _lmat(c, s), hi=k + 1)
                    s = -s
                if want_z:
                    _cols2(Z[l], k, _rmat_adj(c, s))
            _cols2(H[0], k, _rmat_adj(c, s), hi=min(k + 3, n))
    ok = ilast < 0

    # ---- postprocess: rescale triangular diagonals to nonnegative reals --
    for l in range(p - 1, 0, -1):
        for j in range(n):
            d = H[l][j][j]
            absd = abs(d)
            if absd > safmin:
                z = d.conjugate() / absd
                newdiag = mpc(absd)
            else:
                z = mpc(1)
                newdiag = d
            if S[l]:
                for jj in range(n):
                    H[l][j][jj] = z * H[l][j][jj]
                sf = z
            else:
                for ii in range(n):
                    H[l][ii][j] = H[l][ii][j] * z
                sf = z.conjugate()
            H[l][j][j] = newdiag
            if want_z:
                sfc = sf.conjugate()
                for ii in range(n):
                    Z[l][ii][j] = Z[l][ii][j] * sfc
            lm = l - 1
            if S[lm]:
                sfc = sf.conjugate()
                for ii in range(n):
                    H[lm][ii][j] = H[lm][ii][j] * sfc
            else:
                for jj in range(n):
                    H[lm][j][jj] = sf * H[lm][j][jj]
    return H, Z if want_z else None, alpha, beta, scal, ok


# --------------------------------------------------------------------------
# REAL quasi-triangular core (the reference's generic real BigFloat path)
#
# The reference keeps real generic-eltype input in REAL arithmetic with a
# quasi-triangular Schur factor (generic reflector paths
# reference src/householder.jl:256-266, tested with BigFloat at
# reference test/runtests.jl:89-100).  This section restores that
# parity for the plain (all-positive) real PSD: a scalar mpmath
# translation of the same MB03VD + MB03WD algorithm shape the f64 cores
# implement (ops/hessenberg.py, ops/pqr_real.py), producing real mpf
# factors with 2x2 blocks for complex pairs.


def _to_mp_real(A):
    A = np.asarray(A)
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"expected a (p, n, n) cycle, got shape {A.shape}")
    if A.dtype == object:
        return [[[mpf(A[l, i, j]) for j in range(A.shape[2])]
                 for i in range(A.shape[1])] for l in range(A.shape[0])]
    return [[[mpf(float(A[l, i, j])) for j in range(A.shape[2])]
             for i in range(A.shape[1])] for l in range(A.shape[0])]


def _eye_mp_real(n):
    return [[mpf(1) if i == j else mpf(0) for j in range(n)]
            for i in range(n)]


def _givens_r(f, g):
    """Real Givens (c, s, r) with [c s; -s c] @ [f, g] = [r, 0], c >= 0."""
    f = mpf(f)
    g = mpf(g)
    if g == 0:
        return mp.one, mpf(0), f
    if f == 0:
        return mpf(0), mp.one if g >= 0 else -mp.one, abs(g)
    r = mp.hypot(f, g)
    if f < 0:
        r = -r
    return abs(f) / abs(r), g / r, r


def _rows2r(A, i, c, s, lo=0, hi=None):
    hi = len(A) if hi is None else hi
    r0, r1 = A[i], A[i + 1]
    for j in range(lo, hi):
        a, b = r0[j], r1[j]
        r0[j] = c * a + s * b
        r1[j] = -s * a + c * b


def _cols2r(A, j, c, s, lo=0, hi=None):
    hi = len(A) if hi is None else hi
    for i in range(lo, hi):
        row = A[i]
        a, b = row[j], row[j + 1]
        row[j] = c * a + s * b
        row[j + 1] = -s * a + c * b


def _lanv2_mp(a, b, c, d):
    """dlanv2 semantics at working precision (reference contract
    src/rschur2x2.jl:9-96).  Returns (a, b, c, d, cs, sn, w1, w2)."""
    eps = mp.eps
    if c == 0:
        cs, sn = mp.one, mpf(0)
    elif b == 0:
        cs, sn = mpf(0), mp.one
        a, d = d, a
        b, c = -c, mpf(0)
    elif (a - d) == 0 and (b < 0) != (c < 0):
        cs, sn = mp.one, mpf(0)
    else:
        temp = a - d
        pp = temp / 2
        bcmax = max(abs(b), abs(c))
        bcmis = min(abs(b), abs(c)) * (1 if b >= 0 else -1) * \
            (1 if c >= 0 else -1)
        scale = max(abs(pp), bcmax)
        z = (pp / scale) * pp + (bcmax / scale) * bcmis
        if z >= 4 * eps:
            zz = pp + (mp.sqrt(scale) * mp.sqrt(z) if pp >= 0
                       else -mp.sqrt(scale) * mp.sqrt(z))
            a = d + zz
            d = d - (bcmax / zz) * bcmis
            tau = mp.hypot(c, zz)
            cs = zz / tau
            sn = c / tau
            b = b - c
            c = mpf(0)
        else:
            sigma = b + c
            tau = mp.hypot(sigma, temp)
            cs = mp.sqrt((1 + abs(sigma) / tau) / 2)
            sn = -(pp / (tau * cs)) * (1 if sigma >= 0 else -1)
            aa = a * cs + b * sn
            bb = -a * sn + b * cs
            cc = c * cs + d * sn
            dd = -c * sn + d * cs
            a = aa * cs + cc * sn
            b = bb * cs + dd * sn
            c = -aa * sn + cc * cs
            d = -bb * sn + dd * cs
            mid = (a + d) / 2
            a = mid
            d = mid
            if c != 0:
                if b != 0:
                    if (b < 0) == (c < 0):
                        sab = mp.sqrt(abs(b))
                        sac = mp.sqrt(abs(c))
                        p2 = sab * sac if c >= 0 else -sab * sac
                        t2 = 1 / mp.sqrt(abs(b + c))
                        a = mid + p2
                        d = mid - p2
                        b = b - c
                        c = mpf(0)
                        cs1 = sab * t2
                        sn1 = sac * t2
                        cs, sn = cs * cs1 - sn * sn1, cs * sn1 + sn * cs1
                else:
                    b = -c
                    c = mpf(0)
                    cs, sn = -sn, cs
    if c == 0:
        w1 = mpc(a)
        w2 = mpc(d)
    else:
        wi = mp.sqrt(abs(b)) * mp.sqrt(abs(c))
        w1 = mpc(a, wi)
        w2 = mpc(d, -wi)
    return a, b, c, d, cs, sn, w1, w2


def phessenberg_real_mp(A, want_q: bool = True):
    """Real periodic Hessenberg reduction (Givens), all-positive cycle.

    Same contract as ops/hessenberg.phessenberg_core (reference MB03VD
    shape, src/PeriodicSchurDecompositions.jl:213-259): on return A[0] is
    upper Hessenberg, A[1:] upper triangular, Q[l]^T A_in[l] Q[(l+1)%p] =
    A[l].  ``A`` is a list of real mp matrices and is MUTATED.
    """
    p = len(A)
    n = len(A[0])
    Q = [_eye_mp_real(n) for _ in range(p)] if want_q else None
    for j in range(n - 1):
        for l in range(p - 1, 0, -1):
            for i in range(n - 1, j, -1):
                c, s, r = _givens_r(A[l][i - 1][j], A[l][i][j])
                if s == 0:
                    continue
                A[l][i - 1][j] = r
                A[l][i][j] = mpf(0)
                _rows2r(A[l], i - 1, c, s, lo=j + 1)
                _cols2r(A[l - 1], i - 1, c, s)
                if want_q:
                    _cols2r(Q[l], i - 1, c, s)
        if j + 2 < n:
            for i in range(n - 1, j + 1, -1):
                c, s, r = _givens_r(A[0][i - 1][j], A[0][i][j])
                if s == 0:
                    continue
                A[0][i - 1][j] = r
                A[0][i][j] = mpf(0)
                _rows2r(A[0], i - 1, c, s, lo=j + 1)
                _cols2r(A[p - 1] if p > 1 else A[0], i - 1, c, s)
                if want_q:
                    _cols2r(Q[0], i - 1, c, s)
    for l in range(1, p):
        for i in range(1, n):
            for j in range(i):
                A[l][i][j] = mpf(0)
    for i in range(2, n):
        for j in range(i - 1):
            A[0][i][j] = mpf(0)
    return A, Q


def _band_products_mp(H, lo, hi):
    """Band entries of the cycle product over rows [lo, hi] (same
    recurrence as ops/pqr_real._band_products; reference :477-528)."""
    p = len(H)
    n = len(H[0])
    P1 = [mpf(1)] * n
    P2 = [mpf(0)] * n
    P3 = [mpf(0)] * n
    lo = max(lo - 1, 0)
    hi = min(hi + 2, n - 1)
    for f in range(1, p):
        Hf = H[f]
        for r in range(lo, hi + 1):
            D = Hf[r][r]
            U = Hf[r][r + 1] if r + 1 < n else mpf(0)
            V = Hf[r][r + 2] if r + 2 < n else mpf(0)
            D1 = Hf[r + 1][r + 1] if r + 1 < n else mpf(0)
            U1 = Hf[r + 1][r + 2] if r + 2 < n else mpf(0)
            D2 = Hf[r + 2][r + 2] if r + 2 < n else mpf(0)
            P3[r] = P1[r] * V + P2[r] * U1 + P3[r] * D2
            P2[r] = P1[r] * U + P2[r] * D1
            P1[r] = P1[r] * D
    hdiag = [mpf(0)] * n
    hsub = [mpf(0)] * n
    hsup = [mpf(0)] * n
    H0 = H[0]
    for r in range(lo, hi + 1):
        d0 = H0[r][r]
        u0 = H0[r][r + 1] if r + 1 < n else mpf(0)
        s0 = H0[r][r - 1] if r >= 1 else mpf(0)
        P1m = P1[r - 1] if r >= 1 else mpf(1)
        P2m = P2[r - 1] if r >= 1 else mpf(0)
        P3m = P3[r - 1] if r >= 1 else mpf(0)
        hsub[r] = s0 * P1m
        hdiag[r] = s0 * P2m + d0 * P1[r]
        hsup[r] = s0 * P3m + d0 * P2[r] + (
            u0 * P1[r + 1] if r + 1 < n else mpf(0))
    return hdiag, hsub, hsup


def _refl3_mp(x):
    """Real reflector (xLARFG semantics): (w, tau, beta) with w[0] = 1 and
    (I - tau w w^T) x = beta e1 (reference src/householder.jl:66-108)."""
    q = len(x)
    alpha = x[0]
    xn2 = mp.fsum(t * t for t in x[1:])
    if xn2 == 0:
        return [mpf(1)] + [mpf(0)] * (q - 1), mpf(0), alpha
    b = mp.hypot(alpha, mp.sqrt(xn2))
    if alpha >= 0:
        b = -b
    tau = (b - alpha) / b
    inv = 1 / (alpha - b)
    return [mpf(1)] + [t * inv for t in x[1:]], tau, b


def _refl_rows_mp(A, r0, w, tau, c0=0, c1=None):
    c1 = len(A) if c1 is None else c1
    if tau == 0:
        return
    q = len(w)
    for col in range(c0, c1):
        s = mp.fsum(w[t] * A[r0 + t][col] for t in range(q)) * tau
        for t in range(q):
            A[r0 + t][col] -= w[t] * s


def _refl_cols_mp(A, c0, w, tau, r0=0, r1=None):
    r1 = len(A) if r1 is None else r1
    if tau == 0:
        return
    q = len(w)
    for row in range(r0, r1):
        Ar = A[row]
        s = mp.fsum(w[t] * Ar[c0 + t] for t in range(q)) * tau
        for t in range(q):
            Ar[c0 + t] -= w[t] * s


def pqr_real_core_mp(H, Z=None, want_z: bool = True, maxitfac: int = 30):
    """Real periodic QR iteration at working precision (MB03WD shape).

    Scalar mpmath mirror of ops/pqr_real.pqr_real_core (reference
    src/PeriodicSchurDecompositions.jl:322-1096): Francis double shifts,
    Ahues-Tisseur deflation (tightened eps^(1+4/16)), subdiagonal repair,
    1x1/2x2 deflation with dlanv2 standardization.  Returns
    (H, Z, w, ok): quasi-triangular real stack and complex eigenvalues.
    """
    p = len(H)
    n = len(H[0])
    ulp = mp.eps
    ulpx = ulp ** (mpf(1) + mpf(4) / 16)
    dat1, dat2 = mpf("0.75"), mpf("-0.4375")
    maxit = maxitfac * n
    if Z is None and want_z:
        Z = [_eye_mp_real(n) for _ in range(p)]
    w = [mpc(0)] * n

    if n == 1:
        lam = mpf(1)
        for f in range(p):
            lam *= H[f][0][0]
        return H, Z, [mpc(lam)], True

    hnorms = []
    for f in range(p):
        mx = mpf(0)
        for cc in range(n):
            scol = mp.fsum(abs(H[f][r][cc]) for r in range(n))
            mx = max(mx, scol)
        hnorms.append(ulp * n * mx)

    i, l, its, jiter = n - 1, 0, 1, 0
    while i >= 0:
        jiter += 1
        if jiter > maxit:
            return H, Z, w, False
        hdiag, hsub, hsup = _band_products_mp(H, l, i)

        # deflation scan (Ahues-Tisseur, tightened)
        lnew = l if i > l else i
        if i > l:
            for k in range(i, l, -1):
                hh11, hh12 = hdiag[k - 1], hsup[k - 1]
                hh21, hh22 = hsub[k], hdiag[k]
                tst1 = abs(hh11) + abs(hh22)
                if hh21 == 0:
                    lnew = k
                    break
                if abs(hh21) <= ulp * tst1:
                    ab = max(abs(hh21), abs(hh12))
                    ba = min(abs(hh21), abs(hh12))
                    aa = max(abs(hh22), abs(hh11 - hh22))
                    bb = min(abs(hh22), abs(hh11 - hh22))
                    ssum = aa + ab
                    if ba * (ab / ssum) <= ulpx * (bb * (aa / ssum)):
                        lnew = k
                        break

        # subdiagonal repair (reference :589-665)
        if lnew > 0 and p > 1:
            t1r = abs(H[0][lnew - 1][lnew - 1]) + abs(H[0][lnew][lnew])
            if abs(H[0][lnew][lnew - 1]) > ulp * t1r:
                for k in range(i, lnew - 1, -1):
                    for f in range(p - 1):
                        x = [H[f][k][k], H[f][k][k - 1]]
                        w2, tau, beta = _refl3_mp(x)
                        wv = [w2[1], mpf(1)]
                        H[f][k][k - 1] = mpf(0)
                        H[f][k][k] = beta
                        _refl_cols_mp(H[f], k - 1, wv, tau, r0=0, r1=k)
                        _refl_rows_mp(H[f + 1], k - 1, wv, tau, c0=k - 1)
                        if want_z:
                            _refl_cols_mp(Z[f + 1], k - 1, wv, tau)
                    if k < i:
                        Hl_ = H[p - 1]
                        x = [Hl_[k + 1][k + 1], Hl_[k + 1][k]]
                        w2, tau, beta = _refl3_mp(x)
                        wv = [w2[1], mpf(1)]
                        Hl_[k + 1][k] = mpf(0)
                        Hl_[k + 1][k + 1] = beta
                        _refl_cols_mp(Hl_, k, wv, tau, r0=0, r1=k + 1)
                        _refl_rows_mp(H[0], k, wv, tau, c0=k)
                        if want_z:
                            _refl_cols_mp(Z[0], k, wv, tau)
                H[p - 1][lnew][lnew - 1] = mpf(0)
        if lnew > 0:
            H[0][lnew][lnew - 1] = mpf(0)

        if lnew >= i - 1:
            if lnew == i:
                w[i] = mpc(hdiag[i])
            else:
                # explicit 2x2 product block
                hp11, hp12, hp22 = mpf(1), mpf(0), mpf(1)
                for f in range(1, p):
                    d1 = H[f][i - 1][i - 1]
                    d2 = H[f][i][i]
                    u = H[f][i - 1][i]
                    hp12 = hp11 * u + hp12 * d2
                    hp11 *= d1
                    hp22 *= d2
                a11 = H[0][i - 1][i - 1]
                a12 = H[0][i - 1][i]
                a21 = H[0][i][i - 1]
                a22 = H[0][i][i]
                bh11, bh12 = a11 * hp11, a11 * hp12 + a12 * hp22
                bh21, bh22 = a21 * hp11, a21 * hp12 + a22 * hp22
                aa, bb2, cc2, dd = bh11, bh12, bh21, bh22
                aa, bb2, cc2, dd, cs0, sn0, w1, w2v = _lanv2_mp(
                    aa, bb2, cc2, dd)
                lam_real = (cc2 == 0)
                w[i - 1] = w1
                w[i] = w2v

                jmin, jmax = -1, -1
                for f in range(1, p):
                    if abs(H[f][i - 1][i - 1]) <= hnorms[f] and jmin < 0:
                        jmin = f
                    if abs(H[f][i][i]) <= hnorms[f]:
                        jmax = f
                if jmin >= 0 and jmax >= 0:
                    if jmin <= p - jmax:
                        jmax = -1
                    else:
                        jmin = -1

                if jmin >= 1:
                    for f in range(jmin - 1):
                        x = [H[f][i][i], H[f][i][i - 1]]
                        w2, tau, beta = _refl3_mp(x)
                        wv = [w2[1], mpf(1)]
                        H[f][i][i - 1] = mpf(0)
                        H[f][i][i] = beta
                        _refl_cols_mp(H[f], i - 1, wv, tau, r0=0, r1=i)
                        _refl_rows_mp(H[f + 1], i - 1, wv, tau, c0=i - 1)
                        if want_z:
                            _refl_cols_mp(Z[f + 1], i - 1, wv, tau)
                else:
                    aA1 = abs(w1)
                    aA2 = abs(w2v)
                    amx, amn = max(aA1, aA2), min(aA1, aA2)
                    prod0 = (w1 == 0) or (w2v == 0)
                    replaceG = ((jmax >= 1) and lam_real) or prod0 or \
                        ((not prod0) and lam_real and amn < ulp * amx)
                    for _t in range(20):
                        if replaceG:
                            c, s, _ = _givens_r(H[0][i - 1][i - 1],
                                                H[0][i][i - 1])
                        else:
                            c, s = cs0, sn0
                        _rows2r(H[0], i - 1, c, s, lo=i - 1)
                        _cols2r(H[p - 1] if p > 1 else H[0], i - 1, c, s,
                                lo=0, hi=i + 1)
                        if want_z:
                            _cols2r(Z[0], i - 1, c, s)
                        for f in range(p - 1, 0, -1):
                            if f < jmax + 1:
                                continue
                            c2, s2, r = _givens_r(H[f][i - 1][i - 1],
                                                  H[f][i][i - 1])
                            H[f][i - 1][i - 1] = r
                            H[f][i][i - 1] = mpf(0)
                            _rows2r(H[f], i - 1, c2, s2, lo=i)
                            _cols2r(H[f - 1], i - 1, c2, s2, lo=0, hi=i + 1)
                            if want_z:
                                _cols2r(Z[f], i - 1, c2, s2)
                        sub = abs(H[0][i][i - 1])
                        if not replaceG or sub < ulp * amx:
                            break
                        replaceG = True
                    if jmax >= 0 or bh21 == 0:
                        H[0][i][i - 1] = mpf(0)
                    if jmax >= 1:
                        H[jmax][i][i - 1] = mpf(0)

                l1 = H[0][i - 1][i - 1]
                l2v = H[0][i][i]
                for f in range(1, p):
                    l1 *= H[f][i - 1][i - 1]
                    l2v *= H[f][i][i]
                if lam_real and abs(l1 - w1.real) > abs(l1 - w2v.real):
                    w[i - 1], w[i] = w[i], w[i - 1]
            i = lnew - 1
            l = 0
            its = 1
            continue

        # bulge chase
        l = lnew
        exc1 = its == 10
        exc2 = (its % 10 == 0) and not exc1
        exc = exc1 or exc2
        h44E = h33E = h43h34E = mpf(0)
        if exc:
            sE = (abs(hsub[min(l + 1, n - 1)]) + abs(hsub[min(l + 2, n - 1)])
                  ) if exc1 else (abs(hsub[i]) + abs(hsub[i - 1]))
            h44E = dat1 * sE + (hdiag[l] if exc1 else hdiag[i])
            h33E = h44E
            h43h34E = dat2 * sE * sE
        h44, h33 = hdiag[i], hdiag[i - 1]
        h43, h34 = hsub[i], hsup[i - 1]
        ssh = abs(h33) + abs(h34) + abs(h43) + abs(h44)
        if ssh == 0:
            rt1 = rt2 = mpc(0)
        else:
            h33n, h44n = h33 / ssh, h44 / ssh
            h34n, h43n = h34 / ssh, h43 / ssh
            trc = (h33n + h44n) / 2
            disc = (h33n - trc) * (h44n - trc) - h34n * h43n
            rtdisc = mp.sqrt(abs(disc))
            if disc >= 0:
                rt1 = mpc(trc, rtdisc) * ssh
                rt2 = mpc(trc, -rtdisc) * ssh
            else:
                r1v, r2v = trc + rtdisc, trc - rtdisc
                pick = r1v if abs(r1v - h44n) <= abs(r2v - h44n) else r2v
                rt1 = rt2 = mpc(pick * ssh)
        m = l
        h11, h12 = hdiag[m], hsup[m]
        h21 = hsub[min(m + 1, n - 1)]
        h22 = hdiag[min(m + 1, n - 1)]
        hsub_m2 = hsub[min(m + 2, n - 1)]
        if exc:
            h44s, h33s = h44E - h11, h33E - h11
            h21s = h21 if h21 != 0 else mpf(1)
            v1 = (h33s * h44s - h43h34E) / h21s + h12
            v2 = h22 - h11 - h33s - h44s
            v3 = hsub_m2
        else:
            sv = abs(h11 - rt2.real) + abs(rt2.imag) + abs(h21)
            if sv == 0:
                sv = mpf(1)
            h21s = h21 / sv
            v1 = h21s * h12 + (h11 - rt1.real) * ((h11 - rt2.real) / sv) - \
                rt1.imag * (rt2.imag / sv)
            v2 = h21s * (h11 + h22 - rt1.real - rt2.real)
            v3 = h21s * hsub_m2
        snorm = abs(v1) + abs(v2) + abs(v3)
        if snorm == 0:
            snorm = mpf(1)
        v0 = [v1 / snorm, v2 / snorm, v3 / snorm]

        for k in range(m, i):
            nr = min(3, i - k + 1)
            hi_r = min(k + 3, i) + 1
            if k > m:
                x = [H[0][k + t][k - 1] for t in range(nr)]
            else:
                x = v0[:nr]
            wv, tau, beta = _refl3_mp(x)
            if k > m:
                H[0][k][k - 1] = beta
                for t in range(1, nr):
                    H[0][k + t][k - 1] = mpf(0)
            _refl_rows_mp(H[0], k, wv, tau, c0=k)
            _refl_cols_mp(H[p - 1] if p > 1 else H[0], k, wv, tau,
                          r0=0, r1=hi_r)
            if want_z:
                _refl_cols_mp(Z[0], k, wv, tau)
            for f in range(p - 1, 0, -1):
                x = [H[f][k + t][k] for t in range(nr)]
                wv, tau, beta = _refl3_mp(x)
                H[f][k][k] = beta
                for t in range(1, nr):
                    H[f][k + t][k] = mpf(0)
                _refl_rows_mp(H[f], k, wv, tau, c0=k + 1)
                _refl_cols_mp(H[f - 1], k, wv, tau, r0=0, r1=hi_r)
                if want_z:
                    _refl_cols_mp(Z[f], k, wv, tau)
                if nr == 3:
                    x = [H[f][k + 1][k + 1], H[f][k + 2][k + 1]]
                    wv2, tau2, beta2 = _refl3_mp(x)
                    H[f][k + 1][k + 1] = beta2
                    H[f][k + 2][k + 1] = mpf(0)
                    _refl_rows_mp(H[f], k + 1, wv2, tau2, c0=k + 2)
                    _refl_cols_mp(H[f - 1], k + 1, wv2, tau2, r0=0, r1=hi_r)
                    if want_z:
                        _refl_cols_mp(Z[f], k + 1, wv2, tau2)
        its += 1

    for r in range(1, n):
        if w[r - 1].imag == 0:
            H[0][r][r - 1] = mpf(0)
    for f in range(1, p):
        for r in range(1, n):
            for cc in range(r):
                H[f][r][cc] = mpf(0)
    return H, Z, w, True


# --------------------------------------------------------------------------
# result type + driver

@dataclasses.dataclass(frozen=True)
class MpGeneralizedPeriodicSchur:
    """Generic-precision GPSD result (host object arrays of mpmath numbers).

    Same field/semantics layout as types.GeneralizedPeriodicSchur; Ts/Zs are
    numpy object arrays of shape (p, n, n), alpha mpc / beta {0,1} / scale
    int lists of length n.
    """

    S: Tuple[bool, ...]
    Ts: np.ndarray
    Zs: Optional[np.ndarray]
    alpha: list
    beta: list
    alphascale: list
    orientation: str = "R"
    schurindex: int = 0
    dps: int = 15

    @property
    def period(self) -> int:
        return int(self.Ts.shape[0])

    @property
    def values(self) -> list:
        # evaluate at the decomposition's own working precision (the
        # ambient mp.dps would silently round 40-digit eigenvalues to it)
        with mp.workdps(max(self.dps, mp.dps)):
            out = []
            for a, b, sc in zip(self.alpha, self.beta, self.alphascale):
                if b == 0:
                    # alpha = beta = 0 encodes 0/0 (indeterminate, like the
                    # f64 path's NaN), distinct from a true infinity
                    out.append(mpc(mp.nan) if a == 0 else mpc(mp.inf))
                else:
                    out.append(a * mpf(2) ** sc)
        return out


def pschur_mp(A, S: Optional[Sequence[bool]] = None, lr: str = "R",
              want_z: bool = True, maxitfac: int = 30,
              dps: Optional[int] = None, seed: int = 1234,
              complexify: bool = False) -> MpGeneralizedPeriodicSchur:
    """Arbitrary-precision periodic Schur decomposition (host, mpmath).

    The generic-eltype analogue of ``pschur`` (reference BigFloat path):
    ``dps`` sets the working precision in decimal digits (default: the
    ambient ``mpmath.mp.dps``).  REAL input with the all-positive
    signature keeps REAL arithmetic and a quasi-triangular Schur factor
    (2x2 blocks for complex pairs), matching the reference's generic real
    path (generic reflectors reference src/householder.jl:256-266,
    BigFloat tests reference test/runtests.jl:89-100); pass
    ``complexify=True`` to force the complex triangular decomposition
    instead.  Complex or signed input runs the complex core.  Returns an
    :class:`MpGeneralizedPeriodicSchur`; for the all-positive signature
    ``beta`` is identically 1 and ``values`` are the product eigenvalues.

    Reference: src/generalized.jl:87-148 (driver), :1085-1179 (generic
    reduction), :166-931 (eltype-generic core).
    """
    if not HAVE_MPMATH:  # pragma: no cover
        raise RuntimeError("mpmath is required for the generic-precision "
                           "path but is not importable")
    if hasattr(A, "detach"):  # a torch tensor, on any device
        A = A.detach().cpu().numpy()
    A = np.asarray(A)
    p = A.shape[0]
    if isinstance(S, str):
        # guard the pschur(A, lr, S=...) muscle-memory call shape:
        # a string in the S slot is an orientation
        S, lr = None, S
    if S is not None and len(S) != p:
        raise ValueError(f"signature length {len(S)} != cycle length {p}")
    S = (True,) * p if S is None else tuple(bool(x) for x in S)
    lr = str(lr).lstrip(":").upper()
    if lr not in ("R", "L"):
        raise ValueError("orientation must be 'R' or 'L'")
    if lr == "L":
        A = A[::-1]
        S = tuple(reversed(S))
    if not S[0]:
        raise ValueError("the leftmost signature entry must be +1 (True); "
                         "rotate the cycle so a direct factor leads")

    def _is_real_input(A):
        if A.dtype == object:
            # builtin Python complex counts as complex too: it is not an
            # mpc instance but _to_mp_real's mpf() would raise on it
            return not any(isinstance(A[l, i, j], (complex, mpc))
                           for l in range(A.shape[0])
                           for i in range(A.shape[1])
                           for j in range(A.shape[2]))
        return not np.iscomplexobj(A)

    real_path = (not complexify) and all(S) and _is_real_input(A)
    with mp.workdps(dps if dps is not None else mp.dps):
        if real_path:
            Hm = _to_mp_real(A)
            Hm, Qm = phessenberg_real_mp(Hm, want_q=want_z)
            Hm, Zm, wvals, ok = pqr_real_core_mp(
                Hm, Z=Qm, want_z=want_z, maxitfac=maxitfac)
            # decompose eigenvalues: alpha * 2^scale, |alpha| in [1,2)
            alpha, beta, scal = [], [], []
            for wv in wvals:
                a = abs(wv)
                if a == 0:
                    alpha.append(mpc(0))
                    beta.append(1)
                    scal.append(0)
                    continue
                e = int(mp.floor(mp.log(a, 2)))
                av = wv / mpf(2) ** e
                while abs(av) >= 2:
                    av /= 2
                    e += 1
                while abs(av) < 1:
                    av *= 2
                    e -= 1
                alpha.append(mpc(av))
                beta.append(1)
                scal.append(e)
        else:
            Hm = _to_mp(A)
            Hm, Qm = phessenberg_mp(Hm, S, want_q=want_z)
            Hm, Zm, alpha, beta, scal, ok = pqz_complex_core_mp(
                Hm, S, Z=Qm, want_z=want_z, maxitfac=maxitfac, seed=seed)
    if not ok:
        from ..types import ConvergenceFailure
        raise ConvergenceFailure(-1)

    def _obj(M):
        if M is None:
            return None
        return np.array([[[M[l][i][j] for j in range(len(M[0]))]
                          for i in range(len(M[0]))] for l in range(p)],
                        dtype=object)

    used_dps = dps if dps is not None else mp.dps
    P = MpGeneralizedPeriodicSchur(
        S=S, Ts=_obj(Hm), Zs=_obj(Zm), alpha=alpha, beta=beta,
        alphascale=scal, orientation="R", schurindex=0, dps=used_dps)
    if lr == "L":
        # same re-labeling as utils/circshift.rev_alias (reference
        # src/utils.jl:49-85): Z'[0] = Z[0]; Z'[l] = Z[p-l]
        Zs = P.Zs
        if Zs is not None:
            Zs = np.roll(Zs[::-1], 1, axis=0)
        P = MpGeneralizedPeriodicSchur(
            S=tuple(reversed(P.S)), Ts=P.Ts[::-1], Zs=Zs, alpha=P.alpha,
            beta=P.beta, alphascale=P.alphascale, orientation="L",
            schurindex=p - 1, dps=used_dps)
    return P
