"""Reordering kernels: cyclic Sylvester systems, BABD QR, adjacent-block swaps
(PyTorch port's copy of the JAX package's ``ops/reorder_np.py``).

Host-side (numpy) by design: eigenvalue reordering is a sequential chain of
tiny (m <= 4) accept/reject decisions with typed failure
(IllConditionedException), exactly the reference's L3 architecture
(src/sylvester.jl, src/babd.jl, src/sylswap.jl).  The O(n) row/column
applications per accepted swap are negligible next to the O(n^3) device
cores; batching swap *application* onto device is a later optimization.

All routines operate on LEFT orientation with the (quasi-)triangular Schur
factor at slot 0: ``Z[(l+1)%p]^H A[l] Z[l] = T[l]`` for direct factors.  A
2x2 (or (p1+p2)-sized) unitary ``Q[l]`` at slot l applies as

    T[l] <- T[l] @ Q[l]     (cols),      T[l-1] <- Q[l]^H @ T[l-1] (rows),
    Z[l] <- Z[l] @ Q[l],

with the two sides exchanged on inverted factors (S[l] False), matching the
reference's application pattern (src/sylswap.jl:131-148, 401-453).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..types import IllConditionedException


def _swap_log(msg: str) -> None:
    """Swap-rejection tracing on the ``sylswap`` verbosity channel (the
    reference warns on stability-test failures, src/sylswap.jl:126,308)."""
    from ..config import verbosity
    if verbosity("sylswap") >= 1:
        print(f"[sylswap] {msg}", flush=True)


# ---------------------------------------------------------------------------
# BABD QR (reference src/babd.jl, Granat et al. BIT 2007)


def babd_qr(Zd: List[np.ndarray], Zl: List[np.ndarray], y: np.ndarray):
    """QR factorization of a cyclic block-bidiagonal (BABD) matrix.

    Diagonal blocks Zd[0..K-1]; subdiagonal blocks Zl[0..K-2]; Zl[K-1] sits
    in the upper-right corner.  Returns (R, Zu, Zr, Qty).  Requires K >= 3
    (smaller systems go through the dense cyclic assembly — the corner
    block aliasing below silently degenerates for K <= 2).
    """
    K = len(Zl)
    if K < 3:
        raise ValueError("babd_qr requires K >= 3 blocks")
    m = Zl[0].shape[0]
    Zd = [np.array(d) for d in Zd]
    y = np.array(y)
    Zu = [np.zeros_like(Zl[0]) for _ in range(K)]
    Zr = [np.zeros_like(Zl[0]) for _ in range(K)]
    Zr[0] = np.array(Zl[K - 1])
    R = [np.zeros_like(Zl[0]) for _ in range(K)]
    i0 = 0
    for k in range(K - 1):
        if k == K - 2:
            # the right-border block of this row coincides with the
            # superdiagonal slot (the reference aliases Zr[K-1] to Zu[K-1])
            Zu[k] = Zr[k].copy()
        zs = np.vstack([Zd[k], Zl[k]])
        q, r = np.linalg.qr(zs, mode="complete")
        R[k] = r[:m]
        w = np.vstack([Zu[k], Zd[k + 1]])
        qz = q.conj().T @ w
        Zu[k] = qz[:m]
        Zd[k + 1] = qz[m:]
        if k < K - 2:
            w = np.vstack([Zr[k], Zr[k + 1]])
            qz = q.conj().T @ w
            Zr[k] = qz[:m]
            Zr[k + 1] = qz[m:]
        y[i0:i0 + 2 * m] = q.conj().T @ y[i0:i0 + 2 * m]
        i0 += m
    q, r = np.linalg.qr(Zd[K - 1], mode="complete")
    R[K - 1] = r[:m]
    y[i0:i0 + m] = q.conj().T @ y[i0:i0 + m]
    return R, Zu, Zr, y


def babd_solve(R, Zu, Zr, y):
    """Back substitution for :func:`babd_qr` (reference src/babd.jl:72-96)."""
    K = len(R)
    m = R[0].shape[0]
    y = np.array(y)
    x = np.zeros_like(y)
    i0 = (K - 1) * m
    x[i0:i0 + m] = np.linalg.solve(R[K - 1], y[i0:i0 + m])
    i1 = i0 - m
    yt = y[i1:i1 + m] - Zu[K - 2] @ x[i0:i0 + m]
    x[i1:i1 + m] = np.linalg.solve(R[K - 2], yt)
    xk = x[(K - 1) * m:K * m]
    for i in range(K - 2):
        ib = i * m
        y[ib:ib + m] = y[ib:ib + m] - Zr[i] @ xk
    i0 = (K - 2) * m
    for i in range(K - 3, -1, -1):
        i1 = i0 - m
        yt = y[i1:i1 + m] - Zu[i] @ x[i0:i0 + m]
        x[i1:i1 + m] = np.linalg.solve(R[i], yt)
        i0 -= m
    return x


# ---------------------------------------------------------------------------
# cyclic (generalized) periodic Sylvester solver (reference src/sylvester.jl)


def _spkron_blocks(A, B, S):
    """Cyclic block-bidiagonal Kronecker blocks of the signed Sylvester
    operator (reference src/sylvester.jl:89-121)."""
    K = len(A)
    p1 = A[0].shape[0]
    p2 = B[0].shape[0]
    e1 = np.eye(p1)
    e2 = np.eye(p2)
    Zd, Zl = [], []
    km = K - 1
    Zd.append(np.kron(B[km].T, -e1) if S[km] else np.kron(e2, A[km]))
    Zl.append(np.kron(e2, A[0]) if S[0] else np.kron(B[0].T, -e1))
    for k in range(K - 1):
        Zd.append(np.kron(B[k].T, -e1) if S[k] else np.kron(e2, A[k]))
        kn = k + 1
        Zl.append(np.kron(e2, A[kn]) if S[kn] else np.kron(B[kn].T, -e1))
    return Zd, Zl


def pgsylsolve(A, B, C, S) -> np.ndarray:
    """Solve the signed periodic Sylvester system.

    Direct factor k satisfies ``A[k] X[k] - X[k+1] B[k] = -C[k]`` (indices
    cyclic); inverted factors exchange the X roles (reference
    src/sylvester.jl:207-245).  Returns the stacked column-major
    vectorization (x1 | x2 | ... | xK) where block k+1 holds X[k] and block
    1 holds X[K-1]-shifted data, matching the reference's layout.
    """
    K = len(A)
    p1 = np.atleast_2d(A[0]).shape[0]
    p2 = np.atleast_2d(B[0]).shape[0]
    pp = p1 * p2
    A = [np.atleast_2d(a) for a in A]
    B = [np.atleast_2d(b) for b in B]
    C = [np.atleast_2d(c) for c in C]
    dt = np.result_type(*[a.dtype for a in A])
    Cv = np.zeros((pp, K), dtype=dt)
    Cv[:, 0] = -C[K - 1].reshape(pp, order="F")
    for k in range(K - 1):
        Cv[:, k + 1] = -C[k].reshape(pp, order="F")
    y = Cv.reshape(-1, order="F")
    Zd, Zl = _spkron_blocks(A, B, S)
    if K >= 3:
        R, Zu, Zr, yq = babd_qr(Zd, Zl, y)
        scale = max(max(np.abs(r).max() for r in R), 1e-300)
        for r in R:
            # a singular system leaves eps-scale (not exact-zero) pivots
            # after the QR rotations; an exact == 0 test lets them through
            # into overflowing back-substitution
            if np.any(np.abs(np.diag(r)) <=
                      np.finfo(np.float64).eps * scale):
                raise IllConditionedException()
        return babd_solve(R, Zu, Zr, yq)
    # dense cyclic Kronecker fallback for K <= 2
    # (block row k carries Zd[k] on the diagonal and Zl[(k-1) % K] in
    # column (k-1) % K — the corner for row 0)
    n = pp * K
    M = np.zeros((n, n), dtype=dt)
    for k in range(K):
        i0 = k * pp
        kl = (k - 1) % K
        j1 = kl * pp
        M[i0:i0 + pp, i0:i0 + pp] += Zd[k]
        if j1 == i0:
            M[i0:i0 + pp, i0:i0 + pp] += Zl[kl]
        else:
            M[i0:i0 + pp, j1:j1 + pp] += Zl[kl]
    try:
        return np.linalg.solve(M, y)
    except np.linalg.LinAlgError as exc:
        raise IllConditionedException() from exc


# ---------------------------------------------------------------------------
# small unitary helpers


def _givens_np(f, g):
    """Givens with the library convention: [c s; -s̄ c] [f g]^T = [r 0]^T."""
    f = complex(f) if np.iscomplexobj(np.asarray(f)) or \
        np.iscomplexobj(np.asarray(g)) else float(f)
    if g == 0:
        return 1.0, 0.0 * np.asarray(g).item(), f
    if f == 0:
        ag = abs(g)
        return 0.0, np.conj(g) / ag, ag
    if not (np.isfinite(abs(f)) and np.isfinite(abs(g))):
        raise IllConditionedException()
    d = float(np.hypot(abs(f), abs(g)))  # overflow-safe (|x|^2 can raise)
    c = abs(f) / d
    fs = f / abs(f)
    return c, fs * np.conj(g) / d, fs * d


def _gmat(c, s):
    """Left-action 2x2 of G(0, 1, c, s): [[c, s], [-s̄, c̄]]."""
    return np.array([[c, s], [-np.conj(s), np.conj(c)]])


def phess2x2(As: List[np.ndarray], S: Optional[Sequence[bool]] = None):
    """2x2 periodic Hessenberg reduction of a block cycle (left orientation).

    Behavioral contract from `_phess2x2!` (reference src/rpschur2x2.jl:
    326-359): triangularize blocks 1..k-1 by 2x2 unitaries, propagating into
    the following block (slot 0 absorbs the wrap-around and stays full).
    Returns (As, Qs): Qs[l] is the accumulated left transform at slot l
    (slot 1 stays identity; slot 0 receives the wrap-around transform).
    """
    k = len(As)
    dt = As[0].dtype
    As = [np.array(a) for a in As]
    Qs = [np.eye(2, dtype=dt) for _ in range(k)]

    def direct(l):
        return True if S is None else bool(S[l])

    for l in range(1, k):
        Al = As[l]
        if direct(l):
            c, s, _ = _givens_np(Al[0, 0], Al[1, 0])
            U = _gmat(c, s)                 # U @ Al annihilates [1,0]
            As[l] = U @ Al
        else:
            c, s, _ = _givens_np(Al[1, 1], Al[1, 0])
            V = _gmat(c, s)                 # Al @ V annihilates [1,0]
            As[l] = Al @ V
            U = V.conj().T
        lp = (l + 1) % k
        Qs[lp] = U @ Qs[lp]
        if direct(lp):
            As[lp] = As[lp] @ U.conj().T
        else:
            As[lp] = U @ As[lp]
    return As, Qs


# ---------------------------------------------------------------------------
# adjacent-block swaps (reference src/sylswap.jl)


def _apply_slot(Tfull, Zfull, Sfull, l, i1, m, Q, k):
    """Apply the slot-l unitary Q ((m, m)) to the full stacked arrays."""
    i3 = i1 + m
    lp = (l - 1) % k
    if Sfull[l]:
        Tfull[l][:, i1:i3] = Tfull[l][:, i1:i3] @ Q
    else:
        Tfull[l][i1:i3, :] = Q.conj().T @ Tfull[l][i1:i3, :]
    if Zfull is not None:
        Zfull[l][:, i1:i3] = Zfull[l][:, i1:i3] @ Q
    if Sfull[lp]:
        Tfull[lp][i1:i3, :] = Q.conj().T @ Tfull[lp][i1:i3, :]
    else:
        Tfull[lp][:, i1:i3] = Tfull[lp][:, i1:i3] @ Q


def swapadj1x1(T: List[np.ndarray], Z, S, i1, threshfac=20.0) -> bool:
    """Swap adjacent 1x1 blocks at (i1, i1+1) across the whole cycle.

    Behavioral contract from `_swapadj1x1g!` (reference src/sylswap.jl:
    542-764): solve the scalar cyclic (generalized) Sylvester system, build
    one Givens per factor, run the weak + strong stability tests on 2x2
    working copies, and only then apply to the full matrices.  Returns
    False (swap rejected) on a failed test.
    """
    k = len(T)
    i2 = i1 + 1
    dt = T[0].dtype
    eps = np.finfo(T[0].real.dtype).eps
    T11 = np.array([T[l][i1, i1] for l in range(k)])
    T12 = np.array([T[l][i1, i2] for l in range(k)])
    T22 = np.array([T[l][i2, i2] for l in range(k)])
    thresh = max(threshfac * np.sqrt(
        np.linalg.norm(T11) ** 2 + np.linalg.norm(T12) ** 2
        + np.linalg.norm(T22) ** 2) * eps, np.finfo(T[0].real.dtype).tiny)
    Txx = [np.array([[T11[l], T12[l]], [0.0, T22[l]]], dtype=dt)
           for l in range(k)]
    if k > 1:
        Xv = pgsylsolve([np.atleast_2d(T11[l]) for l in range(k)],
                        [np.atleast_2d(T22[l]) for l in range(k)],
                        [np.atleast_2d(T12[l]) for l in range(k)], S)
    else:
        # single-factor case: LAPACK trexc-style rotation
        c, s, _ = _givens_np(T12[0], T22[0] - T11[0])
        G = _gmat(c, s).conj().T
        Txx[0] = G.conj().T @ Txx[0] @ G
        ws = abs(Txx[0][1, 0])
        if ws > thresh:
            _swap_log(f"1x1 swap at {i1} rejected (k=1 weak test "
                      f"{ws:.2e} > {thresh:.2e})")
            return False
        T[0][:, i1:i1 + 2] = T[0][:, i1:i1 + 2] @ G
        T[0][i1:i1 + 2, :] = G.conj().T @ T[0][i1:i1 + 2, :]
        if Z is not None:
            Z[0][:, i1:i1 + 2] = Z[0][:, i1:i1 + 2] @ G
        T[0][i2, i1] = 0.0
        return True

    # build per-slot rotations from the Sylvester solution
    # (direct: slot matrix is G' from givens(X[l], 1); inverted: the
    # reversed Givens(1,0,c,s̄) from givens(-X[l], 1) collapses to _gmat —
    # reference src/sylswap.jl:661-687)
    Qm = []
    for l in range(k):
        if S[l]:
            c, s, _ = _givens_np(Xv[l], 1.0)
            Q = _gmat(c, s).conj().T
        else:
            c, s, _ = _givens_np(-Xv[l], 1.0)
            Q = _gmat(c, s)
        Qm.append(Q)

    # trial application on the 2x2 working copies
    for l in range(k):
        lp = (l - 1) % k
        if S[l]:
            Txx[l] = Txx[l] @ Qm[l]
        else:
            Txx[l] = Qm[l].conj().T @ Txx[l]
        if S[lp]:
            Txx[lp] = Qm[l].conj().T @ Txx[lp]
        else:
            Txx[lp] = Txx[lp] @ Qm[l]
    ws = sum(abs(Txx[l][1, 0]) for l in range(k))
    # NOT (ws <= thresh): an overflowed Sylvester solution yields NaN
    # rotations, and 'ws > thresh' is False for NaN — the corrupted swap
    # would be ACCEPTED
    if not (ws <= thresh):
        _swap_log(f"1x1 swap at {i1} rejected (weak test "
                  f"{ws:.2e} !<= {thresh:.2e})")
        return False
    # strong test: reconstruct the original blocks
    ss = 0.0
    for l in range(k):
        l1 = (l + 1) % k
        if S[l]:
            Trec = Qm[l1] @ Txx[l] @ Qm[l].conj().T
        else:
            Trec = Qm[l] @ Txx[l] @ Qm[l1].conj().T
        Torig = np.array([[T11[l], T12[l]], [0.0, T22[l]]], dtype=dt)
        ss = np.hypot(ss, np.linalg.norm(Trec - Torig))
    if not (ss <= thresh):
        _swap_log(f"1x1 swap at {i1} rejected (strong test "
                  f"{ss:.2e} !<= {thresh:.2e})")
        return False

    for l in range(k):
        _apply_slot(T, Z, S, l, i1, 2, Qm[l], k)
    T[0][i2, i1] = 0.0
    for l in range(1, k):
        T[l][i2, i1] = 0.0
    return True


def swapadjqr(T: List[np.ndarray], Z, S, i1, p1, p2, tol=100.0) -> bool:
    """Swap adjacent blocks of sizes (p1, p2) at i1 across the cycle.

    Behavioral contract from `_swapadjqr!` (reference src/sylswap.jl:14-157
    standard, :197-538 generalized): solve the block periodic Sylvester
    system, per slot compute QR of [X; I] (direct previous factor) or RQ of
    [I -X] (inverted), trial-apply on working copies, repair 2x2 fill-in
    via the small periodic Hessenberg reduction, run the strong stability
    test, and apply to the full matrices only on acceptance.
    """
    k = len(T)
    dt = T[0].dtype
    eps = np.finfo(T[0].real.dtype).eps
    i2 = i1 + p1
    i2new = i1 + p2
    i3 = i2 + p2 - 1
    m = p1 + p2
    T11 = [T[l][i1:i2, i1:i2] for l in range(k)]
    T12 = [T[l][i1:i2, i2:i3 + 1] for l in range(k)]
    T22 = [T[l][i2:i3 + 1, i2:i3 + 1] for l in range(k)]
    tnrm = np.sqrt(sum(np.linalg.norm(T[l][i1:i3 + 1, i1:i3 + 1]) ** 2
                       for l in range(k)))
    thresh = max(np.finfo(T[0].real.dtype).tiny, tol * eps * tnrm)
    Xv = pgsylsolve(T11, T22, T12, S)
    pp = p1 * p2
    Txx = [np.block([[T11[l], T12[l]],
                     [np.zeros((p2, p1), dtype=dt), T22[l]]])
           for l in range(k)]

    # per-slot unitaries: slot l uses the Sylvester block associated with
    # the PREVIOUS factor's sign (reference src/sylswap.jl:249-301)
    Qs = []
    for l in range(k):
        X = Xv[l * pp:(l + 1) * pp].reshape(p1, p2, order="F")
        sp = S[(l - 1) % k]
        if sp:
            Xi = np.vstack([X, np.eye(p2, dtype=dt)])
            q, _ = np.linalg.qr(Xi, mode="complete")
        else:
            # RQ of [I -X] via the flipped-LQ trick: B = R Q with R
            # upper-trapezoidal in the trailing columns; the slot matrix is
            # Q^H (reference src/sylswap.jl:290-299)
            B = np.hstack([np.eye(p1, dtype=dt), -X])
            q2, _ = np.linalg.qr(B[::-1, ::-1].conj().T, mode="complete")
            Qfull = q2.conj().T[::-1, ::-1]
            q = Qfull.conj().T
        Qs.append(q)

    # trial application on working copies
    for l in range(k):
        lp = (l - 1) % k
        if S[l]:
            Txx[l] = Txx[l] @ Qs[l]
        else:
            Txx[l] = Qs[l].conj().T @ Txx[l]
        if S[lp]:
            Txx[lp] = Qs[l].conj().T @ Txx[lp]
        else:
            Txx[lp] = Txx[lp] @ Qs[l]

    # weak test: block subdiagonal must vanish (NOT 'ws > thresh': an
    # overflowed Sylvester solution yields NaN transforms and the
    # comparison would be False, ACCEPTING the corrupted swap)
    ws = max(np.linalg.norm(Txx[l][p2:m, 0:p2]) for l in range(k))
    if not (ws <= thresh):
        _swap_log(f"({p1},{p2}) swap at {i1} rejected (weak test "
                  f"{ws:.2e} !<= {thresh:.2e})")
        return False

    # fill-in detection + repair (2x2 blocks may come back non-triangular)
    # slot 0 legitimately carries a nonzero [1,0] for a complex-pair
    # block; only the triangular slots 1..k-1 signal fill-in
    fill1 = p2 > 1 and k > 1 and any(
        abs(Txx[l][1, 0]) > thresh for l in range(1, k))
    ii = p2
    fill2 = p1 > 1 and k > 1 and any(abs(Txx[l][ii + 1, ii]) > thresh
                                     for l in range(1, k))
    Ws = None
    if fill1 or fill2:
        Ws = [np.eye(m, dtype=dt) for _ in range(k)]
        for (flag, j0) in ((fill1, 0), (fill2, p2)):
            if not flag:
                continue
            blocks = [Txx[l][j0:j0 + 2, j0:j0 + 2] for l in range(k)]
            _, Hq = phess2x2(blocks, S)
            for l in range(k):
                lp = (l - 1) % k
                # phess2x2's slot transforms satisfy u_l = Hq[l]^H in this
                # function's slot convention (left orientation: u_l acts on
                # the right of factor l and as u_l^H on the left of factor
                # l-1); applying Hq[l] untransposed rotates the wrong way,
                # leaves the 2x2 diagonal blocks of the triangular factors
                # non-triangular, and the final triu scrub then silently
                # corrupts the decomposition (caught by the mkrps fixture)
                q = Hq[l].conj().T
                if S[l]:
                    Txx[l][:, j0:j0 + 2] = Txx[l][:, j0:j0 + 2] @ q
                else:
                    Txx[l][j0:j0 + 2, :] = q.conj().T @ Txx[l][j0:j0 + 2, :]
                if S[lp]:
                    Txx[lp][j0:j0 + 2, :] = q.conj().T @ Txx[lp][j0:j0 + 2, :]
                else:
                    Txx[lp][:, j0:j0 + 2] = Txx[lp][:, j0:j0 + 2] @ q
                Ws[l][:, j0:j0 + 2] = Ws[l][:, j0:j0 + 2] @ q

    # structural test: the triangular factors' windows must actually be
    # triangular now (the scrub below deletes anything left; deleting more
    # than roundoff would corrupt the decomposition, so reject instead)
    junk = max(np.abs(np.tril(Txx[l], -1)).max() for l in range(1, k)) \
        if k > 1 else 0.0
    if not (junk <= 10 * thresh):
        _swap_log(f"({p1},{p2}) swap at {i1} rejected (structural test "
                  f"{junk:.2e} !<= {10 * thresh:.2e})")
        return False

    # strong test: reconstruct original window
    ss = 0.0
    for l in range(k):
        l1 = (l + 1) % k
        Tl = Txx[l]
        if Ws is not None:
            if S[l]:
                Tl = Ws[l1] @ Tl @ Ws[l].conj().T
            else:
                Tl = Ws[l] @ Tl @ Ws[l1].conj().T
        if S[l]:
            Trec = Qs[l1] @ Tl @ Qs[l].conj().T
        else:
            Trec = Qs[l] @ Tl @ Qs[l1].conj().T
        ss = max(ss, np.linalg.norm(Trec - T[l][i1:i3 + 1, i1:i3 + 1]))
    if not (ss <= thresh):
        _swap_log(f"({p1},{p2}) swap at {i1} rejected (strong test "
                  f"{ss:.2e} !<= {thresh:.2e})")
        return False

    # accepted: apply to the full matrices
    for l in range(k):
        _apply_slot(T, Z, S, l, i1, m, Qs[l], k)
        if Ws is not None:
            _apply_slot(T, Z, S, l, i1, m, Ws[l], k)
    # scrub
    T[0][i2new:i3 + 1, i1:i2new] = 0.0
    for l in range(1, k):
        blk = T[l][i1:i3 + 1, i1:i3 + 1]
        T[l][i1:i3 + 1, i1:i3 + 1] = np.triu(blk)
    return True


# ---------------------------------------------------------------------------
# iterative 2x2 periodic eigenvalue solver (MB03BB semantics)


def rpeigvals2x2_np(W, S, maxit: int = 80, seed: int = 1903):
    """Eigenvalues of ``prod_l W[l]^{s_l}`` for a 2x2 block cycle by
    ITERATIVE complex single-shift periodic QZ.

    Behavioral contract from the reference's `_rpeigvals2x2` (MB03BB
    translation, src/rpschur2x2.jl:9-235): complexify the cycle,
    triangularize all blocks but the leading one, run single-shift QZ
    sweeps (ad-hoc random restart shifts every 10 iterations) until the
    leading block's subdiagonal is negligible, then read the eigenvalues
    as scaled signed diagonal products.

    Args:
      W: sequence of p (2, 2) real or complex blocks (product order).
      S: signature sequence (True direct, False inverted).

    Returns ((w1, s1), (w2, s2), beta, converged): eigenvalues
    ``w_j * 2^{s_j}`` (complex mantissa, int exponent), ``beta`` 0 flags a
    singular inverted factor, ``converged`` False when the 80-sweep budget
    ran out (caller falls back to the one-shot product).
    """
    p = len(W)
    B = [np.asarray(w, complex).copy() for w in W]
    eps = np.finfo(float).eps
    rng = np.random.default_rng(seed)

    # stage 1: W'[l] = Q[l]^H W[l] Q[l+1] (direct) / Q[l+1]^H W[l] Q[l]
    # (inverted) upper triangular for l >= 1, with Q[0] = I
    Qnext = np.eye(2, dtype=complex)
    for l in range(p - 1, 0, -1):
        if S[l]:
            M = B[l] @ Qnext
            Q, R = np.linalg.qr(M)
            B[l] = Q.conj().T @ M
            Qnext = Q
        else:
            M = Qnext.conj().T @ B[l]
            # RQ: M = R Q^H  via QR of the reversed-transposed matrix
            Jr = np.array([[0.0, 1.0], [1.0, 0.0]])
            Qt, Rt = np.linalg.qr((Jr @ M).conj().T)
            # M (Qt Jr) = Jr Rt^H Jr = upper triangular (NO extra conj:
            # the spurious conjugation left B[l] @ Q non-triangular for
            # complex inverted factors and the forced [1,0] = 0 then
            # deleted an O(1) entry)
            Q = Qt @ Jr
            B[l] = M @ Q
            Qnext = Q
        B[l][1, 0] = 0.0
    B[0] = B[0] @ Qnext

    def conv():
        b0 = B[0]
        return abs(b0[1, 0]) <= max(
            eps * (abs(b0[0, 0]) + abs(b0[1, 1])), 1e-290)

    it = 0
    while not conv() and it < maxit:
        it += 1
        # shift rotation (mirror of ops/pqz_complex.act_sweep, n=2)
        c, s, _ = _givens_np(1.0 + 0j, 1.0 + 0j)
        if it % 10 == 0:
            fr = rng.standard_normal(4)
            c, s, _ = _givens_np(fr[0] + 1j * fr[1], fr[2] + 1j * fr[3])
        else:
            for l in range(p - 1, 0, -1):
                hf, hl = B[l][0, 0], B[l][1, 1]
                if S[l]:
                    c, s, _ = _givens_np(hf * c, hl * np.conj(s))
                else:
                    c, s, _ = _givens_np(hl * c, -hf * np.conj(s))
                    s = -s
            b0 = B[0]
            c, s, _ = _givens_np(b0[0, 0] * c - b0[1, 1] * np.conj(s),
                                 b0[1, 0] * c)

        # one sweep step (k = 0)
        B[0] = _gmat(c, s) @ B[0]
        for l in range(p - 1, 0, -1):
            if S[l]:
                B[l] = B[l] @ _gmat(c, s).conj().T
                c, s, _ = _givens_np(B[l][0, 0], B[l][1, 0])
                B[l] = _gmat(c, s) @ B[l]
                B[l][1, 0] = 0.0
            else:
                B[l] = _gmat(c, s) @ B[l]
                c, s, r = _givens_np(B[l][1, 1], B[l][1, 0])
                B[l][:1, :] = B[l][:1, :] @ _gmat(c, s)
                B[l][1, 1] = r
                B[l][1, 0] = 0.0
                s = -s
        B[0] = B[0] @ _gmat(c, s).conj().T

    converged = conv()
    if not converged:
        # ``r2x2`` channel: the reference's _rpeigvals2x2 prints its punt
        # on non-convergence (src/rpschur2x2.jl:2,5 + verbosity ref)
        from ..config import verbosity
        if verbosity("r2x2") >= 1:
            print(f"[r2x2] 2x2 periodic QZ did not converge in {maxit} "
                  f"sweeps (residual {abs(B[0][1, 0]):.2e}); caller falls "
                  f"back to the one-shot product", flush=True)
    if converged:
        B[0][1, 0] = 0.0
    beta = 1.0
    out = []
    for j in range(2):
        alpha, sc = 1.0 + 0j, 0
        for l in range(p):
            x = B[l][j, j]
            if S[l]:
                alpha = alpha * x
            else:
                if x == 0:
                    beta = 0.0
                else:
                    alpha = alpha / x
            a = abs(alpha)
            if a == 0:
                sc = 0
            else:
                e = int(np.frexp(a)[1])
                alpha = alpha * 2.0 ** (1 - e)
                sc += e - 1
        out.append((alpha, sc))
    return out[0], out[1], beta, converged
