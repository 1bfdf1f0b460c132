"""Periodic Krylov-Schur: a few exterior eigenvalues of large cyclic products
(port of ``models/krylov.py``).

Behavioral contract from the reference's `partial_pschur` (src/krylov.jl, a
Kressner Numer. Math. 2006 scheme): build p coupled orthonormal bases with a
periodic Arnoldi process (one operator application per factor per step,
iterated Gram-Schmidt with the 1/sqrt(2) re-orthogonalization test), solve
the small projected periodic Schur problem, estimate Ritz residuals per
candidate, lock converged wanted pairs, purge converged unwanted ones,
truncate, restore the Hessenberg structure with a row-wise periodic
reduction that preserves the Arnoldi "foot", and restart.  Left orientation
only (like the reference).

Architecture: the operator applications and the Gram-Schmidt run where the
operator lives, through ``parallel.krylov_ops.CycleOps`` (on a tensor on
the card: on the card, with a mirror of the bases there).  The restart loop
and all O(k^2 p) bookkeeping run on the host in numpy, with the host basis
as the source of truth: each accepted column comes back once, and any host
repair reloads the mirror.  The projected problem is solved by the native
C++ window Schurs (``native.py``), and reordered by the port's
``ordschur``, on the host.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import native
from ..config import default_config, verbosity
from ..ops.pqr_real import pqr_real_core
from ..ops.pqz_complex import pqz_complex_core
from ..ops.reorder_np import _givens_np, _gmat, pgsylsolve
from ..parallel.krylov_ops import CycleOps
from ..types import (ConvergenceFailure, IllConditionedException,
                     PartialPeriodicSchur, PeriodicSchur, PKSFailure)
from ..utils.io import load_krylov_state, save_krylov_state
from .drivers import _stack, _target
from .ordschur import ordschur

# default iterated-Gram-Schmidt re-orthogonalization threshold; the live
# value comes from AlgoConfig.eta_orth (reference src/krylov.jl:150)
ETA_ORTH = 1.0 / np.sqrt(2.0)


@dataclasses.dataclass
class ArnoldiHistory:
    """Iteration summary (reference uses ArnoldiMethod.History).

    ``timings`` decomposes the wall-clock into phases (seconds): arnoldi
    (operator applications + iterated CGS, on the operator's device, and
    the host reads of their results), small_schur (host projected
    solves), residuals, reorder_writeback (trial reorders + basis
    writeback), verify_locks, total.  ``host_reads``: reads from the
    operator's device to the host (each a synchronisation).
    """
    nprods: int
    nconverged: int
    converged: bool
    nev: int
    timings: Optional[dict] = None
    host_reads: int = 0


# ---------------------------------------------------------------------------
# ordering targets


def _order_key(which: str):
    which = which.upper()
    if which == "LM":
        return lambda lam: -abs(lam)
    if which == "SM":
        return lambda lam: abs(lam)
    if which == "LR":
        return lambda lam: -lam.real
    if which == "SR":
        return lambda lam: lam.real
    if which == "LI":
        return lambda lam: -lam.imag
    if which == "SI":
        return lambda lam: lam.imag
    raise ValueError(f"unknown target {which!r}; use LM/SM/LR/SR/LI/SI")


# ---------------------------------------------------------------------------
# operators


def _as_ops(A, n=None, dtype=None, device=None):
    """``CycleOps`` of the input, its p and n, and the numpy dtype of the
    computation (float64 or complex128)."""
    if hasattr(A, "apply_orth"):
        ops = A  # a device-resident cycle (CycleOps or one with its methods)
    elif isinstance(A, (list, tuple)) and len(A) and callable(A[0]):
        if n is None or dtype is None:
            raise ValueError("matrix-free operators need n= and dtype= arguments")
        cplx = (dtype.is_complex if isinstance(dtype, torch.dtype)
                else np.issubdtype(np.dtype(dtype), np.complexfloating))
        ops = CycleOps(A, n=n, dtype=torch.complex128 if cplx else torch.float64,
                       device=_target(device))
    elif isinstance(A, torch.Tensor) or hasattr(A, "ndim") or (
            isinstance(A, (list, tuple)) and len(A) and hasattr(A[0], "ndim")):
        ops = CycleOps(_stack(A, device))
    else:
        raise TypeError("A must be a (p, n, n) stack, list of matrices, or "
                        "list of callables")
    npdt = np.complex128 if ops.dtype.is_complex else np.float64
    return ops, ops.p, ops.n, np.dtype(npdt)


# ---------------------------------------------------------------------------
# periodic Arnoldi (reference src/krylov.jl:228-414)


class _PKrylov:
    def __init__(self, p, n, kmax, dtype, rng, vrand=None):
        self.p, self.n, self.kmax = p, n, kmax
        self.V = [np.zeros((n, kmax + 1), dtype)] + \
            [np.zeros((n, kmax), dtype) for _ in range(p - 1)]
        self.B = [np.zeros((kmax, kmax), dtype) for _ in range(p - 1)] + \
            [np.zeros((kmax + 1, kmax), dtype)]
        self.k = 0
        self.rng = rng
        self.dtype = np.dtype(dtype)
        self._vrand = vrand

    def vrand(self, shape):
        """Restart-vector filler; user-injectable like the reference's
        ``vrand!`` keyword (src/krylov.jl:454)."""
        if self._vrand is not None:
            return np.asarray(self._vrand(shape), dtype=self.dtype)
        v = self.rng.standard_normal(shape)
        if np.issubdtype(self.dtype, np.complexfloating):
            v = v + 1j * self.rng.standard_normal(shape)
        return v.astype(self.dtype)


def _orth_step(U, v, eta: float = ETA_ORTH):
    """One iterated-CGS orthogonalization on the host; returns (h, v,
    wnorm, in_span).  ``CycleOps.apply_orth`` is its device form."""
    rnorm = np.linalg.norm(v)
    h = U.conj().T @ v
    v = v - U @ h
    w = np.linalg.norm(v)
    if w < eta * rnorm:
        rnorm = w
        corr = U.conj().T @ v
        v = v - U @ corr
        h = h + corr
        w = np.linalg.norm(v)
    return h, v, w, w <= eta * rnorm


def _reinitialize(PK: _PKrylov, l: int, j: int,
                  eta: float = ETA_ORTH) -> bool:
    """Random re-start of basis column j of slot l, orthogonalized
    (reference :152-181)."""
    if verbosity("krylov") >= 1:
        print(f"[krylov] breakdown: reinitializing basis column {j} "
              f"of slot {l} with a random vector", flush=True)
    v = PK.vrand(PK.n)
    if j > 0:
        _, v, w, inspan = _orth_step(PK.V[l][:, :j], v, eta)
        if inspan:
            return False
        v = v / w
    else:
        v = v / np.linalg.norm(v)
    PK.V[l][:, j] = v
    return True


def periodic_arnoldi(ops: CycleOps, PK: _PKrylov, k1: int, k2: int, u: np.ndarray,
                     tol1: float, eta: float = ETA_ORTH) -> bool:
    """Extend the periodic Krylov decomposition to columns [k1, k2).

    0-based: fills columns k1..k2-1.  Returns False after too many
    singularity repairs (reference's 5-strike budget, :396-407).  Each
    step is one operator application and CGS on the operator's device
    (``ops.apply_orth``), its coefficients read back once and the
    accepted column once.
    """
    p, n = PK.p, PK.n
    PK.V[0][:, k1] = u
    ops.load_basis(PK.V)
    j = k1
    singularities = 0
    while j < k2:
        ldef, jdef = -1, -1
        null1 = False
        for l in range(p - 1):
            if j > 0:
                h, w, inspan = ops.apply_orth(l, l + 1, j, j, eta)
                PK.B[l][:j, j] = h
            else:
                w = ops.apply_norm(l, j)
                inspan = False
                if w < tol1:
                    null1 = True
                    break
            if inspan:
                if ldef < 0:
                    ldef, jdef = l, j
                PK.B[l][j, j] = 0.0
                if not _reinitialize(PK, l + 1, j, eta):
                    raise PKSFailure("Arnoldi reinitialization failed")
                ops.load_basis(PK.V)
            else:
                PK.B[l][j, j] = w
                PK.V[l + 1][:, j] = ops.accept(l + 1, j, w)
        if null1:
            # the reference's 5-strike singularity budget applies here too:
            # an operator whose image of EVERY restart vector stays below
            # tol1 must fail instead of retrying forever
            singularities += 1
            if singularities > 5:
                return False
            if not _reinitialize(PK, 0, 0, eta):
                raise PKSFailure("Arnoldi reinitialization failed")
            ops.load_basis(PK.V)
            continue

        h, w, inspan = ops.apply_orth(p - 1, 0, j, j + 1, eta)
        PK.B[p - 1][:j + 1, j] = h
        if inspan:
            PK.B[p - 1][j + 1, j] = 0.0
            # restart the next column randomly; when an in-cycle
            # deflation is also pending (ldef >= 0) the column STILL needs
            # fresh data
            if not _reinitialize(PK, 0, j + 1, eta):
                if j + 1 >= n and j == k2 - 1:
                    # complete-basis lucky breakdown: V[0] spans the whole
                    # space (maxdim == n requested), so the decomposition
                    # closes EXACTLY with a zero foot entry and the ghost
                    # head column stays zero (its every use multiplies the
                    # zero foot).  The reference throws PKSFailure here
                    # (src/krylov.jl:362 -> :181), but a full-space request
                    # is legitimate and must terminate with the complete
                    # decomposition instead.
                    PK.k = j + 1
                    return True
                raise PKSFailure("Arnoldi reinitialization failed")
            ops.load_basis(PK.V)
        else:
            PK.B[p - 1][j + 1, j] = w
            PK.V[0][:, j + 1] = ops.accept(0, j + 1, w)

        if ldef >= 0:
            # exact deflation inside the cycle: rotate the zero out
            _deflate_krylov(PK, ldef, jdef)
            hn = np.linalg.norm(PK.B[p - 1][:jdef + 1, :jdef + 1])
            if abs(PK.B[p - 1][jdef + 1, jdef]) >= 100 * np.finfo(
                    PK.V[0].real.dtype).eps * max(hn, 1e-300):
                singularities += 1
                if singularities > 5:
                    return False
                if jdef + 1 < k2:
                    if not _reinitialize(PK, 0, jdef + 1, eta):
                        raise PKSFailure("Arnoldi reinitialization failed")
            ops.load_basis(PK.V)
        PK.k = j + 1
        j += 1
    return True


def _deflate_krylov(PK: _PKrylov, ldef: int, jdef: int):
    """Unshifted half-sweep pushing an in-cycle zero to the foot
    (reference `_deflate!`, src/krylov.jl:184-226)."""
    p = PK.p
    nwid = jdef + 1
    Bp = PK.B[p - 1]
    G = []
    for j in range(jdef):
        c, s, _ = _givens_np(Bp[j, j], Bp[j + 1, j])
        M = _gmat(c, s)
        Bp[j:j + 2, :] = M @ Bp[j:j + 2, :]
        Bp[j + 1, j] = 0.0
        G.append(M)
    Z = [np.eye(nwid, dtype=PK.dtype) for _ in range(p)]
    for j in range(jdef):
        Z[0][:, j:j + 2] = Z[0][:, j:j + 2] @ G[j].conj().T
    for l in range(p - 1):
        Bl = PK.B[l]
        for j in range(jdef):
            Bl[:, j:j + 2] = Bl[:, j:j + 2] @ G[j].conj().T
            c, s, _ = _givens_np(Bl[j, j], Bl[j + 1, j])
            M = _gmat(c, s)
            Bl[j:j + 2, :] = M @ Bl[j:j + 2, :]
            Bl[j + 1, j] = 0.0
            G[j] = M
        for j in range(jdef):
            Z[l + 1][:, j:j + 2] = Z[l + 1][:, j:j + 2] @ G[j].conj().T
    for j in range(jdef - 1):
        Bp[:, j:j + 2] = Bp[:, j:j + 2] @ G[j].conj().T
    for l in range(p):
        w = PK.V[l][:, :nwid] @ Z[l][:nwid, :nwid]
        PK.V[l][:, :nwid] = w


# ---------------------------------------------------------------------------
# row-wise periodic Hessenberg restoration (reference src/rhessx.jl)


def _unitary_row_annihilator(u):
    """Hermitian unitary R with R @ u = phase * |u| * e_last."""
    m = len(u)
    nu = np.linalg.norm(u)
    if nu == 0:
        return np.eye(m, dtype=u.dtype)
    phase = u[-1] / abs(u[-1]) if u[-1] != 0 else 1.0
    t = np.zeros(m, dtype=complex if np.iscomplexobj(u) else float)
    t[-1] = phase * nu
    w = u - t
    wn = np.vdot(w, w).real
    if wn < np.finfo(float).tiny:
        return np.eye(m, dtype=u.dtype)
    return (np.eye(m) - 2.0 * np.outer(w, np.conj(w)) / wn).astype(u.dtype)


def _restore_hessenberg(PK: _PKrylov, active: int, k: int):
    """Row-wise left-oriented periodic Hessenberg reduction on the window
    [active, k) that preserves the Arnoldi foot (reference `_rphessenberg!`
    semantics: row reflectors annihilate LEADING entries)."""
    p = PK.p
    a = active
    Bp = PK.B[p - 1]
    nwrk = k - a
    Q = [np.eye(nwrk, dtype=PK.dtype) for _ in range(p)]

    def apply_w(slot, hi, W):
        """W acts on window-columns [0, hi) of the slot's B and the rows of
        the previous slot's B; accumulate into Q[slot]."""
        prev = (slot - 1) % p
        Bs = PK.B[slot]
        Bs[:, a:a + hi] = Bs[:, a:a + hi] @ W
        Bprev = PK.B[prev]
        Bprev[a:a + hi, :] = W.conj().T @ Bprev[a:a + hi, :]
        Q[slot][:, :hi] = Q[slot][:, :hi] @ W

    # foot row of the Hessenberg slot (if the window touches it)
    if k == PK.k:
        u = np.conj(Bp[k, a:k])
        W = _unitary_row_annihilator(u)
        apply_w(p - 1, nwrk, W)
        Bp[k, a:k - 1] = 0.0
    for i in range(nwrk - 1, 0, -1):
        # triangularize rows i of the triangular slots
        for l in range(p - 2, -1, -1):
            u = np.conj(PK.B[l][a + i, a:a + i + 1])
            W = _unitary_row_annihilator(u)
            apply_w(l, i + 1, W)
            PK.B[l][a + i, a:a + i] = 0.0
        u = np.conj(Bp[a + i, a:a + i])
        W = _unitary_row_annihilator(u)
        apply_w(p - 1, i, W)
        Bp[a + i, a:a + i - 1] = 0.0
    # apply the accumulated Q to the bases; the locked coupling rows were
    # already transformed inside apply_w (its column updates span ALL rows
    # of B), so they must not be transformed a second time here
    for l in range(p):
        PK.V[l][:, a:k] = PK.V[l][:, a:k] @ Q[l]


# ---------------------------------------------------------------------------
# driver


def _small_ps(T, Z, values) -> PeriodicSchur:
    return PeriodicSchur(Ts=torch.as_tensor(T), Zs=torch.as_tensor(Z),
                         values=torch.as_tensor(np.asarray(values, np.complex128)),
                         orientation="R", schurindex=0)


def _small_pschur(B: List[np.ndarray], active: int, kmax: int, dtype) -> PeriodicSchur:
    """Dense periodic Schur of the projected window (right-ordered stack),
    on the host: the native C++ window Schurs, and where they do not
    converge (or the complex one declines) the port's cores on a CPU
    tensor, as the JAX package falls back to its jitted cores."""
    p = len(B)
    sub = slice(active, kmax)
    mats = [np.triu(B[p - 1][sub, sub], -1)] + \
        [np.triu(B[l][sub, sub]) for l in range(p - 2, -1, -1)]
    Hnp = np.stack(mats)
    cplx = np.issubdtype(dtype, np.complexfloating)
    if cplx:
        out = native.pqz_complex_cpu(Hnp.astype(np.complex128), (True,) * p)
        if out is not None:
            T, Z, al, be, sc = out
            values = al / np.where(be == 0, 1.0, be) * np.exp2(sc.astype(float))
            return _small_ps(T, Z, np.where(be == 0, np.inf, values))
    else:
        try:
            T, Z, wr, wi = native.pschur_real_cpu(Hnp)
            return _small_ps(T, Z, wr + 1j * wi)
        except ConvergenceFailure:
            pass  # the iteration core may still land
    H = torch.as_tensor(Hnp)
    if cplx:
        T, Z, al, be, sc, ok = pqz_complex_core(H, (True,) * p)
        values = al.numpy() / be.numpy() * np.exp2(sc.numpy().astype(float))
    else:
        T, Z, wr, wi, ok = pqr_real_core(H)
        values = wr + 1j * wi
    if not ok:
        raise PKSFailure("projected periodic Schur failed to converge")
    return _small_ps(T, Z, values)


def _slot_q(PS: PeriodicSchur) -> List[np.ndarray]:
    """Map the small right-oriented Z stack onto Krylov basis slots:
    Q[l] = W[(p - l) % p]."""
    p = PS.period
    W = PS.Zs.numpy()
    return [W[(p - l) % p] for l in range(p)]


def _blocks_of(T0: np.ndarray) -> List[tuple]:
    """(start, size) diagonal-block partition from the quasi-triangular
    factor's subdiagonal (1x1 everywhere for complex/strict-triangular)."""
    k = T0.shape[0]
    blocks = []
    i = 0
    while i < k:
        if i + 1 < k and T0[i + 1, i] != 0:
            blocks.append((i, 2))
            i += 2
        else:
            blocks.append((i, 1))
            i += 1
    return blocks


def _invariant_basis_at1(Ts: np.ndarray, bstart: int, bsize: int,
                         blocks: List[tuple]) -> np.ndarray:
    """Orthonormal basis of the T-cycle invariant subspace at slot 1.

    ``Ts``: (p, k, k) right-oriented (quasi-)triangular stack with
    ``Zs[l]^H M[l] Zs[l+1] = Ts[l]``; the diagonal block at ``bstart`` (size
    ``bsize``) names the candidate.  The basis columns v satisfy
    ``(Ts[1] Ts[2] ... Ts[0]) v = v Mprod`` with the block's eigenvalues —
    i.e. exactly the span the leading columns of a reordered Zs[1] acquire,
    but obtained by cyclic periodic-Sylvester back-substitution instead of
    a trial ``ordschur``.

    Raises IllConditionedException (from pgsylsolve) when a level's
    separation vanishes; callers fall back to the trial-reorder probe.
    """
    p, kk, _ = Ts.shape
    dt = Ts.dtype
    M = [Ts[l, bstart:bstart + bsize, bstart:bstart + bsize]
         for l in range(p)]
    above = [b for b in blocks if b[0] < bstart]
    Sd = (True,) * p
    # fill[l][bi] = X_l block for level bi; level equations (derived from
    # Ts[l] v_{l+1} = v_l M_l on v = [x; I; 0]):
    #   Ts[l][Bi,Bi] X_{l+1} - X_l M_l = -C_l,
    # solved nearest-level-first so C can accumulate the in-between fill.
    fill = [dict() for _ in range(p)]
    for bi, bs in reversed(above):
        A = [Ts[l, bi:bi + bs, bi:bi + bs] for l in range(p)]
        C = []
        for l in range(p):
            ln = (l + 1) % p
            c = np.array(Ts[l, bi:bi + bs, bstart:bstart + bsize],
                         dtype=dt)
            for bq, bqs in above:
                if bq > bi:
                    c = c + Ts[l, bi:bi + bs, bq:bq + bqs] @ fill[ln][bq]
            C.append(c)
        # map A_l X_{l+1} - X_l B_l = -C_l onto pgsylsolve's
        # A'[k] X'[k] - X'[k+1] B'[k] = -C'[k] by reversing the cycle
        # (X'[k] = X_{(1-k) % p})
        Ar = [A[(-k) % p] for k in range(p)]
        Br = [M[(-k) % p] for k in range(p)]
        Cr = [C[(-k) % p] for k in range(p)]
        v = pgsylsolve(Ar, Br, Cr, Sd)
        pp = bs * bsize
        for k2 in range(p):
            fill[(1 - k2) % p][bi] = \
                v[k2 * pp:(k2 + 1) * pp].reshape((bs, bsize), order="F")
    V = np.zeros((kk, bsize), dtype=dt)
    V[bstart:bstart + bsize] = np.eye(bsize, dtype=dt)
    for bi, bs in above:
        V[bi:bi + bs] = fill[1 % p][bi]
    if not np.all(np.isfinite(V)):
        raise IllConditionedException()
    q, _ = np.linalg.qr(V)
    return q


def _residuals(PS, foot, ritz_ord, lams, isreal_t):
    """Ritz residuals per candidate (reference `_compute_ritz_resids!`,
    src/krylov.jl:833-919).

    Fast path: the residual only needs the span the leading columns of
    Zs[1] would acquire after reordering the candidate to the top, so it is
    computed directly from a cyclic Sylvester back-substitution
    (:func:`_invariant_basis_at1`), O(k^2 p) per candidate instead of the
    reference's full trial ``ordschur``.  Values are identical for 1x1
    candidates (the same unit vector up to phase); for pairs the
    projection 2-norm replaces the basis-dependent max-|entry| of the
    trial probe (within sqrt(2), conservative).  Ill-conditioned levels
    fall back to the trial probe.
    """
    nwrk = len(lams)
    Tsn = PS.Ts.numpy()
    W1 = PS.Zs.numpy()[1 % PS.period]
    blocks = _blocks_of(Tsn[0])
    rs = np.full(nwrk, np.inf)
    skip_next = False
    for j in ritz_ord:
        if skip_next:
            skip_next = False
            continue
        lam = lams[j]
        pair = isreal_t and lam.imag != 0
        jc = None
        if pair:
            jc = j + 1 if j + 1 < nwrk and abs(np.conj(lams[j + 1]) - lam) <= \
                1e-8 * max(abs(lam), 1e-300) else j - 1
            skip_next = True
        bstart, bsize = (min(j, jc), 2) if pair else (j, 1)
        # the candidate must align with the quasi-triangular block
        # partition (a half-pair or straddled block falls back to the
        # trial probe, which handles any structure)
        aligned = (bstart, bsize) in blocks if pair else \
            any(b == (bstart, 1) for b in blocks)
        try:
            if not aligned:
                raise IllConditionedException()
            U = _invariant_basis_at1(Tsn, bstart, bsize, blocks)
            newrow = foot @ (W1 @ U)
            r = float(np.linalg.norm(newrow))
        except (IllConditionedException, np.linalg.LinAlgError):
            r = _residual_trial(PS, foot, j, jc, nwrk)
        if pair:
            rs[j] = r
            rs[jc] = r
        else:
            rs[j] = r
    return rs


def _residual_trial(PS, foot, j, jc, nwrk):
    """Trial-reorder residual probe for one candidate (the reference's
    scheme, src/krylov.jl:833-919): move it to the top, read the
    transformed foot row."""
    select = np.zeros(nwrk, bool)
    select[j] = True
    if jc is not None:
        select[jc] = True
    try:
        PSx = ordschur(PS, list(select))
    except IllConditionedException:
        return float(np.abs(foot[:j + 1]).max())
    newrow = foot @ _slot_q(PSx)[PSx.period - 1]
    if jc is not None:
        return float(max(abs(newrow[0]), abs(newrow[1])))
    return float(abs(newrow[0]))


def partial_pschur(
    A,
    nev: int = 6,
    which: str = "LM",
    *,
    n: Optional[int] = None,
    dtype=None,
    device=None,
    mindim: Optional[int] = None,
    maxdim: Optional[int] = None,
    tol: Optional[float] = None,
    restarts: int = 100,
    purgebuffer: int = 2,
    u1=None,
    seed: int = 1234,
    eta_orth: Optional[float] = None,
    vrand=None,
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = True,
):
    """Find ``nev`` exterior eigenvalues of the product ``A[p-1] @ ... @ A[0]``
    (left orientation, like the reference) by periodic Krylov-Schur.

    Args:
      A: a (p, n, n) tensor, array or sequence of matrices (the drivers'
         device rule: a tensor stays on its device, an array goes to
         ``device``, default ``"cuda"``), a list of matrix-free callables
         (each maps a 1-D tensor on ``device`` to a 1-D tensor there; they
         need ``n=`` and ``dtype=``), or a ``CycleOps`` (or an object
         with its methods).
      which: LM, SM, LR, SR, LI or SI.
      tol: convergence tolerance (default sqrt(eps)).
      u1: optional starting vector (default: drawn from
        ``np.random.default_rng(seed)``, as the JAX package draws it).
      eta_orth: iterated-Gram-Schmidt re-orthogonalization threshold
        (default: AlgoConfig.eta_orth = 1/sqrt(2), reference src/krylov.jl:150).
      vrand: optional ``vrand(shape) -> ndarray`` filler for restart vectors
        (reference's custom ``vrand!``, src/krylov.jl:454).  Defaults to a
        seeded Gaussian.
      checkpoint: optional path; the restart loop state (bases, projected
        factors, Ritz bookkeeping, RNG) is saved there every
        ``checkpoint_every`` restarts, and — when ``resume`` — a matching
        existing file continues the loop mid-run.

    Returns:
      (PartialPeriodicSchur, ArnoldiHistory); the decomposition's tensors
      on the operator's device.
    """
    ops, p, n, dtype = _as_ops(A, n=n, dtype=dtype, device=device)
    reads0 = ops.reads
    isreal_t = not np.issubdtype(dtype, np.complexfloating)
    eps = float(np.finfo(dtype).eps)
    if tol is None:
        tol = float(np.sqrt(eps))
    if nev < 1:
        raise ValueError("nev must be >= 1")
    if mindim is None:
        mindim = min(max(10, nev), n)
    if maxdim is None:
        maxdim = min(max(20, 2 * nev), n)
    if not (nev <= mindim <= maxdim <= n):
        raise ValueError(f"need nev <= mindim <= maxdim <= n, got "
                         f"{nev} <= {mindim} <= {maxdim} <= {n}")
    if eta_orth is None:
        eta_orth = float(default_config.eta_orth)
    rng = np.random.default_rng(seed)
    _tm = {"arnoldi": 0.0, "small_schur": 0.0, "residuals": 0.0,
           "reorder_writeback": 0.0, "verify_locks": 0.0, "total": 0.0}
    _t00 = time.perf_counter()
    PK = _PKrylov(p, n, maxdim, dtype, rng, vrand=vrand)
    key0 = _order_key(which)
    if isreal_t:
        # real spectra come in conjugate pairs stored adjacently; an
        # imag-signed key (LI/SI) would sort the partners to opposite
        # ends and break every pair-adjacency assumption downstream
        def key(lam):
            return key0(lam if lam.imag >= 0 else np.conj(lam))
    else:
        key = key0
    eps23 = eps ** (2.0 / 3.0)

    tol1 = 100 * eps
    start_it = 0
    resumed = False
    if checkpoint is not None and resume and os.path.exists(checkpoint):
        Vc, Bc, meta = load_krylov_state(checkpoint)
        if (int(meta["p"]) != p or int(meta["n"]) != n or
                int(meta["maxdim"]) != maxdim or
                str(meta["dtype"]) != np.dtype(dtype).name):
            raise ValueError(
                "checkpoint problem shape/dtype mismatch: "
                f"{dict(p=int(meta['p']), n=int(meta['n']), maxdim=int(meta['maxdim']), dtype=str(meta['dtype']))}")
        for l in range(p):
            PK.V[l][...] = Vc[l]
            PK.B[l][...] = Bc[l]
        PK.k = int(meta["k"])
        rng.bit_generator.state = ast.literal_eval(str(meta["rng"]))
        nprods = int(meta["nprods"])
        nlock = int(meta["nlock"])
        active = int(meta["active"])
        k = int(meta["k"])
        lams_all = np.asarray(meta["lams_all"], complex).copy()
        rs_all = np.asarray(meta["rs_all"], float).copy()
        start_it = int(meta["it"]) + 1
        pa_ok = True
        resumed = True

    if not resumed:
        if u1 is None:
            v = PK.vrand(n)
        elif isinstance(u1, torch.Tensor):
            v = u1.detach().cpu().numpy().astype(dtype)
        else:
            v = np.asarray(u1, dtype=dtype)
        v = v / np.linalg.norm(v)
        _t0 = time.perf_counter()
        pa_ok = periodic_arnoldi(ops, PK, 0, mindim, v, tol1, eta_orth)
        _tm["arnoldi"] += time.perf_counter() - _t0
        nprods = p * mindim
        if not pa_ok:
            # singularity budget exhausted during the initial build: the
            # basis beyond the failure point was never constructed
            restarts = 0
        nlock = 0
        active = 0
        k = mindim
        lams_all = np.zeros(maxdim, complex)
        rs_all = np.full(maxdim, np.inf)

    for it in range(start_it, restarts):
        if it > 0:
            _restore_hessenberg(PK, active, k)
        u = PK.V[0][:, k]
        _t0 = time.perf_counter()
        pa_ok = periodic_arnoldi(ops, PK, k, maxdim, u, tol1, eta_orth)
        _tm["arnoldi"] += time.perf_counter() - _t0
        nprods += p * (maxdim - k)

        _t0 = time.perf_counter()
        PS = _small_pschur(PK.B, active, maxdim, dtype)
        _tm["small_schur"] += time.perf_counter() - _t0
        Hnorm = np.linalg.norm(PS.T1.numpy())
        foot = PK.B[p - 1][maxdim, active:maxdim].copy()
        lams = PS.values.numpy()
        lams_all[active:maxdim] = lams
        nwrk = maxdim - active

        def conv(lam, r):
            return r < max(eps23 * Hnorm, tol * abs(lam))

        # order all current estimates by preference
        order = sorted(range(maxdim), key=lambda j: key(lams_all[j]))
        # effective nev: widen across a conjugate pair boundary
        eff_nev = nev
        if isreal_t and eff_nev < maxdim:
            lj = lams_all[order[eff_nev - 1]]
            ln = lams_all[order[eff_nev]]
            if lj.imag != 0 and abs(np.conj(lj) - ln) <= 1e-8 * max(
                    abs(lj), 1e-300):
                eff_nev += 1

        _t0 = time.perf_counter()
        rs = _residuals(PS, foot, list(range(nwrk)), lams, isreal_t)
        _tm["residuals"] += time.perf_counter() - _t0
        rs_all[active:maxdim] = rs

        # locking: leading wanted candidates that have converged
        nlock = 0
        for i in range(eff_nev):
            j = order[i]
            if conv(lams_all[j], rs_all[j]):
                nlock += 1
            else:
                break

        _t0 = time.perf_counter()
        # move locked-but-active candidates to the top of the window
        if nlock > active:
            select = np.zeros(nwrk, bool)
            for i in range(nlock):
                j = order[i]
                if active <= j < maxdim:
                    select[j - active] = True
            # block-align: ordschur silently widens a half-selected 2x2
            # pair, so the perm bookkeeping must see the SAME widened
            # select or lams_all/rs_all desynchronize from the columns
            nlock += _widen_pairs(select, PS.Ts[0].numpy())
            if select.any():
                try:
                    PS = ordschur(PS, list(select))
                except IllConditionedException:
                    # the move failed: nothing is at the top; claim no new
                    # locks this restart (verify_locks re-checks anyway)
                    nlock = active
                else:
                    perm = _perm_from_select(select)
                    lams_all[active:maxdim] = lams_all[active:maxdim][perm]
                    rs_all[active:maxdim] = rs_all[active:maxdim][perm]

        # truncation length (conjugate-pair safe)
        k = min(nlock + mindim, (mindim + maxdim) // 2)
        k = max(k, nlock + 1)
        if isreal_t and k < maxdim:
            lk = lams_all[k - 1]
            if lk.imag != 0 and abs(np.conj(lk) - lams_all[k]) <= \
                    1e-8 * max(abs(lk), 1e-300):
                k += 1
        k = min(k, maxdim - 1)

        # retain the k preferred candidates (re-sorted after locking moves)
        order2 = sorted(range(maxdim), key=lambda j: key(lams_all[j]))
        # purge: converged-but-unwanted Ritz pairs have no reason to appear
        # in preference order, so stably push them past the retention cut —
        # truncation then drops them instead of letting them squat in the
        # subspace (reference src/krylov.jl:674-683; ``purgebuffer`` keeps a
        # few partially-converged hopefuls above the cut)
        if nlock < nev:
            istart = nlock + purgebuffer
            tail = order2[istart:]
            tail.sort(key=lambda j: 1 if conv(lams_all[j], rs_all[j]) else 0)
            order2 = order2[:istart] + tail
        select = np.zeros(nwrk, bool)
        nsel = 0
        for i in range(maxdim):
            j = order2[i]
            if active <= j < maxdim and nsel < k - active:
                select[j - active] = True
                nsel += 1
        # block-align the retention select (see the locking move): a
        # preference cut through a 2x2 block would discard its O(1)
        # subdiagonal and desynchronize the perm bookkeeping
        T0w = PS.Ts[0].numpy()
        k += _widen_pairs(select, T0w)
        if k > maxdim - 1:
            # widening overflowed the window: drop the straddling pair
            for i in range(nwrk - 2, -1, -1):
                if select[i] and T0w[i + 1, i] != 0 and select[i + 1]:
                    select[i] = select[i + 1] = False
                    k -= 2
                    break
        try:
            PS2 = ordschur(PS, list(select))
            perm = _perm_from_select(select)
            lams_all[active:maxdim] = lams_all[active:maxdim][perm]
            rs_all[active:maxdim] = rs_all[active:maxdim][perm]
            PS = PS2
        except IllConditionedException:
            pass

        # write the small solution back into the Krylov decomposition
        Q = _slot_q(PS)
        Ts = PS.Ts.numpy()
        Bp = PK.B[p - 1]
        Bp[active:maxdim, active:maxdim] = Ts[0]
        Bp[maxdim, active:maxdim] = foot @ Q[p - 1]
        for l in range(p - 1):
            # right-ordered stack index of factor-l window: p-1-l
            PK.B[l][active:maxdim, active:maxdim] = Ts[(p - 1 - l) % p]
        for l in range(p):
            PK.V[l][:, active:maxdim] = PK.V[l][:, active:maxdim] @ Q[l]
            if active > 0:
                PK.B[l][:active, active:maxdim] = \
                    PK.B[l][:active, active:maxdim] @ Q[l]

        # truncate
        PK.V[0][:, k] = PK.V[0][:, maxdim]
        Bp[k, :k] = Bp[maxdim, :k]
        Bp[k + 1:, :] = 0.0
        for l in range(p - 1):
            PK.B[l][k:, :] = 0.0
        PK.k = k
        _tm["reorder_writeback"] += time.perf_counter() - _t0

        # verify locks against the actual foot (reference `_verify_locks!`)
        _t0 = time.perf_counter()
        nlock = _verify_locks(PK, lams_all, rs_all, nlock, conv, isreal_t)
        _tm["verify_locks"] += time.perf_counter() - _t0
        active = nlock
        # restart tracing on the ``krylov`` channel (the reference prints
        # per-restart lock/residual progress, src/diagnostics.jl:5-31)
        if verbosity("krylov") >= 1:
            best = np.sort(rs_all[:maxdim])[:max(nev, 1)]
            print(f"[krylov] restart {it + 1}: locked {active}/{nev} "
                  f"k={k} nprods={nprods} best resid "
                  + np.array2string(best, precision=2), flush=True)
        if not pa_ok:
            # singularity budget exhausted while extending: keep the locks
            # verified THIS restart (an exactly-deflating rank-deficient
            # operator ends here with its converged eigenvalues in hand)
            break
        if checkpoint is not None and (it + 1) % max(checkpoint_every, 1) == 0:
            save_krylov_state(checkpoint, PK.V, PK.B, {
                "p": p, "n": n, "maxdim": maxdim,
                "dtype": np.dtype(dtype).name,
                "rng": str(rng.bit_generator.state),
                "nprods": nprods, "nlock": nlock, "active": active,
                "k": k, "it": it,
                "lams_all": lams_all, "rs_all": rs_all})
        if active >= nev:
            break

    nconv = active
    dev = ops.device
    Vc = np.stack([PK.V[l][:, :nconv] for l in range(p)])
    Tc = np.stack([np.triu(PK.B[l][:nconv, :nconv],
                           -1 if l == p - 1 else 0) for l in range(p)])
    # stacked factor order: slot l holds B[l]; the Schur factor is slot p-1
    ps = PartialPeriodicSchur(
        Ts=torch.as_tensor(Tc).to(dev), Vs=torch.as_tensor(Vc).to(dev),
        values=torch.as_tensor(lams_all[:nconv]).to(dev),
        residuals=torch.as_tensor(rs_all[:nconv]).to(dev),
        orientation="L", schurindex=p - 1)
    _tm["total"] = time.perf_counter() - _t00
    hist = ArnoldiHistory(nprods=nprods, nconverged=nconv,
                          converged=nconv >= nev, nev=nev,
                          timings={k_: round(v_, 4) for k_, v_ in _tm.items()},
                          host_reads=ops.reads - reads0)
    return ps, hist


def _perm_from_select(select):
    sel = [i for i, s in enumerate(select) if s]
    uns = [i for i, s in enumerate(select) if not s]
    return np.array(sel + uns)


def _widen_pairs(select, T0w):
    """Widen a selection over the quasi factor's 2x2 blocks IN PLACE.

    ``ordschur`` silently widens a half-selected conjugate pair; every
    caller that permutes its own bookkeeping with ``_perm_from_select``
    must therefore widen the select identically first.  Returns the
    number of entries added.
    """
    added = 0
    i = 0
    m = len(select)
    while i < m - 1:
        if T0w[i + 1, i] != 0:
            if bool(select[i]) != bool(select[i + 1]):
                select[i] = select[i + 1] = True
                added += 1
            i += 2
        else:
            i += 1
    return added


def _verify_locks(PK, lams, rs, nlock, conv, isreal_t):
    p = PK.p
    k = PK.k
    Bp = PK.B[p - 1]
    i = 0
    ncv = 0
    while i < nlock:
        lam = lams[i]
        if isreal_t and lam.imag != 0:
            r = np.hypot(abs(Bp[k, i]), abs(Bp[k, i + 1]) if i + 1 <= k else 0.0)
            rs[i] = rs[i + 1] = r
            if not conv(lam, r):
                break
            ncv = i + 2
            i += 2
        else:
            r = abs(Bp[k, i])
            rs[i] = r
            if not conv(lam, r):
                break
            ncv = i + 1
            i += 1
    return ncv
