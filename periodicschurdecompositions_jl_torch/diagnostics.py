"""Integrity checks for periodic Schur decompositions (port of ``check_psd``
and ``FacChecker``).

Host-side numpy on purpose, like the JAX package's: it is a diagnostic, not
a hot path.  Checks triangularity of the factors, orthonormality of the
Schur vectors and the per-factor reconstruction residual, honouring the
signature of a GeneralizedPeriodicSchur and complex (unitary) Z.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .types import GeneralizedPeriodicSchur


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _reconstruct(Ts, Zs, left, S):
    """Per-factor reconstruction Ahat[l] from (T, Z), honouring the
    orientation and the signature."""
    p = Ts.shape[0]
    Ahat = np.empty(Ts.shape, np.result_type(Ts, Zs))
    for l in range(p):
        ln = (l + 1) % p
        if bool(S[l]) ^ left:
            Ahat[l] = Zs[l] @ Ts[l] @ Zs[ln].conj().T
        else:
            Ahat[l] = Zs[ln] @ Ts[l] @ Zs[l].conj().T
    return Ahat


def check_psd(P, A: Optional[np.ndarray] = None, *, qtol: float = 10.0,
              tol: float = 100.0, verbose: bool = False):
    """Verify a periodic Schur decomposition.

    Args:
      P: PeriodicSchur or GeneralizedPeriodicSchur (with Zs present for
         the orthonormality and residual checks).
      A: optional original cycle (p, n, n), tensor or array; enables the
         reconstruction-residual check.
      qtol: orthonormality threshold multiplier: ||Z Z' - I||_1 < qtol*eps*n.
      tol: reconstruction threshold multiplier:
           ||A - Ahat||_1 <= tol*eps*||A||_1 per factor.

    Returns:
      (ok, report) where report maps check names to measured values.
    """
    Ts = _np(P.Ts)
    p, n, _ = Ts.shape
    eps = np.finfo(Ts.real.dtype).eps
    report = {}
    ok = True

    # the schurindex factor may be quasi-triangular for real dtypes only
    isreal = not np.iscomplexobj(Ts)
    tri_junk = 0.0
    for l in range(p):
        k = -1 if (l == P.schurindex and isreal) else 0
        sub = np.tril(Ts[l], k - 1)
        tri_junk = max(tri_junk, np.abs(sub).max() if sub.size else 0.0)
    report["triangularity_junk"] = tri_junk
    ok &= tri_junk == 0.0

    if P.Zs is not None:
        Zs = _np(P.Zs)
        orth = max(np.linalg.norm(Zs[l] @ Zs[l].conj().T - np.eye(n), ord=1)
                   for l in range(p))
        report["orthonormality"] = orth
        report["orthonormality_bound"] = qtol * eps * n
        ok &= orth < qtol * eps * n

        if A is not None:
            A = _np(A)
            S = P.S if isinstance(P, GeneralizedPeriodicSchur) else (True,) * p
            Ahat = _reconstruct(Ts, Zs, P.orientation == "L", S)
            worst = 0.0
            for l in range(p):
                anorm = max(np.linalg.norm(A[l], ord=1), np.finfo(A.real.dtype).tiny)
                worst = max(worst, np.linalg.norm(A[l] - Ahat[l], ord=1) / anorm)
            report["residual_rel"] = worst
            report["residual_bound"] = tol * eps
            ok &= worst <= tol * eps
    if verbose:
        print("check_psd:", "OK" if ok else "FAIL", report)
    return bool(ok), report


class FacChecker:
    """Transformation-chain verifier for debugging iteration cores.

    Behavioral contract from the reference's `_FacChecker`
    (src/diagnostics.jl:45-178): capture the initial cycle, then recompute
    the implied original factors from the current (H, Z) at any point in an
    iteration and report the drift.  Host numpy, like ``check_psd``; the
    cycle and (H, Z) may be tensors (on any device) or arrays.
    """

    def __init__(self, A, S=None, left=False):
        self.A = _np(A).copy()
        self.p = self.A.shape[0]
        self.S = tuple(bool(x) for x in S) if S is not None else (True,) * self.p
        self.left = left

    def __call__(self, label: str, H, Z, verbose: bool = True) -> float:
        H = _np(H)
        Z = _np(Z)
        Ax = _reconstruct(H, Z, self.left, self.S)
        worst = 0.0
        for l in range(self.p):
            scale = max(np.abs(self.A[l]).max(), 1e-300)
            worst = max(worst, np.abs(Ax[l] - self.A[l]).max() / scale)
        if verbose:
            print(f"FacChecker[{label}]: worst factor drift {worst:.3e}")
        return worst
