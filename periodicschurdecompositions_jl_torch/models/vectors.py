"""Eigenvector extraction from periodic Schur decompositions (port of
``models/vectors.py``).

Behavioral contract from the reference's `eigvecs` (src/vectors.jl:25-138):
selected right eigenvectors of the cyclic product are obtained by reordering
the wanted eigenvalue to the top and reading scaled leading Schur columns
(simple eigenvalues) or solving a row-replaced 2x2 cyclic system via the
BABD solver (real conjugate pairs), then rotating the selection window.

Vectors satisfy ``A[l] @ V[l][:, k] = mu * V[(l+1)%p][:, k]`` with
``mu = lambda^(1/p)`` for left orientation; for right orientation the
returned ``V[0]`` satisfies ``A[0] @ ... @ A[p-1] @ v = lambda v`` (the
internal computation normalizes to left and maps the slots back).

The work is host numpy: the decomposition comes to the host once, every
reordering runs there, and the vectors go back as complex128 tensors on the
device ``P.Ts`` lives on.  ``eigvecs_partial`` lifts the vectors of a
``PartialPeriodicSchur``'s small k x k problem through its Ritz bases on
that device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops.reorder_np import babd_qr, babd_solve
from ..types import PartialPeriodicSchur, PeriodicSchur
from ..utils.circshift import rev_alias
from .ordschur import ordschur


def _cyclic_block_solve(Zd, Zl, y):
    K = len(Zd)
    if K == 1:
        return np.linalg.solve(Zd[0] + Zl[0], y)
    if K == 2:
        m = Zd[0].shape[0]
        M = np.zeros((2 * m, 2 * m), dtype=Zd[0].dtype)
        M[:m, :m] = Zd[0]
        M[:m, m:] = Zl[1]
        M[m:, :m] = Zl[0]
        M[m:, m:] = Zd[1]
        return np.linalg.solve(M, y)
    R, Zu, Zr, yq = babd_qr(Zd, Zl, y)
    return babd_solve(R, Zu, Zr, yq)


def _on_cpu(P):
    return PeriodicSchur(Ts=P.Ts.detach().cpu(), Zs=P.Zs.detach().cpu(),
                         values=P.values.detach().cpu(), orientation=P.orientation,
                         schurindex=P.schurindex)


def eigvecs(P, select: Sequence[bool], shifted: bool = True):
    """Selected right eigenvectors of the cyclic product.

    Args:
      P: a PeriodicSchur with Schur vectors.
      select: which eigenvalues (by position in ``P.values``); for real
        decompositions conjugate partners are added automatically.
      shifted: also return eigenvectors of the cyclically shifted products
        (one matrix per cycle slot); otherwise a single-matrix list.

    Returns:
      list of (n, nvec) complex128 tensors on the device of ``P.Ts``.
    """
    if not isinstance(P, PeriodicSchur):
        raise TypeError("eigvecs is implemented for PeriodicSchur")
    if P.Zs is None:
        raise ValueError("eigvecs requires Schur vectors in the decomposition")
    dev = P.Ts.device
    p = P.period
    n = P.n
    right = P.orientation == "R"
    Pw = _on_cpu(rev_alias(P) if right else P)   # work in left orientation

    select = list(bool(x) for x in select)
    if len(select) != n:
        raise ValueError(f"select length {len(select)} != decomposition "
                         f"size {n}")
    isreal_t = not Pw.Ts.is_complex()
    if isreal_t:
        # widen over 2x2 blocks of the quasi factor — STRUCTURALLY, not by
        # eigenvalue imaginary parts: an unsplit block can carry two real
        # (distinct) product eigenvalues and must still travel as a unit
        T1 = Pw.Ts[Pw.schurindex].numpy()
        j = 0
        while j < n - 1:
            if T1[j + 1, j] != 0:
                if select[j] or select[j + 1]:
                    select[j] = select[j + 1] = True
                j += 2
            else:
                j += 1
    if not all(select):
        Pw = ordschur(Pw, select)
    nvec = int(np.sum(select))
    nmat = p if shifted else 1
    Vs = [np.zeros((n, nvec), complex) for _ in range(nmat)]

    def _pair_solve(Tfac2, Zwin, lam, col):
        """Row-replaced 2x2 cyclic solve for eigenvalue ``lam`` of the
        leading block (ref :70-112); writes column ``col``."""
        mu = lam ** (1.0 / p)
        Zd = [(-mu * np.eye(2)).astype(complex) for _ in range(p)]
        Zl = [Tfac2[l].astype(complex) for l in range(p)]
        y = np.zeros(2 * p, complex)
        y[0] = 1.0
        Zd[0][0, :] = 0.0
        Zl[p - 1][0, :] = 0.0
        Zd[0][0, 0:2] = 1.0
        x = _cyclic_block_solve(Zd, Zl, y)
        t = 1.0 / np.linalg.norm(x[0:2])
        for l in range(nmat):
            i0 = 2 * l
            Vs[l][:, col] = t * (Zwin[l] @ x[i0:i0 + 2])

    sel = np.zeros(n, bool)
    sel[:nvec] = True
    ilam = 0
    while ilam < nvec:
        vals = Pw.values.numpy()
        # only the leading 2x2 windows of T and the leading 2 Schur-vector
        # columns are read
        Ts, Zs = Pw.Ts.numpy(), Pw.Zs.numpy()
        T1w = Ts[Pw.schurindex][0:2, 0:2]
        Tfac2 = [Ts[l][0:2, 0:2] for l in range(p)]
        Zwin = [Zs[l][:, 0:2] for l in range(nmat)]
        lam = complex(vals[0])
        structural_pair = isreal_t and n >= 2 and T1w[1, 0] != 0
        if structural_pair:
            lam2 = complex(vals[1])
            _pair_solve(Tfac2, Zwin, lam, ilam)
            if ilam + 1 < nvec:
                if abs(lam.imag) > 0:
                    # conjugate pair: the partner is the conjugate
                    for l in range(nmat):
                        Vs[l][:, ilam + 1] = np.conj(Vs[l][:, ilam])
                else:
                    # unsplit block with two real eigenvalues: solve the
                    # partner's system separately
                    _pair_solve(Tfac2, Zwin, lam2, ilam + 1)
            nlam = 2
        else:
            mu = lam ** (1.0 / p)
            fac = 1.0 + 0.0j
            for l in range(nmat):
                Vs[l][:, ilam] = fac * Zwin[l][:, 0]
                fac *= Tfac2[l][0, 0] / mu
            nlam = 1
        sel[:nlam] = False
        ilam += nlam
        if ilam < nvec:
            Pw = ordschur(Pw, list(sel))
            sel = np.roll(sel, -nlam)
    if right:
        # map slots back to the caller's factor labeling: V_A[j] = V_B[(p-j)%p]
        Vs = [Vs[(p - j) % p] if shifted else Vs[0] for j in range(nmat)]
    return [torch.as_tensor(v).to(dev) for v in Vs]


def eigvecs_partial(P, select: Sequence[bool], shifted: bool = True):
    """Eigenvectors from a PartialPeriodicSchur (reference src/krylov.jl:
    996-1022): solve the small k x k problem with identity bases
    (``eigvecs``), then lift through the Ritz bases ``V[l]`` on the device
    of ``P.Vs``.

    Returns:
      list of (n, nvec) complex128 tensors on the device of ``P.Vs``.
    """
    if not isinstance(P, PartialPeriodicSchur):
        raise TypeError("eigvecs_partial expects a PartialPeriodicSchur")
    p = P.period
    k = P.Ts.shape[-1]
    small = PeriodicSchur(
        Ts=P.Ts, Zs=torch.eye(k, dtype=P.Ts.dtype, device=P.Ts.device).repeat(p, 1, 1),
        values=P.values, orientation=P.orientation, schurindex=P.schurindex)
    V0 = eigvecs(small, select, shifted=shifted)
    nmat = p if shifted else 1
    return [P.Vs[l].to(V0[l].dtype) @ V0[l] for l in range(nmat)]
