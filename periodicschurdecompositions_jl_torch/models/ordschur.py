"""Eigenvalue reordering for periodic Schur decompositions (port of
``models/ordschur.py``).

Behavioral contract from the reference's `ordschur!` methods (complex:
src/ordschur.jl:11-73; real: src/rordschur.jl:3-132 with the `_moveblock!`
state machine :141-251):

* normalize to left orientation with the Schur factor at slot 0
  (rev_alias + cyclic relabeling, like the reference :17-33),
* bubble selected blocks to the top with adjacent swaps; every swap runs
  weak/strong stability tests and a rejection raises
  IllConditionedException (reference src/ordschur.jl:62),
* real decompositions silently widen `select` across conjugate pairs and
  move 1x1/2x2 blocks with the split-tracking state machine,
* eigenvalues are recomputed from the reordered diagonals (`_updateλ!`,
  reference src/ordschur.jl:75-314), re-solving 2x2 blocks via the scaled
  window-block product.

The work is host numpy (``ops/reorder_np.py``: a chain of tiny accept/reject
decisions), and functional: a NEW decomposition is returned, inputs are
untouched.  The factors come to the host in one copy each of ``Ts`` and
``Zs`` and go back as tensors on the device ``P.Ts`` lives on.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import default_config, verbosity
from ..ops.reorder_np import rpeigvals2x2_np, swapadj1x1, swapadjqr
from ..types import GeneralizedPeriodicSchur, IllConditionedException, PeriodicSchur
from ..utils.circshift import circshift_psd, rev_alias


def _safeprod_np(vals, S):
    """(alpha, beta, scale) of prod vals[l]^{±1} with exact 2-exponent
    renormalization (numpy mirror of utils.safeprod)."""
    alpha = 1.0 + 0.0j if np.iscomplexobj(np.asarray(vals)) else 1.0
    beta = 1.0
    scale = 0
    for l, x in enumerate(vals):
        if S[l]:
            alpha = alpha * x
        else:
            if x == 0:
                beta = 0.0
            else:
                alpha = alpha / x
        a = abs(alpha)
        if a == 0:
            scale = 0
            alpha = 0.0 * alpha
        else:
            e = int(np.frexp(a)[1])
            alpha = alpha * 2.0 ** (1 - e)
            scale += e - 1
    return alpha, beta, scale



def _sanitize_pair(v1, t1, v2, t2):
    """Standardize a 2x2 re-solve's eigenvalue pair (reference
    `_sanitize_reigpair!`, src/rpschur2x2.jl:238-275).

    Aligns the two decomposed values to a common power-of-two scale,
    decides real-vs-conjugate by a RELATIVE tolerance (iterative solvers
    return roundoff-nonzero imaginary parts even for genuinely real
    eigenvalues — an exact-zero test would average two distinct reals
    into a fake pair), and re-normalizes the mantissas into [1, 2).
    Returns ((w1, s1), (w2, s2)).
    """
    def renorm(v, t):
        a = abs(v)
        if a == 0:
            return 0.0 + 0.0j, 0
        e = int(np.frexp(a)[1])
        return v * 2.0 ** (1 - e), t + e - 1

    v1, t1 = renorm(v1, t1)
    v2, t2 = renorm(v2, t2)
    tol = 1e-10  # relative: well above iterative roundoff, far below pairs
    if abs(t1 - t2) <= 1 and (v1 != 0 or v2 != 0):
        # align to a common exponent (safe: mantissas are in [1, 2))
        v1a = v1 * 2.0 ** (t1 - t2) if t1 <= t2 else v1
        v2a = v2 * 2.0 ** (t2 - t1) if t1 > t2 else v2
        tbase = max(t1, t2)
        m = max(abs(v1a), abs(v2a))
        if abs(v1a.imag) <= tol * m and abs(v2a.imag) <= tol * m:
            # real pair (possibly distinct) — do NOT average
            return renorm(complex(v1a.real), tbase), \
                renorm(complex(v2a.real), tbase)
        wr = (v1a.real + v2a.real) / 2
        wi = (abs(v1a.imag) + abs(v2a.imag)) / 2
        return renorm(wr + 1j * wi, tbase), renorm(wr - 1j * wi, tbase)
    # magnitudes differ by >2x: cannot be conjugates — treat as reals
    return renorm(complex(v1.real), t1), renorm(complex(v2.real), t2)


def _eig2x2_prod_np(W, S):
    """Eigenvalues of the signed 2x2 window-block product, scaled
    (numpy mirror of ops.pqz_real.eig2x2_product)."""
    P = np.eye(2, dtype=W[0].dtype)
    e = 0
    beta = 1.0
    for l in range(len(S)):
        if S[l]:
            P = P @ W[l]
        else:
            a, b, d = W[l][0, 0], W[l][0, 1], W[l][1, 1]
            if a == 0 or d == 0:
                # substitute 1 for the zero diagonal entries only (the
                # finite structure stays in the product), like the device
                # kernel ops/pqz_real.eig2x2_product:168-176
                beta = 0.0
            asafe = a if a != 0 else 1.0
            dsafe = d if d != 0 else 1.0
            P = P @ np.array([[1 / asafe, -b / (asafe * dsafe)],
                              [0, 1 / dsafe]])
        m = np.abs(P).max()
        if m > 0:
            ee = int(np.frexp(m)[1])
            P = P * 2.0 ** (1 - ee)
            e += ee - 1
    w = np.linalg.eigvals(P)
    out = []
    for wj in w:
        a = abs(wj)
        if a == 0:
            out.append((0.0 + 0.0j, 0))
        else:
            ee = int(np.frexp(a)[1])
            out.append((wj * 2.0 ** (1 - ee), e + ee - 1))
    # standardize conjugates / reals (shared sanitizer)
    (w1, s1), (w2, s2) = out
    (w1, s1), (w2, s2) = _sanitize_pair(w1, s1, w2, s2)
    return (w1, s1), (w2, s2), beta


def _normalize(P):
    """-> (Pn, undo): left orientation, Schur factor at slot 0.

    Any ``schurindex`` is handled by cyclic relabeling (the reference
    normalizes arbitrary indices the same way via ``_circshift``,
    src/utils.jl:6-85)."""
    steps = []
    if P.orientation == "R":
        P = rev_alias(P)
        steps.append(("rev", None))
    k = P.schurindex
    if k != 0:
        P = circshift_psd(P, -k)
        steps.append(("shift", k))
    return P, steps


def _denormalize(P, steps):
    for tag, k in reversed(steps):
        if tag == "shift":
            P = circshift_psd(P, k)
        else:
            P = rev_alias(P)
    return P


def _np_lists(P):
    p = P.period
    Ts = P.Ts.detach().cpu().numpy()
    T = [Ts[l].copy() for l in range(p)]
    Z = None
    if P.Zs is not None:
        Zs = P.Zs.detach().cpu().numpy()
        Z = [Zs[l].copy() for l in range(p)]
    S = P.S if isinstance(P, GeneralizedPeriodicSchur) else (True,) * p
    return T, Z, S


def _swap_blocks(T, Z, S, i1, nb1, nb2):
    """Swap adjacent blocks of sizes (nb1, nb2) at row i1 (0-based)."""
    if nb1 == 1 and nb2 == 1:
        return swapadj1x1(T, Z, S, i1)
    return swapadjqr(T, Z, S, i1, nb1, nb2)


def _move_log(jsrc, here):
    """Block-move failure tracing on the ``rordschur`` channel (the
    reference's _moveblock! diagnostics, src/rordschur.jl:100,141-251)."""
    if verbosity("rordschur") >= 1:
        print(f"[rordschur] block move from {jsrc} stuck at {here}: "
              "swap rejected by stability tests", flush=True)


def _moveblock(T, Z, S, jsrc, jdest):
    """Move the block starting at jsrc up to jdest (reference
    `_moveblock!`, src/rordschur.jl:141-251).  Returns (jsrc, jdest, ok)."""
    A1 = T[0]
    n = A1.shape[0]
    if jsrc > 0 and A1[jsrc, jsrc - 1] != 0:
        jsrc -= 1
    nbsrc = 2 if (jsrc < n - 1 and A1[jsrc + 1, jsrc] != 0) else 1
    if jdest > 0 and A1[jdest, jdest - 1] != 0:
        jdest -= 1
    if jsrc == jdest:
        return jsrc, jdest, True
    if jdest > jsrc:
        raise ValueError("only upward moves are implemented")

    here = jsrc
    splitsrc = False
    while here > jdest:
        if not splitsrc:
            nbnext = 2 if (here >= 2 and A1[here - 1, here - 2] != 0) else 1
            ok = _swap_blocks(T, Z, S, here - nbnext, nbnext, nbsrc)
            if not ok:
                _move_log(jsrc, here)
                return jsrc, here, False
            here -= nbnext
            if nbsrc == 2 and A1[here + 1, here] == 0:
                splitsrc = True
        else:
            nbnext = 2 if (here >= 2 and A1[here - 1, here - 2] != 0) else 1
            ok = _swap_blocks(T, Z, S, here - nbnext, nbnext, 1)
            if not ok:
                _move_log(jsrc, here)
                return jsrc, here, False
            if nbnext == 1:
                ok = _swap_blocks(T, Z, S, here, nbnext, 1)
                if not ok:
                    _move_log(jsrc, here)
                    return jsrc, here, False
            else:
                if A1[here, here - 1] == 0:
                    nbnext = 1
                if nbnext == 2:
                    ok = _swap_blocks(T, Z, S, here - 1, 2, 1)
                    if not ok:
                        _move_log(jsrc, here)
                        return jsrc, here, False
                    here -= 2
                else:
                    ok = _swap_blocks(T, Z, S, here, 1, 1)
                    if not ok:
                        _move_log(jsrc, here)
                        return jsrc, here, False
                    ok = _swap_blocks(T, Z, S, here - 1, 1, 1)
                    if not ok:
                        _move_log(jsrc, here)
                        return jsrc, here, False
                    here -= 2
                continue
            here -= nbnext
    return jsrc, here, True


def _update_values(T, S, iterative: bool = False):
    """Recompute eigenvalues from reordered diagonals (reference _updateλ!).

    Works in normalized (left, slot-0) space; the cyclic product rotation
    used for 2x2 re-solves starts at slot 0: [T0, T_{p-1}, ..., T1].
    ``iterative`` switches the 2x2 re-solve to the MB03BB-style scheme
    (AlgoConfig.iterative_2x2).
    """
    p = len(T)
    n = T[0].shape[0]
    isreal_t = not np.iscomplexobj(T[0])
    order = [0] + list(range(p - 1, 0, -1))
    Sx = [S[l] for l in order]
    alpha = np.zeros(n, complex)
    beta = np.zeros(n)
    scale = np.zeros(n, np.int64)
    j = 0
    while j < n:
        pair = isreal_t and j < n - 1 and T[0][j + 1, j] != 0
        if pair:
            W = [T[l][j:j + 2, j:j + 2] for l in order]
            (w1, s1), (w2, s2), bflag = _eig2x2_prod_np(W, Sx)
            if iterative:
                # optional MB03BB-style iterative re-solve (AlgoConfig.
                # iterative_2x2); non-convergence keeps the one-shot value
                (v1, t1), (v2, t2), bfl2, okc = rpeigvals2x2_np(W, Sx)
                if okc:
                    (v1, t1), (v2, t2) = _sanitize_pair(v1, t1, v2, t2)
                    (w1, s1), (w2, s2), bflag = (v1, t1), (v2, t2), bfl2
            alpha[j], alpha[j + 1] = w1, w2
            beta[j] = beta[j + 1] = bflag
            scale[j], scale[j + 1] = s1, s2
            j += 2
        else:
            vals = [T[l][j, j] for l in order]
            a, b, sc = _safeprod_np(vals, Sx)
            alpha[j], beta[j], scale[j] = a, b, sc
            j += 1
    return alpha, beta, scale


def ordschur(P, select: Sequence[bool], want_z: bool = True,
             cfg=None):
    """Reorder a periodic Schur decomposition: move the eigenvalues selected
    by `select` (and their invariant subspace) to the top.

    For real decompositions `select` is widened over conjugate pairs.  A
    swap failing its stability tests raises IllConditionedException.
    Returns a new decomposition of the same type and orientation, its
    tensors on the device of ``P.Ts``.

    ``cfg``: optional AlgoConfig; ``cfg.iterative_2x2`` switches the 2x2
    eigenvalue re-solve to the iterative MB03BB-style scheme (reference
    src/rpschur2x2.jl:9-235).
    """
    if cfg is None:
        cfg = default_config
    if P.Zs is None and want_z:
        raise ValueError("ordschur requires Schur vectors (want_z decompositions)")
    Pn, steps = _normalize(P)
    T, Z, S = _np_lists(Pn)
    if not S[0]:
        # the swap kernels and 2x2 re-solves assume a DIRECT (quasi-)
        # triangular Schur factor, like the factorization drivers
        # (models/drivers.py); an inverted one would silently produce
        # wrong eigenvalues
        raise ValueError("the Schur factor (schurindex) must carry a "
                         "direct (+1) signature")
    n = T[0].shape[0]
    select = list(bool(x) for x in select)
    if len(select) != n:
        raise ValueError("select length must match the decomposition size")
    isreal_t = not np.iscomplexobj(T[0])

    if not isreal_t:
        # complex: all blocks are 1x1 (reference src/ordschur.jl:52-65)
        js = 0
        for j in range(n):
            if select[j]:
                if j != js:
                    for i in range(j - 1, js - 1, -1):
                        if not swapadj1x1(T, Z, S, i):
                            raise IllConditionedException(j)
                js += 1
    else:
        # real: widen select over pairs, then move blocks upward
        j = 0
        while j < n:
            if j < n - 1 and T[0][j + 1, j] != 0:
                if select[j] or select[j + 1]:
                    select[j] = select[j + 1] = True
                j += 2
            else:
                j += 1
        jdest = 0
        j = 0
        while j < n:
            pair = j < n - 1 and T[0][j + 1, j] != 0
            if select[j]:
                if j != jdest:
                    jsrc2, jd2, ok = _moveblock(T, Z, S, j, jdest)
                    if not ok:
                        raise IllConditionedException(j)
                jdest += 2 if pair else 1
            j += 2 if pair else 1

    alpha, beta, scale = _update_values(T, S,
                                        iterative=cfg.iterative_2x2)

    dev = P.Ts.device
    Ts = torch.as_tensor(np.stack(T)).to(dev)
    Zs = None if Z is None else torch.as_tensor(np.stack(Z)).to(dev)
    if isinstance(Pn, GeneralizedPeriodicSchur):
        out = GeneralizedPeriodicSchur(
            S=Pn.S, schurindex=0, Ts=Ts, Zs=Zs,
            alpha=torch.as_tensor(alpha).to(dev),
            beta=torch.as_tensor(beta).to(dev),
            alphascale=torch.as_tensor(scale.astype(np.int32)).to(dev),
            orientation=Pn.orientation)
    else:
        values = alpha / np.where(beta == 0, np.nan, beta) * \
            np.exp2(scale.astype(float))
        out = PeriodicSchur(Ts=Ts, Zs=Zs, values=torch.as_tensor(values).to(dev),
                            orientation=Pn.orientation, schurindex=0)
    return _denormalize(out, steps)
