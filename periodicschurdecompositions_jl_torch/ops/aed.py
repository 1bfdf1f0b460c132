"""Periodic aggressive early deflation (AED) of the real iteration (port of
the real route of ``ops/aed.py``).

The classic QR accelerator (Braman-Byers-Mathias; LAPACK xLAQR3), in its
periodic form (after Kressner): take the trailing ``w``-window of the active
cycle, compute its (small) periodic Schur form, and examine the *spike* —
the window's coupling column ``beta * Zw[0][0, :]`` that materializes when
the window transforms are applied to the Hessenberg factor.  Every trailing
eigenvalue block whose spike entries are negligible is converged even
though the subdiagonal test cannot see it yet; zeroing those entries (a
backward-stable perturbation) deflates it without further sweeps.
Non-deflatable blocks are reordered out of the way (``models/ordschur.py``)
and the remaining window is returned to periodic Hessenberg form around the
compressed spike.

``aed_analyze`` is host numpy apart from its re-reduction: the window
Schur is the native C++ one (``native.py``), and only on its
non-convergence the port's own ``pqr_real_core`` on a CPU tensor (the
reference's own decline path); the re-reduction of the window is
``phessenberg_core`` on the caller's device (the reduction kernel
``csrc/hess.cu`` on the card, its plain version on the CPU).  ``aed_apply`` writes a window's transforms into the padded
device state of ``pqr_real_core`` with ``torch.matmul`` on the state's own
device (the JAX package computes ``aed_apply_ff`` in ``jnp``, outside any
Pallas kernel, so there is no kernel to port here).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..types import ConvergenceFailure, IllConditionedException, PeriodicSchur

# running tallies (host-side observability; tests read these)
stats = {"passes": 0, "deflated": 0}


def _window_schur(Hwin: np.ndarray):
    """Exact-f64 periodic Schur of the window cycle (host).

    Native first; on its non-convergence the port's ``pqr_real_core`` on a
    CPU tensor.  Both give ``Z[l]' H[l] Z[l+1] = T[l]``.  None when neither
    converges."""
    try:
        return native.pschur_real_cpu(np.asarray(Hwin, np.float64))
    except ConvergenceFailure:
        pass
    from .pqr_real import pqr_real_core
    T, Z, wr, wi, ok = pqr_real_core(torch.from_numpy(np.array(Hwin, np.float64)),
                                     want_z=True)
    if not ok:
        return None
    return T.numpy(), Z.numpy(), wr, wi


def _phess_window(Awin: np.ndarray, device):
    """Exact-f64 periodic Hessenberg reduction of the window cycle on
    ``device`` (one copy there and one back); host arrays (H, Q)."""
    from .hessenberg import phessenberg_core
    H, Q = phessenberg_core(torch.from_numpy(Awin).to(device), want_q=True)
    HQ = torch.stack([H, Q]).cpu().numpy()
    return HQ[0], HQ[1]


def aed_analyze(Hwin: np.ndarray, beta: float, tol: float,
                max_moves: Optional[int] = None, device="cpu"
                ) -> Optional[Tuple[int, np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]]:
    """Analyze a trailing window for early deflations (host, f64).

    Args:
      Hwin: (p, w, w) float64 window; Hwin[0] upper Hessenberg (the window
        of the active Hessenberg factor), Hwin[1:] upper triangular.
      beta: the coupling entry H0[s, s-1] (0 at the window head).
      tol: absolute spike-negligibility threshold.  Zeroing a spike entry
        perturbs H0 by exactly that entry, and the library's contract is a
        max-norm relative backward error <= 1e-12, so the driver passes
        ulp * sqrt(n) * max|H0|.
      max_moves: cap on the failed-block moves (None: unlimited).
      device: where the window is re-reduced (``phessenberg_core``): the
        device of the state the result goes to.

    Returns None when nothing deflates, else
      (d, Wfinal, Ztot, values, spike_head):
      d: number of deflated eigenvalues (trailing d window slots);
      Wfinal: (p, w, w) new window stack — leading (w-d) back in periodic
        Hessenberg form, trailing d standardized quasi-triangular;
      Ztot: (p, w, w) orthogonal window transforms (Z_l <- Z_l @ Ztot_l);
      values: (w,) complex eigenvalues (trailing d slots are the deflated,
        now-final eigenvalues);
      spike_head: (w,) new H0[s:s+w, s-1] column (alpha e1 pattern).
    """
    from ..models.ordschur import ordschur

    p, w, _ = Hwin.shape
    out = _window_schur(Hwin)
    if out is None:
        return None
    Tw, Zw, wr, wi = out
    vals = wr + 1j * wi
    PS = PeriodicSchur(Ts=torch.from_numpy(Tw), Zs=torch.from_numpy(Zw),
                       values=torch.from_numpy(vals), orientation="R",
                       schurindex=0)

    def spike_of(PSx):
        return beta * PSx.Zs[0, 0, :].numpy()

    spike = spike_of(PS)
    T0 = PS.Ts[0].numpy()
    kbot = w
    kept = 0
    moves = 0
    while kbot > kept:
        # block size from T[0]'s ACTUAL subdiagonal, NOT the eigenvalue
        # imaginary parts: ordschur's 2x2 re-solve can round a tiny pair
        # to exactly-real eigenvalues while the block stays 2x2 — a
        # bs=1 decision there would zero a genuine O(1) subdiagonal
        bs = 2 if (kbot >= 2 and T0[kbot - 1, kbot - 2] != 0) else 1
        if bs == 2 and kbot - 2 < kept:
            break  # half a pair at the boundary: stop
        if np.abs(spike[kbot - bs:kbot]).max() <= tol:
            kbot -= bs  # deflate in place
            continue
        if kept == kbot - bs:
            kept += bs  # already at the top of the undecided region
            continue
        if max_moves is not None and moves >= max_moves:
            break  # move budget spent: keep the harvested tail
        # move the failed block out of the way (to position `kept`)
        select = np.zeros(w, bool)
        select[:kept] = True
        select[kbot - bs:kbot] = True
        try:
            PS = ordschur(PS, list(select))
        except IllConditionedException:
            break  # stop reordering; keep what is already deflated
        spike = spike_of(PS)
        T0 = PS.Ts[0].numpy()
        kept += bs
        moves += 1
    d = w - kbot
    stats["passes"] += 1
    if d == 0:
        return None
    u = kbot
    Tw = PS.Ts.numpy()
    Zw = PS.Zs.numpy()
    lams = PS.values.numpy()

    # ---- compress the live spike + re-Hessenberg the leading window -----
    V = np.broadcast_to(np.eye(w), (p, w, w)).copy()
    spike_head = np.zeros(w)
    if u > 0:
        sp = spike[:u].copy()
        nrm = np.linalg.norm(sp)
        if nrm > 0.0:
            # Householder P (symmetric orthogonal): P @ sp = alpha e1
            alpha = -nrm if sp[0] >= 0 else nrm
            v = sp.copy()
            v[0] -= alpha
            vn2 = v @ v
            P = np.eye(u)
            if vn2 > 0.0:
                P -= 2.0 * np.outer(v, v) / vn2
            spike_head[0] = alpha
            # V_0 = P @ W_0 appears on BOTH factor 0's left and factor
            # p-1's right: reduce the cycle (P T_0, T_1, .., T_{p-1} P)
            # with the standard periodic Hessenberg reduction, whose W_0
            # is a product of e1-preserving reflectors — the compressed
            # spike direction survives exactly.  The leading-u problem is
            # embedded block-diagonally at the full window size, as the
            # JAX package does (there to reuse one compiled reduction).
            Pw = np.eye(w)
            Pw[:u, :u] = P
            if p == 1:
                Aw = (Pw @ Tw[0] @ Pw)[None]
            else:
                Aw = np.stack([Pw @ Tw[0]] +
                              [Tw[l] for l in range(1, p - 1)] +
                              [Tw[p - 1] @ Pw])
            # decouple the deflated trailing block: the reduction must not
            # mix it with the live window (blockdiag inputs stay blockdiag
            # through QR/Hessenberg stages; zeroing makes that exact)
            Aw[:, u:, :u] = 0.0
            Aw[:, :u, u:] = 0.0
            for l in range(p):
                Aw[l, u:, u:] = np.eye(d)
            Hw, Qw = _phess_window(Aw, device)
            e1err = np.abs(Qw[0][:, 0] - np.eye(w)[:, 0]).max()
            offd = max(np.abs(Qw[l][:u, u:]).max()
                       for l in range(p))
            if not (np.isfinite(e1err) and e1err <= 1e-12 and
                    offd <= 1e-12):
                return None  # defensive: never corrupt the spike direction
            for l in range(p):
                lead = (P @ Qw[l][:u, :u]) if l == 0 else Qw[l][:u, :u]
                V[l][:u, :u] = lead
        # nrm == 0: spike already compressed; leading Schur block is
        # triangular, hence Hessenberg — nothing to do

    Wfinal = np.empty_like(Tw)
    for l in range(p):
        Wfinal[l] = V[l].T @ Tw[l] @ V[(l + 1) % p]
    # exact structural zeros (the matmuls leave rounding junk)
    for l in range(p):
        Wfinal[l][u:, :u] = 0.0
        if l == 0:
            Wfinal[l][:u, :u] = np.triu(Wfinal[l][:u, :u], -1)
            # trailing block: quasi-triangular from the window Schur
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:], -1)
            keep = np.abs(np.diag(Tw[0][u:, u:], -1)) > 0
            sub = np.diag(Wfinal[l][u:, u:], -1) * keep
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:]) + np.diag(sub, -1)
        else:
            Wfinal[l] = np.triu(Wfinal[l])
    Ztot = np.empty_like(Zw)
    for l in range(p):
        Ztot[l] = Zw[l] @ V[l]
    stats["deflated"] += d  # only deflations that will actually be applied
    return d, Wfinal, Ztot, lams, spike_head


def aed_apply(Hp: torch.Tensor, Zp: Optional[torch.Tensor], s: int,
              Zt: torch.Tensor, Wf: torch.Tensor,
              sph: Optional[torch.Tensor]) -> None:
    """Apply a window's transforms to the padded state, in place.

    ``Hp`` (p, N, N), ``Zp`` (p, N, N) or None: the state of
    ``pqr_real_core`` (Z plain: ``Z[l]' A[l] Z[l+1] = H[l]``).  ``Zt``,
    ``Wf``: (p, w, w) window transforms and new window block, ``sph``: (w,)
    new spike column ``H0[s:s+w, s-1]`` (ignored at ``s == 0``), all on the
    state's device.  For every factor l the rows [s, s+w) right of the
    window take ``Zt[l]' .``, the columns [s, s+w) above it take
    ``. Zt[(l+1)%p]``, the window block is replaced by ``Wf[l]`` verbatim,
    and the columns [s, s+w) of ``Zp[l]`` take ``. Zt[l]``.  Everything
    left of and below the window is structurally zero (rows below s+w are
    deflated, H0 is Hessenberg), so it is not touched and stays exactly
    zero; no rounding dust is written below the subdiagonal or inside the
    deflated block.
    """
    e = s + Zt.shape[-1]
    Hp[:, s:e, e:] = torch.matmul(Zt.transpose(1, 2), Hp[:, s:e, e:])
    Hp[:, :s, s:e] = torch.matmul(Hp[:, :s, s:e], torch.roll(Zt, -1, dims=0))
    Hp[:, s:e, s:e] = Wf
    if s >= 1:
        Hp[0, s:e, s - 1] = sph
    if Zp is not None:
        Zp[:, :, s:e] = torch.matmul(Zp[:, :, s:e], Zt)
