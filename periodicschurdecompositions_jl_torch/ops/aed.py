"""Periodic aggressive early deflation (AED) of the three iterations (port
of ``ops/aed.py``): the real one, the real generalized one (a real cycle
with a signature ``S``) and the complex one.

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

The analyses (``aed_analyze``, ``aed_analyze_rg``, ``aed_analyze_cx``) are
host numpy apart from their re-reductions: the window Schur is the native
C++ one (``native.py``), and only when it declines (no convergence; for a
signature also a negligible triangular diagonal) the port's own core on a
CPU tensor (the reference's own decline path); the re-reduction of the
window runs on the caller's device: ``phessenberg_core`` (the reduction
kernel ``csrc/hess.cu`` on the card) for the real iteration,
``phessenberg_signed_core`` (stage 2 in ``csrc/hess_signed.cu``) with a
signature, and their plain versions on the CPU.  ``aed_apply`` writes a
window's transforms into the device state with ``torch.matmul`` on the
state's own device, for float64 and complex128 and any signature (the JAX
package computes ``aed_apply_ff``, ``aed_apply_rg`` and ``aed_apply_cxff``
in ``jnp``, outside any Pallas kernel, so there is no kernel to port here).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..config import verbosity
from ..types import (ConvergenceFailure, GeneralizedPeriodicSchur, IllConditionedException,
                     PeriodicSchur)

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

    PS, spike, kbot = _harvest(PS, spike_of, tol, max_moves, pairs=True)
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


# ---------------------------------------------------------------------------
# signed windows: the real generalized and the complex iterations


def _window_rgpsd(Hwin: np.ndarray, S):
    """Exact-f64 real generalized periodic QZ of the window cycle (host).

    Native first; when it declines (a negligible triangular diagonal, or no
    convergence) the port's ``pqz_real_gen_core`` on a CPU tensor, with the
    deflation actions.  Returns (T, Z, alpha_r, alpha_i, beta, scale), or
    None when neither converges."""
    out = native.pqz_real_gen_cpu(np.asarray(Hwin, np.float64), S)
    if out is not None:
        return out
    from .pqz_real import pqz_real_gen_core
    T, Z, ar, ai, be, sc, ok = pqz_real_gen_core(
        torch.from_numpy(np.array(Hwin, np.float64)), S, want_z=True)
    if not ok:
        return None
    return T.numpy(), Z.numpy(), ar, ai, be, sc


def _window_gpsd(Hwin: np.ndarray, S):
    """Exact complex128 periodic QZ of the window cycle (host): native
    first, the port's ``pqz_complex_core`` on a CPU tensor when it
    declines.  Returns (T, Z, alpha, beta, scale), or None."""
    out = native.pqz_complex_cpu(np.asarray(Hwin, np.complex128), S)
    if out is not None:
        return out
    from .pqz_complex import pqz_complex_core
    T, Z, al, be, sc, ok = pqz_complex_core(
        torch.from_numpy(np.array(Hwin, np.complex128)), S, want_z=True)
    if not ok:
        return None
    return T.numpy(), Z.numpy(), al.numpy(), be.numpy(), sc.numpy()


def _phess_window_signed(Awin: np.ndarray, S, device):
    """Exact signed Hessenberg-triangular reduction of the window cycle on
    ``device`` (``phessenberg_signed_core``: stage 1 ``torch.linalg.qr``,
    stage 2 the ``hess_signed`` kernel on the card; one copy there and one
    back); host arrays (H, Q)."""
    from .hessenberg import phessenberg_signed_core
    H, Q = phessenberg_signed_core(torch.from_numpy(Awin).to(device), S, want_q=True)
    HQ = torch.stack([H, Q]).cpu().numpy()
    return HQ[0], HQ[1]


def _harvest(GPS, spike_of, tol, max_moves, pairs):
    """Deflate trailing blocks with negligible spike entries, moving failed
    blocks out of the way (at most ``max_moves``).  ``pairs``: real
    quasi-triangular T[0] (1x1 and 2x2 blocks), else 1x1 blocks only.
    Returns (GPS, spike, kbot): the window rows [kbot, w) deflate."""
    from ..models.ordschur import ordschur
    w = GPS.Ts.shape[-1]
    spike = spike_of(GPS)
    T0 = GPS.Ts[0].numpy()
    kbot = w
    kept = 0
    moves = 0
    while kbot > kept:
        # block size from T[0]'s ACTUAL subdiagonal, NOT the eigenvalue
        # imaginary parts: ordschur's 2x2 re-solve can round a tiny pair
        # to exactly-real eigenvalues while the block stays 2x2 — a
        # bs=1 decision there would zero a genuine O(1) subdiagonal
        bs = 2 if (pairs and kbot >= 2 and T0[kbot - 1, kbot - 2] != 0) else 1
        if bs == 2 and kbot - 2 < kept:
            break
        if np.abs(spike[kbot - bs:kbot]).max() <= tol:
            kbot -= bs
            continue
        if kept == kbot - bs:
            kept += bs
            continue
        if max_moves is not None and moves >= max_moves:
            break  # move budget spent: keep the harvested tail
        select = np.zeros(w, bool)
        select[:kept] = True
        select[kbot - bs:kbot] = True
        try:
            GPS = ordschur(GPS, list(select))
        except IllConditionedException:
            break
        spike = spike_of(GPS)
        T0 = GPS.Ts[0].numpy()
        kept += bs
        moves += 1
    return GPS, spike, kbot


def _analyze_signed(Hwin, S, beta, tol, max_moves, device, cplx):
    """The signed window analysis shared by ``aed_analyze_rg`` and
    ``aed_analyze_cx`` (the JAX package's two analyses, which differ only
    in the window Schur, the conjugations and the real 2x2 blocks).
    Returns None or (d, Wfinal, Ztot, GPS, spike_head)."""
    S = tuple(bool(x) for x in S)
    p, w, _ = Hwin.shape
    if cplx:
        out = _window_gpsd(Hwin, S)
        if out is None:
            return None
        Tw, Zw, al, be, sc = out
    else:
        out = _window_rgpsd(Hwin, S)
        if out is None:
            return None
        Tw, Zw, ar, ai, be, sc = out
        al = ar + 1j * ai
    GPS = GeneralizedPeriodicSchur(
        S=S, schurindex=0, Ts=torch.from_numpy(np.asarray(Tw)),
        Zs=torch.from_numpy(np.asarray(Zw)), alpha=torch.from_numpy(np.asarray(al)),
        beta=torch.from_numpy(np.asarray(be, np.float64)),
        alphascale=torch.from_numpy(np.asarray(sc, np.int32)), orientation="R")

    def spike_of(PSx):
        z = PSx.Zs[0, 0, :].numpy()
        return beta * (np.conj(z) if cplx else z)

    GPS, spike, kbot = _harvest(GPS, spike_of, tol, max_moves, pairs=not cplx)
    d = w - kbot
    stats["passes"] += 1
    if d == 0:
        return None
    u = kbot
    Tw = GPS.Ts.numpy()
    Zw = GPS.Zs.numpy()

    dt = np.complex128 if cplx else np.float64
    V = np.broadcast_to(np.eye(w, dtype=dt), (p, w, w)).copy()
    spike_head = np.zeros(w, dtype=dt)
    if u > 0:
        sp = spike[:u].copy()
        nrm = np.linalg.norm(sp)
        if nrm > 0.0:
            # Householder P (Hermitian unitary): P @ sp = alpha e1
            if cplx:
                phase = sp[0] / abs(sp[0]) if sp[0] != 0 else 1.0
                alpha = -phase * nrm
            else:
                alpha = -nrm if sp[0] >= 0 else nrm
            v = sp.copy()
            v[0] -= alpha
            vn2 = float(np.real(np.conj(v) @ v))
            P = np.eye(u, dtype=dt)
            if vn2 > 0.0:
                P -= 2.0 * np.outer(v, np.conj(v)) / vn2
            spike_head[0] = alpha
            # P enters factor 0's left side and factor p-1's right side
            # (direct) or left side (inverted).  The leading-u problem is
            # reduced alone: the JAX package embeds it block-diagonally at
            # the full window size (to reuse one compiled reduction), whose
            # exact zeros a reduction on the card need not keep (a rotation
            # generated from two rounding-level entries mixes the blocks)
            Tu = Tw[:, :u, :u]
            if p == 1:
                Aw = (P @ Tu[0] @ P)[None]
            else:
                mids = [Tu[l] for l in range(1, p - 1)]
                last = (Tu[p - 1] @ P) if S[p - 1] else (P @ Tu[p - 1])
                Aw = np.stack([P @ Tu[0]] + mids + [last])
            _, Qw = _phess_window_signed(np.ascontiguousarray(Aw), S, device)
            e1err = np.abs(Qw[0][:, 0] - np.eye(u)[:, 0]).max()
            if not (np.isfinite(e1err) and e1err <= 1e-12):
                return None  # defensive: never corrupt the spike direction
            for l in range(p):
                V[l][:u, :u] = (P @ Qw[l]) if l == 0 else Qw[l]

    Wfinal = np.empty_like(Tw)
    for l in range(p):
        ln = (l + 1) % p
        if S[l]:
            Wfinal[l] = V[l].conj().T @ Tw[l] @ V[ln]
        else:
            Wfinal[l] = V[ln].conj().T @ Tw[l] @ V[l]
        Wfinal[l][u:, :u] = 0.0
        if cplx:
            Wfinal[l] = np.triu(Wfinal[l], -1 if l == 0 else 0)
        elif l == 0:
            Wfinal[l][:u, :u] = np.triu(Wfinal[l][:u, :u], -1)
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:], -1)
            keep = np.abs(np.diag(Tw[0][u:, u:], -1)) > 0
            sub = np.diag(Wfinal[l][u:, u:], -1) * keep
            Wfinal[l][u:, u:] = np.triu(Wfinal[l][u:, u:]) + np.diag(sub, -1)
        else:
            Wfinal[l] = np.triu(Wfinal[l])
    Ztot = np.empty_like(Zw)
    for l in range(p):
        Ztot[l] = Zw[l] @ V[l]
    stats["deflated"] += d
    return d, Wfinal, Ztot, GPS, spike_head


def aed_analyze_rg(Hwin: np.ndarray, S, beta: float, tol: float,
                   max_moves: Optional[int] = None, device="cpu"):
    """Real generalized AED window analysis (host, f64).

    As :func:`aed_analyze` for a signed window: the window Schur is the
    real generalized periodic QZ (``_window_rgpsd``), the moves go through
    the generalized ``ordschur``, and the spike compression re-reduces the
    leading (live) u x u part of the window with the signed reduction on
    ``device``: the compression Householder P enters factor 0's left side
    and factor p-1's right side (direct) or left side (inverted).

    Returns None or (d, Wfinal, Ztot, alpha_r, alpha_i, beta_e, scale,
    spike_head): the eigenvalues in the decomposed (alpha, beta, 2^scale)
    form of the core's state, their trailing d slots final.
    """
    res = _analyze_signed(Hwin, S, beta, tol, max_moves, device, cplx=False)
    if res is None:
        return None
    d, Wf, Zt, GPS, sph = res
    al = GPS.alpha.numpy()
    return (d, Wf, Zt, al.real.copy(), al.imag.copy(), GPS.beta.numpy(),
            GPS.alphascale.numpy(), sph)


def aed_analyze_cx(Hwin: np.ndarray, S, beta: complex, tol: float,
                   max_moves: Optional[int] = None, device="cpu"):
    """Complex AED window analysis (host, complex128): as
    :func:`aed_analyze_rg` with the complex periodic QZ (``_window_gpsd``),
    1x1 blocks and conjugate transposes.

    Returns None or (d, Wfinal, Ztot, alpha, beta_e, scale, spike_head).
    """
    res = _analyze_signed(Hwin, S, beta, tol, max_moves, device, cplx=True)
    if res is None:
        return None
    d, Wf, Zt, GPS, sph = res
    return (d, Wf, Zt, GPS.alpha.numpy(), GPS.beta.numpy(), GPS.alphascale.numpy(), sph)


def aed_apply(Hp: torch.Tensor, Zp: Optional[torch.Tensor], s: int,
              Zt: torch.Tensor, Wf: torch.Tensor,
              sph: Optional[torch.Tensor], S=None, top: int = 0,
              want_t: bool = True) -> None:
    """Apply a window's transforms to the device state, in place.

    ``Hp`` (p, N, N), ``Zp`` (p, N, N) or None: the state of an iteration
    core, float64 or complex128 (Z plain: ``Z[l]^H A[l] Z[l+1] = H[l]`` for
    a direct factor, ``Z[l+1]^H A[l] Z[l] = H[l]`` for an inverted one).
    ``Zt``, ``Wf``: (p, w, w) window transforms and new window block,
    ``sph``: (w,) new spike column ``H0[s:s+w, s-1]`` (ignored at
    ``s == 0``), all on the state's device; ``S``: the signature (None: all
    direct).  For every factor l the rows [s, s+w) right of the window take
    ``Vleft^H .`` and the columns [s, s+w) above it ``. Vright``, with
    ``(Vleft, Vright) = (Zt[l], Zt[l+1])`` for a direct factor and
    ``(Zt[l+1], Zt[l])`` for an inverted one (the JAX ``aed_apply_rg``'s
    sides); the window block is replaced by ``Wf[l]`` verbatim, and the
    columns [s, s+w) of ``Zp[l]`` take ``. Zt[l]``.  Everything left of and
    below the window is structurally zero (rows below s+w are deflated, H0
    is Hessenberg, the other factors triangular), so it is not touched and
    stays exactly zero; no rounding dust is written below the subdiagonal
    or inside the deflated block.

    Without T (``want_t=False``, the reference's window: column updates
    from the first row ``top`` of the diagonal block of H0 that holds row s,
    see ``window_top``; row updates up to the window's last column) the
    rows [0, top) above the window and the columns right of it stay as
    they were, and the rows [top, s) take the values of the unbounded
    product; ``Zp`` is updated in full either way.
    """
    p, w = Zt.shape[0], Zt.shape[-1]
    e = s + w
    nxt = [(l + 1) % p for l in range(p)]
    if S is None:
        S = (True,) * p
    left = [l if S[l] else nxt[l] for l in range(p)]
    right = [nxt[l] if S[l] else l for l in range(p)]
    if want_t:
        Hp[:, s:e, e:] = torch.matmul(Zt[left].mH, Hp[:, s:e, e:])
        Hp[:, :s, s:e] = torch.matmul(Hp[:, :s, s:e], Zt[right])
    elif s > top:
        Hp[:, top:s, s:e] = torch.matmul(Hp[:, :s, s:e], Zt[right])[:, top:]
    Hp[:, s:e, s:e] = Wf
    if s >= 1:
        Hp[0, s:e, s - 1] = sph
    if Zp is not None:
        Zp[:, :, s:e] = torch.matmul(Zp[:, :, s:e], Zt)


# ---------------------------------------------------------------------------
# the drivers' schedule, and the AED driver of the signed iterations


def window_top(sub0: np.ndarray, s: int) -> int:
    """The first row of the diagonal block of H0 that holds row s: one past
    the last exact zero of H0's subdiagonal at rows 1..s (``sub0[r - 1] =
    H0[r, r-1]``), else 0.  The iterations write their deflations as exact
    zeros, and without T the entries above such a zero, right of it, are
    the ones left behind."""
    z = np.flatnonzero(np.asarray(sub0)[:s] == 0)
    return int(z[-1]) + 1 if z.size else 0


def aed_schedule(cfg, n: int, interval_div: int = 4):
    """(window, interval, AED on, host-tail size) of a run at size n, with
    the JAX drivers' formulas and gates: window ``min(48, max(16, n //
    10))``, interval ``max(24, n // interval_div)`` (4 in the real driver,
    ``ops/pqr_ff.py:198-205,227-235``; 6 in the signed ones,
    ``ops/pqz_real_ff.py:739-742``, ``ops/pqz_complex_ff.py:781-784``),
    host tail ``min(64, n // 8)``."""
    w = cfg.aed_window if cfg.aed_window else min(48, max(16, n // 10))
    itv = cfg.aed_interval if cfg.aed_interval else max(24, n // interval_div)
    on = bool(cfg.aed) and w >= 4 and n >= w + 4 and (n >= cfg.aed_min_n
                                                      or cfg.aed_window > 0)
    if cfg.host_tail < 0:
        tail_n = 0
    else:
        tail_n = min(cfg.host_tail, n) if cfg.host_tail > 0 else min(64, n // 8)
    return w, itv, on, tail_n


def signed_chunk_iters(p: int, n: int) -> int:
    """The signed JAX chunked drivers' segment length with the Pallas sweep
    (``ops/pqz_complex_ff.py:739-744``, ``ops/pqz_real_ff.py:708-710``; 256
    at p=8 n=256): here the cap of the AED interval's back-off."""
    per_iter = 4.0 * p * n * n * 1e-8
    return min(256, max(16, int(20.0 / max(per_iter, 1e-9))))


def upload(dev, *arrays):
    """Host arrays (of one dtype) -> tensors on dev in one copy."""
    flat = torch.from_numpy(np.concatenate([np.ravel(a) for a in arrays])).to(dev)
    out, k = [], 0
    for a in arrays:
        out.append(flat[k:k + a.size].view(a.shape))
        k += a.size
    return out


def aed_tallies() -> dict:
    """The drivers' AED tallies, zero."""
    return {"aed_deflated": 0, "host_tail_finished": 0, "aed_events": 0,
            "aed_hits": 0, "aed_s": 0.0}


def drive_signed(run, cfg, cplx: bool, chunk_iters: Optional[int] = None) -> dict:
    """Run a real generalized (``ops/pqz_real.py::_GenRun``) or complex
    (``ops/pqz_complex.py::_CxRun``) iteration to its end with AED and the
    host tail (the logic of the JAX package's
    ``ops/pqz_real.py::pqz_real_gen_core_chunked`` and
    ``ops/pqz_complex_ff.py::pqz_complex_core_ff_chunked``).

    The iteration runs in segments of ``aed_interval`` iterations (doubled
    after two misses, up to ``chunk_iters``, by default
    ``signed_chunk_iters(p, n)``; with AED off segments of ``chunk_iters``).
    At a segment boundary:

    * host tail: once ``2 <= ilast + 1 <= tail_n``, one analysis of the
      leading [0, ilast] window with beta = 0 finishes the run when
      everything deflates;
    * AED: the trailing (p, w, w) window, ``beta = H0[s, s-1]`` (and,
      without T, H0's subdiagonal above it) come to the host in one gather
      and one copy,
      ``aed_analyze_rg`` or ``aed_analyze_cx`` runs on the host (its
      re-reduction on the state's device), and ``aed_apply`` writes the
      deflation into the state (without T, ``run.want_t`` False, inside
      the diagonal block that holds row s, ``window_top``); then ``ilast
      -= d``, ``iiter = 0`` and ``ziter = 0`` unless it is -1.

    The window's eigenvalue slots (``run.slots``: alpha or its real and
    imaginary parts, beta, scale) take the analysis's.  The window Schur is
    the native C++ one: when a run can reach a segment boundary the library
    is built (or loaded) first, and a failed build raises.  Returns the
    tallies (``aed_tallies``): ``aed_deflated`` and ``host_tail_finished``
    (eigenvalues deflated), ``aed_events`` (AED analyses), ``aed_hits``
    (those that deflated) and ``aed_s`` (host seconds of the AED and tail
    analyses, with their window reads).  With AED and the tail off, or at
    sizes that reach no boundary, the run is the core's own.
    """
    p, n, dev, S = run.p, run.n, run.dev, run.S
    extra = aed_tallies()
    chunk = chunk_iters or signed_chunk_iters(p, n)
    aed_w, aed_itv, aed_on, tail_n = aed_schedule(cfg, n, interval_div=6)
    tol = None
    if aed_on or (tail_n >= 2 and chunk < run.maxit):
        native.load()
        # spike-negligibility scale: float64's ulp sqrt(n) max|H0| (the JAX
        # drivers' max-norm contract scale, in true f64)
        tol = run.ulp * float(n) ** 0.5 * float(torch.amax(torch.abs(run.H[0])))
    analysis = aed_analyze_cx if cplx else aed_analyze_rg
    max_moves = None if cfg.aed_max_moves < 0 else cfg.aed_max_moves
    seg = min(chunk, aed_itv) if aed_on else chunk
    misses = 0
    talk = verbosity("main") >= 1
    name = "pqz_complex" if cplx else "pqz_real_gen"

    def analyze(Hwin, beta, what):
        t0 = time.perf_counter()
        try:
            return analysis(Hwin, S, beta, tol, max_moves, device=dev)
        except (np.linalg.LinAlgError, IllConditionedException) as e:
            if talk:
                print(f"[{name} {what}] analysis failed ({e!r}); skipping")
            return None
        finally:
            extra["aed_s"] += time.perf_counter() - t0

    def deflated(res, lo, u, ilast):
        # the window's eigenvalue slots [lo + u, lo + w) are final
        for slot, v in zip(run.slots, res[3:-1]):
            slot[lo + u:lo + len(v)] = v[u:]
        run.ilast, run.iiter = ilast, 0
        if run.ziter != -1:
            run.ziter = 0

    def try_tail():
        # beta = 0: the whole leading window deflates through one window Schur
        m = run.ilast + 1
        t0 = time.perf_counter()
        Hwin = run.H[:, :m, :m].cpu().numpy()
        extra["aed_s"] += time.perf_counter() - t0
        res = analyze(Hwin, 0.0, "tail")
        if res is None or res[0] != m:
            return False
        Ztd, Wfd = upload(dev, res[2], res[1])
        aed_apply(run.H, run.Zs, 0, Ztd, Wfd, None, S, want_t=run.want_t)
        deflated(res, 0, 0, -1)
        extra["host_tail_finished"] += m
        if talk:
            print(f"[{name} tail] host-finished the leading {m}-window")
        return True

    def try_aed():
        # None: no event (the window does not fit); else deflated count
        i, w = run.ilast, aed_w
        if i + 1 < w + 2:
            return None
        s = i - w + 1
        t0 = time.perf_counter()
        parts = [run.H[:, s:s + w, s:s + w].reshape(-1), run.H[0, s, s - 1:s]]
        if not run.want_t:  # H0's subdiagonal above the window: where its block starts
            parts.append(torch.diagonal(run.H[0], -1)[:s])
        g = torch.cat(parts).cpu().numpy()
        extra["aed_s"] += time.perf_counter() - t0
        extra["aed_events"] += 1
        nw = p * w * w
        beta = complex(g[nw]) if cplx else float(g[nw])
        top = 0 if run.want_t else window_top(g[nw + 1:], s)
        res = analyze(g[:nw].reshape(p, w, w), beta, "aed")
        if res is None:
            return 0
        d = res[0]
        Ztd, Wfd, sphd = upload(dev, res[2], res[1], res[-1])
        aed_apply(run.H, run.Zs, s, Ztd, Wfd, sphd, S, top=top, want_t=run.want_t)
        deflated(res, s, w - d, i - d)
        extra["aed_deflated"] += d
        extra["aed_hits"] += 1
        if talk:
            print(f"[{name} aed] deflated {d} at ilast={i} (window {w})")
        return d

    cap = 0
    while True:
        cap = min(cap + seg, run.maxit)
        run.iterate(cap)
        if run.ilast < 0 or cap >= run.maxit:
            break
        if tail_n >= 2 and 2 <= run.ilast + 1 <= tail_n and try_tail():
            break
        if aed_on:
            d = try_aed()
            if d == 0:
                misses += 1
                if misses >= 2:
                    seg = min(seg * 2, chunk)
            elif d is not None:
                misses = 0
                seg = min(chunk, aed_itv)
    return extra
