"""Real periodic QR core: Francis double-shift on a Hessenberg/triangular cycle.

PyTorch port of the JAX package's exact-f64 core ``ops/pqr_real.py``
(reference src/PeriodicSchurDecompositions.jl:322-1096, MB03WD semantics):
quasi-triangularize ``H[0]`` against upper-triangular ``H[1..p-1]``
without forming the product.

Division of labour:

* the matrices stay on their device, ghost-padded to ``(p, n+1, n+1)``;
* the iteration control runs on the host.  Each iteration, kernel G
  (``ops.glue``: the CUDA kernel on a CUDA device, its plain torch version
  on the CPU) computes the band products of the cycle, the Ahues-Tisseur
  deflation scan with the stagnation relaxation and the double-shift first
  column v0, and the host reads them, with the factor entries the repair
  test and the 2x2 deflation need, in ONE transfer; a second transfer (a
  gather of the factor diagonals) happens only in an iteration whose
  repair chain changed those diagonals before a 2x2 deflation.  The
  early-QR start and lanv2 are numpy/float host code;
* the sweep runs through ``ops.sweep.chase_sweep`` and the 2x2 deflation
  through ``ops.deflate.deflate2x2`` (CUDA kernels on a CUDA device); the
  rare repair chain runs as torch ops on the device;
* with ``cfg.nbulges > 1`` (the JAX package's multi-bulge driver,
  ``ops/pqr_ff.py``) a sweeping iteration chases up to ``nbulges`` bulges
  through ``ops.sweep.chase_sweep_mb``.  Their shifts are the eigenvalues
  of the trailing ``2 nbulges`` window of the cycle product: the window of
  every factor comes to the host in one gather and one copy, and the
  product and ``ops.smallschur.hess_eigs_small`` run in numpy.  The JAX ds
  driver scales that product by its band's power-of-two schedule; kernel
  G's band is unscaled float64, so here the product is unscaled too.

The eigenvalue-order check after a 2x2 deflation reads diagonal entries
that no later iteration touches, so it is evaluated once at the end from
the final factors (same values as evaluating it immediately).

Aggressive early deflation and the host-tail finish (the JAX package's
chunked driver) live in ``pqr_real_core_aed``, a driver around the same
loop: ``pqr_real_core`` called directly runs neither, and
``pschur_real_pipeline`` runs the driver (``AlgoConfig.aed``,
``host_tail``; ``ops/aed.py``).

``want_t=False`` (the JAX core's ``tlo``/``thi``): every row update
stops at the active window's last column i and every column update of H
starts at its first row lnew; Z takes every transform in full.  No entry
inside the window depends on one outside it, so the iteration reads the
same numbers as with T, and the returned T is valid on its diagonal blocks
only (no final scrub, as the JAX core).
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import AlgoConfig, default_config, verbosity
from ..types import ConvergenceFailure, PeriodicSchur
from ..utils.circshift import rev_alias
from .deflate import deflate2x2
from .glue import glue_buffers, glue_products_scan_shift
from .householder import reflector_small
from .lanv2 import lanv2
from .rotations import colsk, rowsk
from .smallschur import hess_eigs_small
from .sweep import chase_sweep, chase_sweep_mb, check_mb, normalized, pair_column

# wall-clock split and iteration count of the last pschur_real_pipeline call
# (one caller at a time; concurrent callers take ``reduce_and_iterate``'s info)
last_info: dict = {}


class _BandGather:
    """One-gather, one-transfer read of the diagonals -1..2 of all factors."""

    def __init__(self, p, n, device):
        N = n + 1
        r = torch.arange(n)
        ghost = n * N + n  # a padded entry that stays exactly zero
        idx = []
        for l in range(p):
            base = l * N * N
            idx.append(base + r * N + r)                                   # diag
            idx.append(torch.where(r < n - 1, base + r * N + r + 1, base + ghost))
            idx.append(torch.where(r < n - 2, base + r * N + r + 2, base + ghost))
        idx.append(torch.where(r >= 1, r * N + r - 1, torch.full_like(r, ghost)))
        self.idx = torch.stack(idx).to(device)
        self.p = p

    def __call__(self, Hp):
        g = Hp.view(-1)[self.idx].cpu().numpy()
        p = self.p
        a = g[:3 * p].reshape(p, 3, -1)
        return a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy(), g[3 * p].copy()


def _repair(Hp, Zp, i, lnew, p, cfg, want_z, want_t=True):
    """RQ-type chain restoring triangularity of the trailing factors when
    the product subdiagonal at lnew is negligible but H[0]'s is not
    (reference :589-665).  Torch ops on the device.  Without T the row
    updates land on the columns up to i and H's column updates on the rows
    from lnew (the JAX core's ``thi``/``tlo``)."""
    dt, dev = Hp.dtype, Hp.device
    one = torch.ones((), dtype=dt, device=dev)
    eye2 = torch.eye(2, dtype=dt, device=dev)
    rhi, clo = (None, None) if want_t else (i + 1, lnew)

    def annihilate(fa, fb, k):
        # zero Hp[fa][k, k-1] from the right; partner factor fb from the left
        w, tau, beta = reflector_small(torch.stack([Hp[fa, k, k], Hp[fa, k, k - 1]]))
        wv = torch.stack([w[1], one])  # column pair (k-1, k)
        M2 = eye2 - tau * torch.outer(wv, wv)
        Hp[fa, k, k - 1] = 0.0
        Hp[fa, k, k] = beta
        colsk(Hp[fa], k - 1, M2, hi=k, clo=clo)
        rowsk(Hp[fb], k - 1, M2, lo=k - 1, rhi=rhi)
        if want_z:
            colsk(Zp[fb], k - 1, M2)

    for k in range(i, lnew - 1, -1):
        for f in range(0, p - 1):
            annihilate(f, f + 1, k)
        if k < i:
            annihilate(p - 1, 0, k + 1)
    if cfg.extra_rq:
        # final RQ stage absent from MB03WD (reference :637-652)
        annihilate(p - 1, 0, lnew)
    else:
        # MB03WD forces the leftover to zero, even when wrong
        Hp[p - 1, lnew, lnew - 1] = 0.0


def _at(v, q, n):
    """v[q] with q clamped to [0, n-1] (the JAX driver's ``el``)."""
    return v[min(max(q, 0), n - 1)]


def _francis_pair(hdiag, hsub, hsup, j, n):
    """Shift triple (rt1r, rt1i, rt2r) of the 2x2 product block at rows
    j-1, j of the band (dlahqr's standardization, reference :739-766;
    indices clamped)."""
    a44, a33, a43, a34 = (_at(hdiag, j, n), _at(hdiag, j - 1, n), _at(hsub, j, n),
                          _at(hsup, j - 1, n))
    s4 = abs(a33) + abs(a34) + abs(a43) + abs(a44)
    s4s = 1.0 if s4 == 0 else s4
    a33n, a44n, a34n, a43n = a33 / s4s, a44 / s4s, a34 / s4s, a43 / s4s
    tc = (a33n + a44n) * 0.5
    dc = (a33n - tc) * (a44n - tc) - a34n * a43n
    rtd = np.sqrt(abs(dc))
    q1, q2 = tc + rtd, tc - rtd
    pk = q1 if abs(q1 - a44n) <= abs(q2 - a44n) else q2
    if s4 == 0:
        return 0.0, 0.0, 0.0
    b1r = tc * s4 if dc >= 0 else pk * s4
    return b1r, (rtd * s4 if dc >= 0 else 0.0), b1r


def _shift_v0(hdiag, hsub, hsup, lnew, i, its, n, cfg, ulp):
    """Double-shift first column at the window head (reference :681-801),
    on the host from kernel G's band: the route of ``cfg.allow_early_qr``
    (kernel G computes v0 at ``m = lnew`` alone, with the same arithmetic).

    Returns (m, v0, early): the sweep's start row, its normalized first
    column, and whether the early-QR start moved m below the window top.
    """
    def cl(j):
        return min(max(j, 0), n - 1)

    dat1, dat2 = 0.75, -0.4375
    exc1 = its == 10
    exc2 = (its % 10 == 0) and not exc1
    exc = exc1 or exc2
    if exc1:
        sE = abs(hsub[cl(lnew + 1)]) + abs(hsub[cl(lnew + 2)])
    else:
        sE = abs(hsub[i]) + abs(hsub[cl(i - 1)])
    h44E = dat1 * sE + (hdiag[lnew] if exc1 else hdiag[i])
    h33E = h44E
    h43h34E = dat2 * sE * sE
    rt1r, rt1i, rt2r = _francis_pair(hdiag, hsub, hsup, i, n)
    use_exc = exc or cfg.slicot_shifts

    def first_col(h11, h12, h21, h22, h32):
        if use_exc:
            h44s = h44E - h11
            h33s = h33E - h11
            h21s_ = 1.0 if h21 == 0 else h21
            return ((h33s * h44s - h43h34E) / h21s_ + h12,
                    h22 - h11 - h33s - h44s, h32)
        return pair_column(h11, h12, h21, h22, h32, rt1r, rt1i, rt2r)

    m = lnew
    v0 = normalized(first_col(hdiag[m], hsup[m], hsub[cl(m + 1)],
                               hdiag[cl(m + 1)], hsub[cl(m + 2)]))
    early = False
    if cfg.allow_early_qr:
        # largest m in [lnew+1, i-2] where starting the double shift leaves
        # the product subdiagonal [m, m-1] negligible (scale-invariant, so
        # the unnormalized first columns are tested)
        for mm in range(i - 2, lnew, -1):
            v = first_col(hdiag[mm], hsup[mm], hsub[mm + 1], hdiag[mm + 1],
                          hsub[mm + 2])
            tst1 = abs(v[0]) * (abs(hdiag[mm - 1]) + abs(hdiag[mm])
                                + abs(hdiag[mm + 1]))
            if abs(hsub[mm]) * (abs(v[1]) + abs(v[2])) <= ulp * tst1:
                m, v0, early = mm, normalized(v), True
                break
    return m, v0, early


def window_shifts(Hp, i: int, nb: int):
    """Shift triples (rt1r, rt1i, rt2r) of nb bulges: the eigenvalues of the
    trailing 2 nb x 2 nb window of the cycle product ending at row i
    (i >= 2 nb), in pairs from the bottom.  The window of every factor
    comes to the host in one gather and one copy."""
    Mwin = 2 * nb
    # trailing (Mwin+1) window of every factor; the product's trailing
    # Mwin x Mwin block is exact (the extra row and column carry H[0]'s
    # coupling; the triangular windows multiply exactly)
    s0 = i - Mwin
    W = Hp[:, s0:s0 + Mwin + 1, s0:s0 + Mwin + 1].cpu().numpy()
    Wp = W[0]
    if W.shape[0] > 1:
        Wr = W[1]
        for lf in range(2, W.shape[0]):
            Wr = Wr @ W[lf]
        Wp = Wp @ Wr
    wr, wi = hess_eigs_small(Wp[1:, 1:], niter=5 * Mwin)

    def win_pair(b):
        j1, j2 = Mwin - 1 - 2 * b, Mwin - 2 - 2 * b
        e1r, e1i, e2r, e2i = wr[j1], wi[j1], wr[j2], wi[j2]
        # only a genuine conjugate pair (one block) forms a real first
        # column; complex values of two blocks give two real shifts
        mag = abs(e1i) + abs(e1r) + 1e-300
        conj = (e1i != 0.0 and e2i != 0.0 and abs(e1i + e2i) <= 1e-8 * mag
                and abs(e1r - e2r) <= 1e-8 * mag)
        return e1r, (abs(e1i) if conj else 0.0), e2r

    return [win_pair(b) for b in range(nb)]


def _mb_shifts(Hp, hdiag, hsub, hsup, v0, m, i, its, n, cfg):
    """Shifts of one multi-bulge sweep at the window [m, i] (the JAX
    package's ``ops/pqr_ff.py:909-1012``).

    Returns (v0, sig, nbact): the leading bulge's first column, the
    ``cfg.nbulges`` shift triples (rt1r, rt1i, rt2r) and the number of
    bulges to chase (1 on an exceptional-shift iteration, else as many as
    fit the window).  When the trailing 2 NB window fits below row i, the
    triples are the window eigenvalues of the cycle product, in pairs from
    the bottom, and (unless the shift is exceptional or SLICOT's) the
    leading bulge's column is rebuilt from the bottom pair; otherwise they
    are the 2x2 blocks' shifts of the band at rows i-2b-1, i-2b.
    """
    NB, GAP = cfg.nbulges, cfg.bulge_gap
    exc = its == 10 or its % 10 == 0
    Lw = i - m + 1
    nb_fit = min((Lw - 2) // GAP + 1, Lw // 2)
    nbact = min(max(1 if exc else min(nb_fit, NB), 1), NB)
    if not (n >= 2 * NB + 1 and i >= 2 * NB):
        return v0, [_francis_pair(hdiag, hsub, hsup, i - 2 * b, n) for b in range(NB)], nbact
    sig = window_shifts(Hp, i, NB)
    if not (exc or cfg.slicot_shifts):
        # the leading bulge's column from the bottom window pair
        v0 = normalized(pair_column(_at(hdiag, m, n), _at(hsup, m, n), _at(hsub, m + 1, n),
                                    _at(hdiag, m + 1, n), _at(hsub, m + 2, n), *sig[0]))
    return v0, sig, nbact


def _check_args(H, cfg):
    if H.dtype != torch.float64:
        raise ValueError("pqr_real_core: H must be float64")
    if cfg.nbulges > 1:
        check_mb(cfg.nbulges, cfg.bulge_gap)


def pqr_real_core(H: torch.Tensor, Z: Optional[torch.Tensor] = None,
                  want_z: bool = True, want_t: bool = True, maxitfac: int = 30,
                  cfg: AlgoConfig = default_config, with_info: bool = False,
                  sweep_fn=None):
    """Run the real periodic QR iteration.

    Args:
      H: (p, n, n) float64 stack; H[0] upper Hessenberg, H[1:] upper
         triangular (not modified).
      Z: optional (p, n, n) initial orthogonal stack (accumulated into).
      want_z: accumulate Schur vectors.
      want_t: keep the whole quasi-triangular T.  False: the updates stay
         inside the active window (see the module docstring); T is valid
         on its diagonal blocks only, the eigenvalues and Z are those of
         the run with T.
      maxitfac: iteration budget factor (maxit = maxitfac * n).
      sweep_fn: None, or a callable that takes ``chase_sweep``'s place
         (same arguments and contract; ``parallel.sweep_sharded.ShardedSweep``).
         With it every sweep chases one bulge, whatever ``cfg.nbulges``.

    Returns:
      (T, Z, wr, wi, ok) — wr, wi host float64 arrays, ok a bool — plus an
      info dict ({"niter", "maxit", "sweep_steps", "sweeps", "bulges"}:
      chase steps i - m summed over the sweeps, sweeps, and bulges chased)
      when ``with_info``.
    """
    _check_args(H, cfg)
    p, n, _ = H.shape
    dev = H.device
    maxit = maxitfac * n

    if n == 1:
        lam = float(torch.prod(H[:, 0, 0]))
        Zo = None
        if want_z:
            Zo = (torch.ones((p, 1, 1), dtype=H.dtype, device=dev)
                  if Z is None else Z.clone())
        out = (H.clone(), Zo, np.array([lam]), np.zeros(1), True)
        return out + ({"niter": 0, "maxit": maxit, "sweep_steps": 0, "sweeps": 0,
                       "bulges": 0},) if with_info else out

    run = _Run(H, Z, want_z, maxitfac, cfg, want_t, sweep_fn)
    run.iterate(run.maxit)
    return run.finish(with_info)


class _Run:
    """The state of one run of the real iteration: the padded device stack,
    the host-side iteration control and the eigenvalues found so far.
    ``iterate`` resumes the loop up to an absolute iteration cap, so a
    driver can stop it between iterations (``pqr_real_core_aed``)."""

    def __init__(self, H, Z, want_z, maxitfac, cfg, want_t=True, sweep_fn=None):
        p, n, _ = H.shape
        dev = H.device
        self.p, self.n, self.dev, self.cfg, self.want_z = p, n, dev, cfg, want_z
        self.want_t = want_t
        self.sweep_fn = sweep_fn
        self.ulp = ulp = float(np.finfo(np.float64).eps)
        self.smlnum = float(np.finfo(np.float64).tiny) * (n / ulp)
        self.maxit = maxitfac * n
        # deflation thresholds for the triangular-factor diagonals
        self.hnorms = (ulp * n * torch.amax(torch.sum(torch.abs(H), dim=1),
                                            dim=1)).cpu().numpy()
        N = n + 1
        self.Hp = Hp = torch.zeros((p, N, N), dtype=torch.float64, device=dev)
        Hp[:, :n, :n] = H
        self.Zp = None
        if want_z:
            self.Zp = torch.zeros((p, N, N), dtype=torch.float64, device=dev)
            if Z is None:
                self.Zp[:, :n, :n] = torch.eye(n, dtype=torch.float64, device=dev)
            else:
                self.Zp[:, :n, :n] = Z
        self.gather = _BandGather(p, n, dev)
        self.gbufs = glue_buffers(Hp, n)  # this run's own, reused by every iteration
        self.wr = np.zeros(n)
        self.wi = np.zeros(n)
        self.swaps = []  # (i, w1r, w2r) of real 2x2 deflations, checked at the end
        self.i, self.l, self.its, self.jiter = n - 1, 0, 1, 0
        # chase steps (sum of i - m), sweeps, bulges
        self.steps = self.sweeps = self.bulges = 0

    def iterate(self, it_cap: int) -> None:
        """Run iterations until the window is empty or ``jiter`` reaches
        ``it_cap``."""
        Hp, Zp, p, n, cfg, want_z = self.Hp, self.Zp, self.p, self.n, self.cfg, self.want_z
        want_t = self.want_t
        sweep_fn = self.sweep_fn or chase_sweep
        nbulges = cfg.nbulges if self.sweep_fn is None else 1
        ulp, smlnum, hnorms, gather, gbufs = (self.ulp, self.smlnum, self.hnorms,
                                              self.gather, self.gbufs)
        wr, wi, swaps = self.wr, self.wi, self.swaps
        i, l, its, jiter = self.i, self.l, self.its, self.jiter
        steps, sweeps, bulges = self.steps, self.sweeps, self.bulges
        while i >= 0 and jiter < it_cap:
            # kernel G: band, scan, v0 and the factor entries read below
            g = glue_products_scan_shift(Hp, n, l, i, its, cfg, gbufs)
            hdiag, hsub, hsup, lnew = g.hdiag, g.hsub, g.hsup, g.lnew
            D, U, S0 = g.D, g.U, g.S0
            # without T: row updates up to column i, column updates from row lnew
            rhi, clo = (None, None) if want_t else (i + 1, lnew)

            # ---- subdiagonal repair -------------------------------------
            repaired = False
            if lnew > 0 and p > 1:
                t1r = abs(D[0, lnew - 1]) + abs(D[0, lnew])
                if abs(S0[lnew]) > max(ulp * t1r, smlnum):
                    _repair(Hp, Zp, i, lnew, p, cfg, want_z, want_t)
                    repaired = True
            if lnew > 0:
                Hp[0, lnew, lnew - 1] = 0.0
                S0[lnew] = 0.0

            splitting = lnew >= i - 1
            if not splitting:
                if nbulges > 1:
                    m = lnew
                    v0, sig, nbact = _mb_shifts(Hp, hdiag, hsub, hsup, g.v0, m, i, its, n,
                                                cfg)
                    chase_sweep_mb(Hp, Zp, m, i, v0, sig, nbact, nb=cfg.nbulges,
                                   gap=cfg.bulge_gap, want_z=want_z, rhi=rhi, clo=clo)
                else:
                    if cfg.allow_early_qr:
                        m, v0, early = _shift_v0(hdiag, hsub, hsup, lnew, i, its, n, cfg,
                                                 ulp)
                    else:
                        m, v0, early = lnew, g.v0, False
                    sweep_fn(Hp, Zp, m, i, v0, want_z=want_z, early=early, rhi=rhi,
                             clo=clo)
                    nbact = 1
                steps += i - m
                sweeps += 1
                bulges += nbact
            elif lnew == i:
                wr[i] = hdiag[i]
                wi[i] = 0.0
            else:
                if repaired:
                    D, U, V, S0 = gather(Hp)
                _defl2(Hp, Zp, D, U, S0, i, p, hnorms, ulp, smlnum, wr, wi,
                       swaps, want_z, rhi, clo)

            if splitting:
                i = lnew - 1
                l = 0
                its = 1
            else:
                l = lnew
                its += 1
            jiter += 1
        self.i, self.l, self.its, self.jiter = i, l, its, jiter
        self.steps, self.sweeps, self.bulges = steps, sweeps, bulges

    def finish(self, with_info: bool):
        """Package (T, Z, wr, wi, ok[, info]) from the state (T scrubbed
        only with T wanted, as the JAX core)."""
        n, p, dev, wr, wi = self.n, self.p, self.dev, self.wr, self.wi
        ok = self.i < 0
        T = self.Hp[:, :n, :n].contiguous()
        Zo = self.Zp[:, :n, :n].contiguous() if self.want_z else None
        if self.want_t:
            # scrub subdiagonals of real eigenvalues (reference :1066-1073)
            keep = torch.as_tensor(wi[:-1] != 0, device=dev)
            sub = torch.diagonal(T[0], -1)
            sub.copy_(torch.where(keep, sub, torch.zeros_like(sub)))
            if p > 1:
                T[1:] = torch.triu(T[1:])
        if self.swaps:
            Dfin = torch.diagonal(T, dim1=1, dim2=2).cpu().numpy()
            for (ii, w1r, w2r) in self.swaps:
                l1 = Dfin[0, ii - 1]
                for f in range(1, p):
                    l1 = l1 * Dfin[f, ii - 1]
                if abs(l1 - w1r) > abs(l1 - w2r):
                    wr[ii - 1], wr[ii] = wr[ii], wr[ii - 1]
        out = (T, Zo, wr, wi, ok)
        if with_info:
            return out + ({"niter": self.jiter, "maxit": self.maxit,
                           "sweep_steps": self.steps, "sweeps": self.sweeps,
                           "bulges": self.bulges},)
        return out


def chunk_iters(p: int, n: int) -> int:
    """The JAX chunked driver's segment length (``ops/pqr_ff.py:143-151``,
    476 at p=16 n=512): here the cap of the AED interval's back-off, so the
    event schedule is the JAX driver's (the card has no execute kill)."""
    per_iter = p * n * n * 1e-8
    floor = min(256, max(16, int(45.0 / max(per_iter, 1e-9))))
    return max(floor, int(20.0 / max(per_iter, 1e-9)))


def pqr_real_core_aed(H: torch.Tensor, Z: Optional[torch.Tensor] = None,
                      want_z: bool = True, want_t: bool = True, maxitfac: int = 30,
                      cfg: AlgoConfig = default_config, with_info: bool = False):
    """``pqr_real_core`` with aggressive early deflation and the host-tail
    finish (the AED and host-tail logic of the JAX package's
    ``ops/pqr_ff.py::pqr_real_core_ff_chunked``).

    The iteration runs in segments of ``aed_interval`` iterations (doubled
    after two misses, up to ``chunk_iters(p, n)``; with AED off segments of
    ``chunk_iters(p, n)``).  At a segment boundary:

    * host tail: once ``2 <= i + 1 <= tail_n``, one ``aed_analyze`` of the
      leading [0, i] window with beta = 0 finishes the run when everything
      deflates;
    * AED: the trailing (p, w, w) window, ``beta = H0[s, s-1]`` (and,
      without T, H0's subdiagonal above it) come to the host in one gather
      and one copy, ``ops.aed.aed_analyze`` runs on the host (its
      re-reduction of the window on the state's device, the reduction
      kernel on the card), and ``ops.aed.aed_apply`` writes the deflation
      into the state (without T inside the diagonal block that holds row
      s); then ``i -= d``, ``l = 0``, ``its = 1``.

    The window Schur is the native C++ one: when a run can reach a segment
    boundary the library is built (or loaded) first, and a failed build
    raises.  Same arguments and returns as ``pqr_real_core``; the info dict
    adds ``aed_deflated`` and ``host_tail_finished`` (eigenvalues
    deflated), ``aed_events`` (AED analyses), ``aed_hits`` (those that
    deflated) and ``aed_s`` (host seconds of the AED and tail analyses,
    with their window reads).  With AED and the tail off, or at sizes that
    reach no boundary, the run is ``pqr_real_core``'s.
    """
    from .. import native
    from ..types import IllConditionedException
    from .aed import aed_analyze, aed_apply, aed_schedule, aed_tallies, upload, window_top
    _check_args(H, cfg)
    p, n, _ = H.shape
    extra = aed_tallies()
    if n == 1:
        out = pqr_real_core(H, Z, want_z=want_z, want_t=want_t, maxitfac=maxitfac,
                            cfg=cfg, with_info=with_info)
        return out[:-1] + ({**out[-1], **extra},) if with_info else out
    run = _Run(H, Z, want_z, maxitfac, cfg, want_t)
    maxit, dev = run.maxit, run.dev
    chunk = chunk_iters(p, n)
    aed_w, aed_itv, aed_on, tail_n = aed_schedule(cfg, n)
    tol = None
    if aed_on or (tail_n >= 2 and chunk < maxit):
        native.load()
        # spike-negligibility scale: zeroing a spike entry perturbs H0 by
        # exactly that entry; the contract is a max-norm relative backward
        # error <= 1e-12 (JAX ops/pqr_ff.py:209-219, in float64's ulp)
        tol = run.ulp * float(n) ** 0.5 * float(torch.amax(torch.abs(H[0])))
    max_moves = None if cfg.aed_max_moves < 0 else cfg.aed_max_moves
    seg = min(chunk, aed_itv) if aed_on else chunk
    misses = 0
    talk = verbosity("main") >= 1

    def analyze(Hwin, beta, what):
        t0 = time.perf_counter()
        try:
            return aed_analyze(Hwin, beta, tol, max_moves, device=dev)
        except (np.linalg.LinAlgError, IllConditionedException) as e:
            if talk:
                print(f"[pqr_real {what}] analysis failed ({e!r}); skipping")
            return None
        finally:
            extra["aed_s"] += time.perf_counter() - t0

    def try_tail():
        # beta = 0: the whole leading window deflates through one window Schur
        m = run.i + 1
        t0 = time.perf_counter()
        Hwin = run.Hp[:, :m, :m].cpu().numpy()
        extra["aed_s"] += time.perf_counter() - t0
        res = analyze(Hwin, 0.0, "tail")
        if res is None or res[0] != m:
            return False
        _, Wf, Zt, lams, _ = res
        Ztd, Wfd = upload(dev, Zt, Wf)
        aed_apply(run.Hp, run.Zp, 0, Ztd, Wfd, None, want_t=want_t)
        run.wr[:m] = lams.real
        run.wi[:m] = lams.imag
        run.i, run.l, run.its = -1, 0, 1
        extra["host_tail_finished"] += m
        if talk:
            print(f"[pqr_real tail] host-finished the leading {m}-window")
        return True

    def try_aed():
        # None: no event (the window does not fit); else deflated count
        i, w = run.i, aed_w
        if i + 1 < w + 2:
            return None
        s = i - w + 1
        t0 = time.perf_counter()
        parts = [run.Hp[:, s:s + w, s:s + w].reshape(-1), run.Hp[0, s, s - 1:s]]
        if not want_t:  # H0's subdiagonal above the window: where its block starts
            parts.append(torch.diagonal(run.Hp[0], -1)[:s])
        g = torch.cat(parts).cpu().numpy()
        extra["aed_s"] += time.perf_counter() - t0
        extra["aed_events"] += 1
        nw = p * w * w
        top = 0 if want_t else window_top(g[nw + 1:], s)
        res = analyze(g[:nw].reshape(p, w, w), float(g[nw]), "aed")
        if res is None:
            return 0
        d, Wf, Zt, lams, sph = res
        Ztd, Wfd, sphd = upload(dev, Zt, Wf, sph)
        aed_apply(run.Hp, run.Zp, s, Ztd, Wfd, sphd, top=top, want_t=want_t)
        u = w - d
        run.wr[s + u:s + w] = lams.real[u:]
        run.wi[s + u:s + w] = lams.imag[u:]
        run.i, run.l, run.its = i - d, 0, 1
        extra["aed_deflated"] += d
        extra["aed_hits"] += 1
        if talk:
            print(f"[pqr_real aed] deflated {d} at i={i} (window {w})")
        return d

    cap = 0
    while True:
        cap = min(cap + seg, maxit)
        run.iterate(cap)
        if run.i < 0 or cap >= maxit:
            break
        if tail_n >= 2 and 2 <= run.i + 1 <= tail_n and try_tail():
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
    out = run.finish(with_info)
    return out[:-1] + ({**out[-1], **extra},) if with_info else out


def _defl2(Hp, Zp, D, U, S0, i, p, hnorms, ulp, smlnum, wr, wi, swaps, want_z,
           rhi=None, clo=None):
    """2x2 deflation at rows i-1, i: host scalars, then the device branch
    (``rhi``/``clo``: the want_t=False window, None: unbounded)."""
    sc = defl2_scalars(D, U, S0, i, p, hnorms, ulp, smlnum)
    (w1r, w1i, w2r, w2i), lam_real = sc["w"], sc["lam_real"]
    wr[i - 1], wi[i - 1], wr[i], wi[i] = w1r, w1i, w2r, w2i
    deflate2x2(Hp, Zp, i, sc["jmin"], sc["jmax"], sc["cs0"], sc["sn0"],
               sc["replace0"], sc["finzero"], sc["thr"], want_z=want_z, rhi=rhi, clo=clo)
    if lam_real:
        swaps.append((i, w1r, w2r))


def defl2_scalars(D, U, S0, i, p, hnorms, ulp, smlnum):
    """Host scalars of the 2x2 deflation at rows i-1, i (reference :895-958).

    D, U: (p, n) diagonals 0 and +1 of the factors; S0[r] = H[0][r, r-1];
    hnorms: (p,) negligible-diagonal thresholds.  Returns a dict with the
    lanv2 eigenvalues ``w`` = (w1r, w1i, w2r, w2i), ``lam_real`` and the
    arguments of ``deflate2x2`` (jmin, jmax, cs0, sn0, replace0, finzero,
    thr).
    """
    hp22, hp12, hp11 = 1.0, 0.0, 1.0
    for f in range(1, p):
        d1, d2, u = D[f, i - 1], D[f, i], U[f, i - 1]
        hp12 = hp11 * u + hp12 * d2
        hp11 = hp11 * d1
        hp22 = hp22 * d2
    a11, a12, a21, a22 = D[0, i - 1], U[0, i - 1], S0[i], D[0, i]
    bh11 = a11 * hp11
    bh12 = a11 * hp12 + a12 * hp22
    bh21 = a21 * hp11
    bh22 = a21 * hp12 + a22 * hp22
    (_, _, cc_, _, cs0, sn0, w1r, w1i, w2r, w2i) = lanv2(bh11, bh12, bh21, bh22)
    lam_real = cc_ == 0

    # negligible diagonals of the triangular factors
    dm1 = np.abs(D[:, i - 1])
    dm0 = np.abs(D[:, i])
    fs = np.arange(p)
    mins = fs[(dm1 <= hnorms) & (fs >= 1)]
    maxs = fs[(dm0 <= hnorms) & (fs >= 1)]
    jmin = int(mins.min()) if mins.size else -1
    jmax = int(maxs.max()) if maxs.size else -1
    if jmin >= 0 and jmax >= 0:
        # shorter-path choice (reference :951-958)
        if jmin <= p - jmax:
            jmax = -1
        else:
            jmin = -1

    a1 = math.hypot(w1r, w1i)
    a2 = math.hypot(w2r, w2i)
    amx, amn = max(a1, a2), min(a1, a2)
    prod0 = (w1r == 0 and w1i == 0) or (w2r == 0 and w2i == 0)
    replace0 = ((jmax >= 1) and lam_real) or prod0 or \
        ((not prod0) and lam_real and amn < ulp * amx)
    finzero = (jmax >= 0) or (bh21 == 0)
    return {"w": (w1r, w1i, w2r, w2i), "lam_real": lam_real, "jmin": jmin,
            "jmax": jmax, "cs0": cs0, "sn0": sn0, "replace0": bool(replace0),
            "finzero": bool(finzero), "thr": max(smlnum, ulp * amx)}


def _sync(dev):
    # the caller's stream only: concurrent callers on other streams of the
    # card do not wait for each other
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def reduce_and_iterate(A: torch.Tensor, want_t: bool = True, want_z: bool = True,
                       maxitfac: int = 30, cfg: AlgoConfig = default_config):
    """The reduction and ``pqr_real_core_aed`` on a right-oriented cycle.
    Returns (T, Z, wr, wi, ok, info), the info dict with the reduction's
    and the iteration's wall-clock (``reduce_s``, ``iterate_s``); touches
    no module state, so threads may call it together (each on its own
    stream)."""
    from .hessenberg import phessenberg_core
    dev = A.device
    t0 = time.perf_counter()
    H, Q = phessenberg_core(A, want_q=want_z)
    _sync(dev)
    t1 = time.perf_counter()
    T, Z, wr, wi, ok, info = pqr_real_core_aed(H, Z=Q, want_z=want_z, want_t=want_t,
                                               maxitfac=maxitfac, cfg=cfg,
                                               with_info=True)
    _sync(dev)
    t2 = time.perf_counter()
    return T, Z, wr, wi, ok, {"reduce_s": t1 - t0, "iterate_s": t2 - t1, **info}


def pschur_real_pipeline(A: torch.Tensor, orient: str, want_t: bool = True,
                         want_z: bool = True, maxitfac: int = 30,
                         cfg: AlgoConfig = default_config) -> PeriodicSchur:
    """Full real periodic Schur decomposition: reduction + iteration
    (``pqr_real_core_aed``: AED and the host tail as ``cfg`` sets them) +
    packaging.

    Records the reduction and iteration wall-clock, the iteration count and
    the AED tallies in ``last_info``.
    """
    p = A.shape[0]
    if orient == "L":
        A = torch.flip(A, (0,))
    dev = A.device
    T, Z, wr, wi, ok, info = reduce_and_iterate(A, want_t=want_t, want_z=want_z,
                                                maxitfac=maxitfac, cfg=cfg)
    last_info.clear()
    last_info.update(converged=ok, **info)
    if verbosity("main") >= 1:
        print(f"[pschur real] p={p} n={A.shape[-1]}: {info['niter']} iterations "
              f"(budget {info['maxit']}), converged={ok}")
    if not ok:
        raise ConvergenceFailure(-1)
    values = torch.complex(torch.as_tensor(wr), torch.as_tensor(wi)).to(dev)
    P = PeriodicSchur(Ts=T, Zs=Z, values=values, orientation="R", schurindex=0)
    if orient == "L":
        P = rev_alias(P)
    return P
