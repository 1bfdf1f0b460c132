"""Real generalized periodic Schur core: periodic QZ with signatures.

PyTorch port of the JAX package's exact-f64 core ``ops/pqz_real.py``
(reference src/rgeneralized.jl:49-1083, MB03BD semantics): quasi-
triangularize the Hessenberg factor of a real signed cycle, keeping 2x2
blocks for complex pairs, with eigenvalues in ``alpha/beta * 2^scale``
form.  Same design as the JAX core (see its module docstring): exact
trailing 2x2 window-block products for the shifts, the opening vector from
scaled leading 3x3 window-block products, 2x2 blocks standardized by dlanv2.

Division of labour (as in ``ops/pqz_complex.py``):

* the matrices stay on their device;
* the iteration control runs on the host.  Each iteration gathers the
  diagonals and superdiagonals of all factors and the subdiagonal of H[0]
  on the active window and brings them to the host in ONE transfer.  Tests
  1-3 and the choice among the actions run there:

    SPLIT        deflate a 1x1 block at ``ilast`` (host scaled product)
    DEFLATE_POS  a zero diagonal in a direct triangular factor
    DEFLATE_NEG  a zero diagonal in an inverted factor (zero chasing)
    CZSHIFT      controlled zero shift
    ATTACK       the trailing 2x2 block: a real single-shift 2x2 periodic
                 QZ (``rp2x2ssr``) on the host splits two real eigenvalues
                 with a perfect shift (ladder R "chain" on the device), or
                 the block is kept as a complex pair
    SWEEP        one double-shift sweep: the opening rotations on the host
                 from one gather of the window blocks, then ladder R
                 "open", the chase (rg A, B0, B) and ladder R "close"

* the 2x2-cycle machinery (``qzrot2x2``, ``rp2x2ssr``, ``eig2x2_product``)
  and the shift (``opening_rotations``) run on host floats: a few flops per
  call on entries the host has already read;
* the actions DEFLATE_POS, DEFLATE_NEG and CZSHIFT are one launch each of
  ``csrc/pqz_deflate.cu`` on the card (``ops.pqz_deflate``, shared with the
  complex core); CZSHIFT reads back one flag.

Exceptional shifts (every 10th sweep since the last deflation) are random
rotations: the JAX core splits a PRNG key on every sweep and draws
``normal(sub, (4,))``.  Here the normals come from an explicit
``torch.Generator(seed)``, or, for a run comparable with the JAX core, from
a ``shift_normals`` array indexed by the count of sweeps.

``pqz_real_gen_core_aed`` adds aggressive early deflation and the
host-tail finish of the JAX package's chunked driver (``ops/aed.py``);
``pschur_real_gen_pipeline`` runs it.  ``want_t=False`` (the JAX core's
``rhi``/``clo``, ``wlo``/``whi``): the sweep's and the 2x2 attack's row
updates stop at the window's last column ilast and their column updates
of H start at its first row jlo; Z, the deflation actions (as in the JAX
core) and the final scrub act in full.  The eigenvalues and Z are those
of the run with T; T is valid on its diagonal blocks only.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import AlgoConfig, default_config, verbosity
from ..types import ConvergenceFailure, GeneralizedPeriodicSchur, PSDNotImplemented
from ..utils.circshift import rev_alias
from ..utils.safeprod import frexp_exp, pow2_scale, safeprod_signed
from . import rgopen, sweep_rg
from .lanv2 import lanv2
from .pqz_complex import _WindowGather
from .pqz_deflate import DeflateCores
from .rotations import givens_host

# wall-clock split, iteration count and action tallies of the last
# pschur_real_gen_pipeline call
last_info: dict = {}

_ULP = float(np.finfo(np.float64).eps)


# ---------------------------------------------------------------------------
# 2x2 cycle machinery (host floats)


def _lmul(c, s, M):
    """lmat(c, s) @ M for a 2x2 nested list."""
    return [[c * M[0][0] + s * M[1][0], c * M[0][1] + s * M[1][1]],
            [-s * M[0][0] + c * M[1][0], -s * M[0][1] + c * M[1][1]]]


def _rmul_adj(M, c, s):
    """M @ rmat_adj(c, s) for a 2x2 nested list."""
    return [[M[0][0] * c + M[0][1] * s, M[0][0] * (-s) + M[0][1] * c],
            [M[1][0] * c + M[1][1] * s, M[1][0] * (-s) + M[1][1] * c]]


def qzrot2x2(B, S2):
    """Opening rotation of a single-shift 2x2 periodic QZ sweep (MB03AF
    'Single', reference src/rpschur2x2.jl:1364-1396).  ``B``: p nested 2x2
    lists with the Hessenberg block LAST; ``S2`` its signature.  Returns
    (c, s)."""
    p = len(B)
    Hl = B[p - 1]
    c1, s1, r = givens_host(Hl[0][0], Hl[1][0])
    c2, s2, _ = givens_host(r, 1.0)
    for l in range(p - 2, -1, -1):
        Hl = B[l]
        if S2[l]:
            al = c2 * (c1 * Hl[0][0] + s1 * Hl[0][1])
            be = s1 * c2 * Hl[1][1]
            ga = s2 * Hl[1][1]
            c1, s1, r = givens_host(al, be)
            c2, s2, _ = givens_host(r, ga)
        else:
            al = c1 * s2 * Hl[0][0]
            ga = s1 * Hl[0][0]
            be = s2 * (c1 * Hl[0][1] + s1 * Hl[1][1])
            de = c1 * Hl[1][1] - s1 * Hl[0][1]
            c1, s1, _ = givens_host(de, ga)
            al = c1 * al + s1 * be
            be = c2 * Hl[1][1]
            c2, s2, r = givens_host(be, al)
    Hl = B[p - 1]
    al = s2 * Hl[1][1] - c1 * c2
    be = -s1 * c2
    c1, s1, _ = givens_host(al, be)
    return c1, s1


def rp2x2ssr(B, S2, maxit: int = 40):
    """Real single-shift periodic QZ on a 2x2 block cycle (MB03BF semantics,
    reference src/rpschur2x2.jl:280-317).

    ``B``: p nested 2x2 lists (or a (p, 2, 2) array), Hessenberg block last.
    Returns (B, done): done means the Hessenberg block's subdiagonal became
    negligible (two real eigenvalues).  The JAX function runs ``maxit``
    masked iterations; stopping at ``done`` gives the same B.
    """
    B = [[list(map(float, row)) for row in blk] for blk in B]
    p = len(B)
    for _ in range(maxit):
        c, s = qzrot2x2(B, S2)
        B[p - 1] = _rmul_adj(B[p - 1], c, s)
        for l in range(p - 1):
            Hl = B[l]
            if S2[l]:
                Hl = _lmul(c, s, Hl)
                c, s, r = givens_host(Hl[1][1], -Hl[1][0])
                Hl = [[c * Hl[0][0] + s * Hl[0][1], c * Hl[0][1] - s * Hl[0][0]],
                      [0.0, r]]
            else:
                Hl = _rmul_adj(Hl, c, s)
                c, s, r = givens_host(Hl[0][0], Hl[1][0])
                Hl = [[r, c * Hl[0][1] + s * Hl[1][1]],
                      [0.0, c * Hl[1][1] - s * Hl[0][1]]]
            B[l] = Hl
        B[p - 1] = _lmul(c, s, B[p - 1])
        Hp = B[p - 1]
        if abs(Hp[1][0]) < _ULP * max(abs(Hp[0][0]), abs(Hp[0][1]), abs(Hp[1][1])):
            return B, True
    return B, False


def _renorm(P, e):
    """Rescale the numpy block P by a power of two so that max|P| is in
    [1, 2); the exponent moves to e (the JAX package's ``_renorm2x2``)."""
    m = float(np.max(np.abs(P)))
    if m == 0:
        return P, e
    ee = frexp_exp(m)
    return np.ldexp(P, 1 - ee), e + ee - 1


def eig2x2_product(W, S):
    """Eigenvalues of the signed product of a (p, 2, 2) window-block cycle.

    Returns (w1r, w1i, w2r, w2i, scale1, scale2, beta): the eigenvalues are
    ``(wr + i wi) * 2^scale`` (exact conjugates or exact reals via dlanv2);
    beta = 0 flags a singular inverted factor (an infinite pair).
    """
    P = np.eye(2)
    e = 0
    beta = 1.0
    for l in range(len(S)):
        Wl = np.asarray(W[l], np.float64)
        if S[l]:
            P = P @ Wl
        else:
            a, b, d = Wl[0, 0], Wl[0, 1], Wl[1, 1]
            if a == 0 or d == 0:
                beta = 0.0
            a_ = 1.0 if a == 0 else a
            d_ = 1.0 if d == 0 else d
            P = P @ np.array([[1.0 / a_, -b / (a_ * d_)], [0.0, 1.0 / d_]])
        P, e = _renorm(P, e)
    w1r, w1i, w2r, w2i = lanv2(P[0, 0], P[0, 1], P[1, 0], P[1, 1])[6:]

    def norm_one(wr, wi):
        m = math.hypot(wr, wi)
        if m == 0:
            return wr, wi, 0
        ee = frexp_exp(m)
        return pow2_scale(wr, 1 - ee), pow2_scale(wi, 1 - ee), ee - 1

    w1r, w1i, s1 = norm_one(w1r, w1i)
    w2r, w2i, s2 = norm_one(w2r, w2i)
    return w1r, w1i, w2r, w2i, s1 + e, s2 + e, beta


# ---------------------------------------------------------------------------
# shift and opening rotations of the double-shift sweep


def _tri3inv(B):
    """Inverse of an upper-triangular 3x3 (guarded diagonals)."""
    a, b, c = B[0, 0], B[0, 1], B[0, 2]
    d, ee = B[1, 1], B[1, 2]
    f = B[2, 2]
    a_ = 1.0 if a == 0 else a
    d_ = 1.0 if d == 0 else d
    f_ = 1.0 if f == 0 else f
    return np.array([[1.0 / a_, -b / (a_ * d_), (b * ee - c * d) / (a_ * d_ * f_)],
                     [0.0, 1.0 / d_, -ee / (d_ * f_)],
                     [0.0, 0.0, 1.0 / f_]])


def _inv2(blk):
    a, b, d = blk[0, 0], blk[0, 1], blk[1, 1]
    a_ = 1.0 if a == 0 else a
    d_ = 1.0 if d == 0 else d
    return np.array([[1.0 / a_, -b / (a_ * d_)], [0.0, 1.0 / d_]])


def opening_rotations(W3, W2, S, normals=None):
    """The two rotations that start a Francis double-shift sweep.

    ``W3``: (p, 3, 3) blocks H[l][j:j+3, j:j+3] at the window's first row
    j; ``W2``: (p, 2, 2) blocks at its last two rows.  The Wilkinson shifts
    come from the exact trailing 2x2 of the rotated product, the opening
    vector from the leading 3x3 window-block products, both scaled (the
    JAX package's ``_opening_rotations``).  ``normals``: 4 floats of an
    exceptional sweep (random rotations), else None.  Returns
    (c1, s1, c2, s2).
    """
    p = len(S)
    T3 = np.eye(3)
    eT = 0
    for l in range(1, p):
        blk = np.triu(W3[l])
        T3 = T3 @ (blk if S[l] else _tri3inv(blk))
        T3, eT = _renorm(T3, eT)
    H0w = np.array(W3[0], np.float64)
    H0w[2, 0] = 0.0                 # outside the Hessenberg band
    y1 = T3 @ H0w[:, 0]
    y2 = T3 @ (H0w @ y1)

    B2 = np.eye(2)
    eB = 0
    for l in range(1, p):
        blk = np.triu(W2[l])
        B2 = B2 @ (blk if S[l] else _inv2(blk))
        B2, eB = _renorm(B2, eB)
    B2 = B2 @ np.asarray(W2[0], np.float64)
    B2, eB = _renorm(B2, eB)
    trc = B2[0, 0] + B2[1, 1]
    det = B2[0, 0] * B2[1, 1] - B2[0, 1] * B2[1, 0]

    f = 2.0 ** min(max(eB - eT, -500), 500)
    e1v = np.array([1.0, 0.0, 0.0])
    v = y2 - trc * f * y1 + det * f * f * e1v
    if normals is not None:
        c1, s1, _ = givens_host(normals[0], normals[1])
        c2, s2, _ = givens_host(normals[2], normals[3])
        return c1, s1, c2, s2
    c2, s2, r2 = givens_host(v[1], v[2])
    c1, s1, _ = givens_host(v[0], r2)
    return c1, s1, c2, s2


class _BlockGather:
    """One-gather, one-transfer read of the (p, k, k) diagonal blocks
    H[l][j:j+k, j:j+k] at a list of (j, k) positions."""

    def __init__(self, p, n, device):
        self.p, self.n, self.dev = p, n, device
        self.base = torch.arange(p, device=device) * (n * n)

    def __call__(self, H, spots):
        n = self.n
        idx = []
        for j, k in spots:
            r = torch.arange(j, j + k, device=self.dev)
            flat = (r[:, None] * n + r[None, :]).reshape(-1)
            idx.append((self.base[:, None] + flat[None, :]).reshape(-1))
        g = H.reshape(-1)[torch.cat(idx)].cpu().numpy()
        out, at = [], 0
        for _, k in spots:
            sz = self.p * k * k
            out.append(g[at:at + sz].reshape(self.p, k, k))
            at += sz
        return out


# ---------------------------------------------------------------------------
# main core


def double_shift_sweep(H, Z, S, jlo, ilast, normals=None, want_z=True, blocks=None,
                       want_t=True):
    """One Francis double-shift sweep on the window [jlo, ilast], in place:
    the opening rotations on the host from one gather of the window's
    blocks, then kernel R ``open``, the chase (rg A, B0, B) and R
    ``close``.  ``normals``: those of an exceptional sweep, else None;
    ``blocks``: a ``_BlockGather`` to reuse (one is made if None);
    ``want_t`` False: every update bounded to the window."""
    p, n, _ = H.shape
    blocks = blocks or _BlockGather(p, n, H.device)
    W3, W2 = blocks(H, [(jlo, 3), (ilast - 1, 2)])
    rot = torch.tensor(opening_rotations(W3, W2, S, normals), dtype=torch.float64,
                       device=H.device)
    win = {} if want_t else {"rhi": ilast + 1, "clo": jlo}
    rgopen.rg_ladder(H, Z, "open", jlo, ilast, rot, S, want_z=want_z, **win)
    sweep_rg.rg_chase(H, Z, jlo + 1, ilast, S, want_z=want_z, **win)
    rgopen.rg_ladder(H, Z, "close", ilast - 1, ilast, rot, S, want_z=want_z, **win)


def pqz_real_gen_core(H: torch.Tensor, S: Sequence[bool],
                      Z: Optional[torch.Tensor] = None, want_z: bool = True,
                      maxitfac: int = 120, seed: int = 1234,
                      with_info: bool = False, aggressive: bool = False,
                      want_t: bool = True, shift_normals=None):
    """Run the real generalized periodic QZ iteration.

    Args:
      H: (p, n, n) float64 stack, p >= 2; H[0] upper Hessenberg, H[1:]
         upper triangular (not modified).
      S: sequence of bools, S[0] must be True.
      Z: optional (p, n, n) initial orthogonal stack (accumulated into).
      want_z: accumulate Schur vectors.
      maxitfac: iteration budget factor (maxit = maxitfac * n).
      seed: seed of the torch.Generator that draws exceptional shifts.
      with_info: also return a dict of counters.
      aggressive: fixed per-factor negligibility thresholds
         max(safmin, ||H[l]||_1 ulp) in test 1 (reference
         src/rgeneralized.jl:7,54); a controlled zero shift then raises
         ``PSDNotImplemented`` (the reference's :245-247).
      want_t: keep the whole quasi-triangular T.  False: the sweeps' and
         attacks' updates stay inside the active window (see the module
         docstring); T is valid on its diagonal blocks only, the
         eigenvalues and Z are those of the run with T.
      shift_normals: optional (>= number of sweeps, 4) float array; entry k
         gives the exceptional rotations of the (k+1)-th sweep when that
         sweep is exceptional (the JAX core's ``normal(split_k, (4,))``).

    Returns:
      (T, Z, alpha_r, alpha_i, beta, alphascale, ok): T (p, n, n)
      quasi-triangular stack (T[0] keeps 2x2 blocks for complex pairs), Z
      (or None), host float64 arrays alpha_r, alpha_i, beta, an int32
      array alphascale, and the convergence flag; plus an info dict
      ({"niter", "maxit", "sweeps", "exceptional", "czshift",
      "deflate_pos", "deflate_neg", "splits", "attacks", "pairs",
      "launches"}) when ``with_info``.
    """
    run = _GenRun(H, S, Z, want_z, maxitfac, seed, aggressive, want_t, shift_normals)
    if run.n == 1:
        return run.package(True, with_info)
    run.iterate(run.maxit)
    return run.finish(with_info)


def pqz_real_gen_core_aed(H: torch.Tensor, S: Sequence[bool],
                          Z: Optional[torch.Tensor] = None, want_z: bool = True,
                          maxitfac: int = 120, seed: int = 1234,
                          with_info: bool = False, aggressive: bool = False,
                          want_t: bool = True, shift_normals=None,
                          cfg: AlgoConfig = default_config,
                          chunk_iters: Optional[int] = None):
    """``pqz_real_gen_core`` with aggressive early deflation and the
    host-tail finish, as ``cfg`` sets them (``ops.aed.drive_signed``: the
    schedule of the JAX package's ``pqz_real_gen_core_chunked``).  Same
    arguments and returns; the info dict adds the AED tallies
    (``aed_deflated``, ``host_tail_finished``, ``aed_events``,
    ``aed_hits``, ``aed_s``).  ``chunk_iters``: the cap of the segments
    (None: the JAX driver's).  With ``aed=False, host_tail=-1`` the run is
    ``pqz_real_gen_core``'s, bit for bit."""
    from .aed import aed_tallies, drive_signed
    run = _GenRun(H, S, Z, want_z, maxitfac, seed, aggressive, want_t, shift_normals)
    if run.n == 1:
        out, extra = run.package(True, with_info), aed_tallies()
    else:
        extra = drive_signed(run, cfg, cplx=False, chunk_iters=chunk_iters)
        out = run.finish(with_info)
    return out[:-1] + ({**out[-1], **extra},) if with_info else out


class _GenRun:
    """The state of one run of the real generalized iteration: the device
    stack, the host-side iteration control, the exceptional-shift
    generator and the eigenvalues found so far.  ``iterate`` resumes the
    loop up to an absolute iteration cap, so a driver can stop it between
    iterations (``pqz_real_gen_core_aed``)."""

    def __init__(self, H, S, Z, want_z, maxitfac, seed, aggressive, want_t,
                 shift_normals):
        S = tuple(bool(x) for x in S)
        p, n, _ = H.shape
        if len(S) != p or not S[0]:
            raise ValueError("signature: one entry per factor, S[0] must be True")
        if p < 2:
            raise ValueError("pqz_real_gen_core: p must be >= 2 (use pqr_real_core)")
        if H.dtype != torch.float64:
            raise ValueError("pqz_real_gen_core: H must be float64")
        dev = H.device
        self.S, self.p, self.n, self.dev, self.want_z = S, p, n, dev, want_z
        self.want_t = want_t
        self.aggressive, self.shift_normals = aggressive, shift_normals
        fi = np.finfo(np.float64)
        self.ulp, self.unfl = ulp, unfl = float(fi.eps), float(fi.tiny)
        self.smlnum = smlnum = unfl * (n / ulp)
        self.maxit = maxitfac * n
        self.ziter = -1 if p >= math.log2(unfl) / math.log2(ulp) else 0

        self.H = H = H.clone().contiguous()
        if want_z:
            self.Zs = (torch.eye(n, dtype=H.dtype, device=dev).expand(p, n, n).clone()
                       if Z is None else Z.clone().contiguous())
        else:
            self.Zs = None
        self.counts = {"niter": 0, "maxit": self.maxit, "sweeps": 0, "exceptional": 0,
                       "czshift": 0, "deflate_pos": 0, "deflate_neg": 0, "splits": 0,
                       "attacks": 0, "pairs": 0}
        self.launches0 = {**sweep_rg.launches, **rgopen.launches}
        self.alr, self.ali, self.beta = np.zeros(n), np.zeros(n), np.zeros(n)
        self.scal = np.zeros(n, np.int32)
        self.slots = (self.alr, self.ali, self.beta, self.scal)  # an analysis's order
        self.ilast, self.iiter, self.jiter = n - 1, 0, 0
        if n == 1:
            a, b, s = safeprod_signed(H[:, 0, 0].cpu().tolist(), S)
            self.alr[0], self.beta[0], self.scal[0] = a.real, b, s
            return
        # aggressive: the fixed per-factor thresholds of test 1
        self.agg_tol0 = max(unfl, float(H[0].abs().sum(dim=0).max()) * ulp)
        self.gen = (None if shift_normals is not None
                    else torch.Generator().manual_seed(seed))
        self.cores = DeflateCores(p, S, want_z, ulp, smlnum)
        self.gather = _WindowGather(p, n, dev)
        self.blocks = _BlockGather(p, n, dev)

    def package(self, ok, with_info):
        out = (self.H, self.Zs, self.alr, self.ali, self.beta, self.scal, ok)
        if not with_info:
            return out
        now = {**sweep_rg.launches, **rgopen.launches}
        self.counts["launches"] = {k: now[k] - self.launches0[k] for k in now}
        return out + (self.counts,)

    def iterate(self, it_cap: int) -> None:
        """Run iterations until the window is empty or ``jiter`` reaches
        ``it_cap``."""
        H, Zs, S, p, n, dev, want_z, want_t = (self.H, self.Zs, self.S, self.p, self.n,
                                               self.dev, self.want_z, self.want_t)
        ulp, smlnum, aggressive, agg_tol0 = self.ulp, self.smlnum, self.aggressive, self.agg_tol0
        shift_normals, gen, cores, gather, blocks = (self.shift_normals, self.gen, self.cores,
                                                     self.gather, self.blocks)
        counts, alr, ali, beta, scal = self.counts, self.alr, self.ali, self.beta, self.scal
        Sarr = np.asarray(S)
        lv = np.arange(p)

        def rot_tensor(vals):
            return torch.tensor(list(vals) + [0.0] * (4 - len(vals)), dtype=torch.float64,
                                device=dev)

        ilast, iiter, jiter, ziter = self.ilast, self.iiter, self.jiter, self.ziter
        while ilast >= 0 and jiter < it_cap:
            dl, sup, sub = gather(H, ilast)           # (p, ilast+1) x 2, (ilast+1,)
            iv = np.arange(ilast + 1)

            # Test 1: negligible Hessenberg subdiagonal (bottom-most)
            d0 = dl[0]
            if aggressive:
                tol1 = np.full(ilast + 1, agg_tol0)
            else:
                tol1 = np.abs(np.concatenate([[0.0], d0[:-1]])) + np.abs(d0)
                tol1 = np.maximum(ulp * tol1, smlnum)
            neg1 = (np.abs(sub) <= tol1) & (iv >= 1)
            any1 = bool(neg1.any())
            jstar = int(iv[neg1].max()) if any1 else -1
            jlo = jstar if any1 else 0
            split1 = ilast == 0 or (any1 and jstar == ilast)
            if any1:
                H[0, jstar, jstar - 1] = 0.0
            win = {} if want_t else {"rhi": ilast + 1, "clo": jlo}

            # Tests 2/3: negligible diagonal in a triangular factor
            supm1 = np.concatenate([np.zeros((p, 1)), sup[:, :-1]], axis=1)
            toltr = np.where(iv[None, :] == ilast, np.abs(supm1),
                             np.where(iv[None, :] == jlo, np.abs(sup),
                                      np.abs(supm1) + np.abs(sup)))
            toltr = np.maximum(ulp * toltr, smlnum)
            negtr = (np.abs(dl) <= toltr) & (iv[None, :] >= jlo) & (lv[:, None] >= 1)
            bestj = np.where(negtr, iv[None, :], -1).max(axis=1)
            pos = lv[Sarr & (bestj >= 0) & (lv >= 1)]
            neg = lv[~Sarr & (bestj >= 0) & (lv >= 1)]

            if split1:
                a, b, s = safeprod_signed(dl[:, ilast].tolist(), S)
                alr[ilast], ali[ilast], beta[ilast], scal[ilast] = a.real, 0.0, b, s
                ilast -= 1
                iiter = 0
                if ziter != -1:
                    ziter = 0
                counts["splits"] += 1
            elif pos.size:
                ldef = int(pos.min())
                cores.pos_core(H, Zs, jlo, ldef, int(bestj[ldef]), ilast)
                counts["deflate_pos"] += 1
            elif neg.size:
                ldef = int(neg.min())
                cores.neg_core(H, Zs, jlo, ldef, int(bestj[ldef]), ilast)
                counts["deflate_neg"] += 1
            elif ziter >= 7 or ziter < 0:
                if aggressive:
                    raise PSDNotImplemented(
                        "controlled zero shift with aggressive deflation "
                        "(reference src/rgeneralized.jl:245-247)")
                _, _, zflag = cores.czshift_core(H, Zs, jlo, ilast)
                ziter = 1 if zflag else 0
                counts["czshift"] += 1
            elif jlo == ilast - 1 or n == 2:
                # the trailing 2x2 block (n == 2: the only window is 2x2)
                counts["attacks"] += 1
                j = ilast - 1
                (W,) = blocks(H, [(j, 2)])
                B2 = [W[(t + 1) % p] for t in range(p)]
                S2 = tuple(S[(t + 1) % p] for t in range(p))
                B2, done2 = rp2x2ssr(B2, S2)
                if done2:
                    # perfect-shift cascade (reference :695-709)
                    c1, s1 = 1.0, 1.0
                    for l in range(p - 1, 0, -1):
                        r = B2[l - 1][1][1]
                        hjj = float(W[l, 0, 0])
                        if S[l]:
                            c1, s1, _ = givens_host(c1 * hjj, s1 * r)
                        else:
                            c1, s1, _ = givens_host(c1 * r, s1 * hjj)
                    r = B2[p - 1][1][1]
                    c1, s1, _ = givens_host(c1 * float(W[0, 0, 0]) - r * s1,
                                            c1 * float(W[0, 1, 0]))
                    rgopen.rg_ladder(H, Zs, "chain", j, ilast, rot_tensor((c1, s1)), S,
                                     want_z=want_z, **win)
                else:
                    w1r, w1i, _, _, s1c, s2c, bflag = eig2x2_product(W, S)
                    wi = abs(w1i)
                    alr[j], alr[j + 1] = w1r, w1r
                    ali[j], ali[j + 1] = wi, -wi
                    beta[j], beta[j + 1] = bflag, bflag
                    scal[j], scal[j + 1] = s1c, s2c
                    ilast -= 2
                    iiter = 0
                    if ziter != -1:
                        ziter = 0
                    counts["pairs"] += 1
            else:
                iiter += 1
                ziter += 1
                k = counts["sweeps"]
                counts["sweeps"] += 1
                normals = None
                if iiter % 10 == 0:
                    normals = (shift_normals[k] if shift_normals is not None
                               else torch.randn(4, generator=gen,
                                                dtype=torch.float64).tolist())
                    counts["exceptional"] += 1
                double_shift_sweep(H, Zs, S, jlo, ilast, normals, want_z=want_z,
                                   blocks=blocks, want_t=want_t)
            jiter += 1
        self.ilast, self.iiter, self.jiter, self.ziter = ilast, iiter, jiter, ziter

    def finish(self, with_info: bool):
        """Scrub and package (T, Z, alpha_r, alpha_i, beta, scale, ok[, info])."""
        H = self.H
        ok = self.ilast < 0
        self.counts["niter"] = self.jiter
        # scrub: zero the subdiagonals under real eigenvalues, triangularize the rest
        keep = torch.as_tensor(self.ali[:-1] != 0, device=self.dev)
        sub0 = torch.diagonal(H[0], -1)
        sub0.copy_(torch.where(keep, sub0, torch.zeros_like(sub0)))
        H[1:] = torch.triu(H[1:])
        return self.package(ok, with_info)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pschur_real_gen_pipeline(A: torch.Tensor, S: Sequence[bool], orient: str,
                             want_t: bool = True, want_z: bool = True,
                             maxitfac: int = 120, aggressive: bool = False,
                             cfg: AlgoConfig = default_config) -> GeneralizedPeriodicSchur:
    """Real generalized periodic Schur decomposition: reduction + iteration
    + packaging ('L' reverses the cycle and the result with ``rev_alias``).

    ``p == 1`` runs the real periodic QR core; otherwise an all-direct
    signature takes the plain Hessenberg reduction and a mixed one the
    signed reduction, then ``pqz_real_gen_core_aed`` (AED and the host tail
    as ``cfg`` sets them).  Records the reduction and iteration wall-clock,
    the counters and, for p >= 2, the AED tallies in ``last_info``.
    """
    from .hessenberg import phessenberg_core, phessenberg_signed_core
    from .pqr_real import pqr_real_core
    S = tuple(bool(x) for x in S)
    p = A.shape[0]
    if orient == "L":
        A = torch.flip(A, (0,))
        S = tuple(reversed(S))
    if not S[0]:
        raise ValueError("the leftmost signature entry must be +1 (True); "
                         "rotate the cycle so a direct factor leads")
    if aggressive and p == 1:
        raise PSDNotImplemented("aggressive deflation with p == 1")
    dev = A.device
    A = A.to(torch.float64)
    n = A.shape[-1]
    t0 = time.perf_counter()
    if all(S):
        H, Q = phessenberg_core(A, want_q=want_z)
    else:
        H, Q = phessenberg_signed_core(A, S, want_q=want_z)
    _sync(dev)
    t1 = time.perf_counter()
    if p == 1:
        T, Z, wr, wi, ok, info = pqr_real_core(H, Z=Q, want_z=want_z, want_t=want_t,
                                               with_info=True)
        mag = np.hypot(wr, wi)
        e = np.frexp(np.where(mag == 0, 1.0, mag))[1]
        k = np.where(mag == 0, 0, e - 1).astype(np.int32)
        alpha = (wr + 1j * wi) * np.exp2(-k.astype(float))
        beta, scal = np.ones(n), k
    else:
        T, Z, alr, ali, beta, scal, ok, info = pqz_real_gen_core_aed(
            H, S, Z=Q, want_z=want_z, want_t=want_t, maxitfac=maxitfac,
            with_info=True, aggressive=aggressive, cfg=cfg)
        alpha = alr + 1j * ali
    _sync(dev)
    t2 = time.perf_counter()
    last_info.clear()
    last_info.update(reduce_s=t1 - t0, iterate_s=t2 - t1, converged=ok, **info)
    if verbosity("main") >= 1:
        print(f"[pschur real gen] p={p} n={n}: {info['niter']} iterations "
              f"(budget {info['maxit']}), converged={ok}")
    if not ok:
        raise ConvergenceFailure(-1)
    P = GeneralizedPeriodicSchur(
        S=S, schurindex=0, Ts=T, Zs=Z,
        alpha=torch.as_tensor(alpha, dtype=torch.complex128).to(dev),
        beta=torch.as_tensor(beta, dtype=torch.float64).to(dev),
        alphascale=torch.as_tensor(scal, dtype=torch.int32).to(dev), orientation="R")
    return rev_alias(P) if orient == "L" else P
