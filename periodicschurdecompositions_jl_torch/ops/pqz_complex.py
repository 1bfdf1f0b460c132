"""Complex generalized periodic Schur core: single-shift periodic QZ.

PyTorch port of the JAX package's exact-c128 core ``ops/pqz_complex.py``
(reference src/generalized.jl:166-931, MB03BZ semantics).  Given ``H[0]``
upper Hessenberg, ``H[1..p-1]`` upper triangular (complex) and a signature
``S`` with ``S[0] = True``, compute unitary ``Z[l]`` that make the cycle
upper triangular, with the product's eigenvalues in ``alpha/beta * 2^scale``
form.

Division of labour (as in ``ops/pqr_real.py``):

* the matrices stay on their device;
* the iteration control runs on the host.  Each iteration gathers the
  diagonals and superdiagonals of all factors and the subdiagonal of H[0]
  on the active window into one tensor and brings it to the host in ONE
  transfer.  Tests 1-3 and the choice among the actions run there:

    0 SPLIT        deflate a 1x1 block at ``ilast`` (host scaled product)
    1 DEFLATE_POS  a zero diagonal in a direct triangular factor
    2 DEFLATE_NEG  a zero diagonal in an inverted factor (zero chasing)
    3 CZSHIFT      controlled zero shift
    4 SWEEP        one single-shift QZ sweep over the window

* SWEEP runs ``ops.sweep_cx.qz_shift`` (kernel S) into a device buffer and
  then ``ops.sweep_cx.qz_sweep`` (kernels A, B0, B) on it; the actions
  1-3 are one launch each of ``csrc/pqz_deflate.cu`` on the card
  (``ops.pqz_deflate``); CZSHIFT reads back one flag.

Exceptional shifts (every 10th iteration since the last split) are random
rotations.  The JAX package splits a PRNG key on every sweep and draws
``normal(sub, (4,))``; here the normals come from an explicit
``torch.Generator(seed)``, or, for a bit-comparable run, from a
``shift_normals`` array of shape (maxit, 4) indexed by the count of sweeps.

Deviations from the reference are those of the JAX core (mutually
exclusive deflation tests with priority 1>2>3>4, the ``smlnum`` floor in
the negligibility tests, full-range updates).  ``pqz_complex_core_aed``
adds aggressive early deflation and the host-tail finish of the JAX
package's chunked driver (``ops/aed.py``); ``pschur_complex_pipeline`` runs
it.  ``want_t=False`` (the JAX core's ``rhi``/``clo``): the sweep's row
updates stop at the window's last column ilast and its column updates of H
start at its first row jlo; Z, the deflation actions (as in the JAX core)
and the final rescaling of the diagonals act in full.  The eigenvalues and
Z are those of the run with T; T is valid on its diagonal only.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import AlgoConfig, default_config, verbosity
from ..types import ConvergenceFailure, GeneralizedPeriodicSchur
from ..utils.circshift import rev_alias
from ..utils.safeprod import safeprod_signed
from . import sweep_cx
from .pqz_deflate import DeflateCores
from .rotations import givens_host

# wall-clock split, iteration count and action tallies of the last
# pschur_complex_pipeline call
last_info: dict = {}


class _WindowGather:
    """One-gather, one-transfer read of diag, superdiag (all factors) and
    the H[0] subdiagonal, cut to the rows 0..ilast of the active window."""

    def __init__(self, p, n, device):
        r = torch.arange(n)
        nn = n * n
        idx = []
        for l in range(p):
            idx.append(l * nn + r * n + r)
        for l in range(p):
            idx.append(torch.where(r < n - 1, l * nn + r * n + r + 1, -1))
        idx.append(torch.where(r >= 1, r * n + r - 1, -1))
        idx = torch.stack(idx)
        self.mask = (idx >= 0).to(device)
        self.idx = idx.clamp(min=0).to(device)
        self.p = p

    def __call__(self, H, ilast):
        g = H.view(-1)[self.idx[:, :ilast + 1]]
        g = torch.where(self.mask[:, :ilast + 1], g, torch.zeros_like(g))
        g = g.cpu().numpy()
        p = self.p
        return g[:p], g[p:2 * p], g[2 * p]


def _exceptional_cs(fg):
    """(c + 0j, s) of the random exceptional rotation from 4 normals."""
    c, s, _ = givens_host(complex(fg[0], fg[1]), complex(fg[2], fg[3]))
    return torch.tensor([c, s], dtype=torch.complex128)


def pqz_complex_core(H: torch.Tensor, S: Sequence[bool],
                     Z: Optional[torch.Tensor] = None, want_z: bool = True,
                     maxitfac: int = 30, seed: int = 1234,
                     with_info: bool = False, want_t: bool = True,
                     shift_normals=None):
    """Run the complex periodic QZ iteration.

    Args:
      H: (p, n, n) complex128 stack; H[0] upper Hessenberg, H[1:] upper
         triangular (not modified).
      S: sequence of bools, S[0] must be True.
      Z: optional (p, n, n) initial unitary stack (accumulated into).
      want_z: accumulate Schur vectors.
      maxitfac: iteration budget factor (maxit = maxitfac * n).
      seed: seed of the torch.Generator that draws exceptional shifts.
      with_info: also return a dict of counters.
      want_t: keep the whole triangular T.  False: the sweeps' updates stay
         inside the active window (see the module docstring); T is valid on
         its diagonal only, the eigenvalues and Z are those of the run with T.
      shift_normals: optional (>= number of sweeps, 4) float array; entry k
         gives the exceptional rotation of the (k+1)-th sweep when that
         sweep is exceptional (the JAX core's ``normal(split_k, (4,))``).

    Returns:
      (T, Z, alpha, beta, alphascale, ok): T (p, n, n) triangular, Z (or
      None), alpha (n,) complex128, beta (n,) float64, alphascale (n,)
      int32 (host-made, on H's device) and the convergence flag; plus an
      info dict ({"niter", "maxit", "sweeps", "exceptional", "czshift",
      "deflate_pos", "deflate_neg", "splits", "launches"}) when
      ``with_info``.
    """
    run = _CxRun(H, S, Z, want_z, maxitfac, seed, want_t, shift_normals)
    if run.n == 1:
        return run.package(True, with_info)
    run.iterate(run.maxit)
    return run.finish(with_info)


def pqz_complex_core_aed(H: torch.Tensor, S: Sequence[bool],
                         Z: Optional[torch.Tensor] = None, want_z: bool = True,
                         maxitfac: int = 30, seed: int = 1234,
                         with_info: bool = False, want_t: bool = True,
                         shift_normals=None, cfg: AlgoConfig = default_config,
                         chunk_iters: Optional[int] = None):
    """``pqz_complex_core`` with aggressive early deflation and the
    host-tail finish, as ``cfg`` sets them (``ops.aed.drive_signed``: the
    schedule of the JAX package's ``pqz_complex_core_ff_chunked``).  Same
    arguments and returns; the info dict adds the AED tallies
    (``aed_deflated``, ``host_tail_finished``, ``aed_events``,
    ``aed_hits``, ``aed_s``).  ``chunk_iters``: the cap of the segments
    (None: the JAX driver's).  With ``aed=False, host_tail=-1`` the run is
    ``pqz_complex_core``'s, bit for bit."""
    from .aed import aed_tallies, drive_signed
    run = _CxRun(H, S, Z, want_z, maxitfac, seed, want_t, shift_normals)
    if run.n == 1:
        out, extra = run.package(True, with_info), aed_tallies()
    else:
        extra = drive_signed(run, cfg, cplx=True, chunk_iters=chunk_iters)
        out = run.finish(with_info)
    return out[:-1] + ({**out[-1], **extra},) if with_info else out


class _CxRun:
    """The state of one run of the complex iteration: the device stack, the
    host-side iteration control, the exceptional-shift generator and the
    eigenvalues found so far.  ``iterate`` resumes the loop up to an
    absolute iteration cap, so a driver can stop it between iterations
    (``pqz_complex_core_aed``)."""

    def __init__(self, H, S, Z, want_z, maxitfac, seed, want_t, shift_normals):
        S = tuple(bool(x) for x in S)
        p, n, _ = H.shape
        if len(S) != p or not S[0]:
            raise ValueError("signature: one entry per factor, S[0] must be True")
        if H.dtype != torch.complex128:
            raise ValueError("pqz_complex_core: H must be complex128")
        dev = H.device
        self.S, self.p, self.n, self.dev, self.want_z = S, p, n, dev, want_z
        self.want_t, self.shift_normals = want_t, shift_normals
        fi = np.finfo(np.float64)
        self.ulp = ulp = float(fi.eps)
        unfl = float(fi.tiny)
        self.smlnum = smlnum = unfl * (n / ulp)
        self.safmin = unfl
        self.maxit = maxitfac * n
        self.ziter = -1 if p >= math.log2(unfl) / math.log2(ulp) else 0

        self.H = H = H.clone().contiguous()
        if want_z:
            self.Zs = (torch.eye(n, dtype=H.dtype, device=dev).expand(p, n, n).clone()
                       if Z is None else Z.clone().contiguous())
        else:
            self.Zs = None
        self.counts = {"niter": 0, "maxit": self.maxit, "sweeps": 0, "exceptional": 0,
                       "czshift": 0, "deflate_pos": 0, "deflate_neg": 0, "splits": 0}
        self.launches0 = dict(sweep_cx.launches)
        self.alpha = np.zeros(n, complex)
        self.beta = np.zeros(n)
        self.scal = np.zeros(n, np.int32)
        self.slots = (self.alpha, self.beta, self.scal)  # an analysis's order
        self.ilast, self.iiter, self.jiter = n - 1, 0, 0
        if n == 1:
            a, b, s = safeprod_signed(H[:, 0, 0].cpu().tolist(), S)
            self.alpha[0], self.beta[0], self.scal[0] = a, b, s
            return
        self.gen = (None if shift_normals is not None
                    else torch.Generator().manual_seed(seed))
        self.cores = DeflateCores(p, S, want_z, ulp, smlnum)
        self.gather = _WindowGather(p, n, dev)
        self.cs = torch.zeros(2, dtype=torch.complex128, device=dev)

    def package(self, ok, with_info):
        dev = self.dev
        out = (self.H, self.Zs, torch.as_tensor(self.alpha).to(dev),
               torch.as_tensor(self.beta).to(dev), torch.as_tensor(self.scal).to(dev), ok)
        if not with_info:
            return out
        self.counts["launches"] = {k: sweep_cx.launches[k] - self.launches0[k]
                                   for k in self.launches0}
        return out + (self.counts,)

    def iterate(self, it_cap: int) -> None:
        """Run iterations until the window is empty or ``jiter`` reaches
        ``it_cap``."""
        H, Zs, S, p, want_z, want_t = (self.H, self.Zs, self.S, self.p, self.want_z,
                                       self.want_t)
        ulp, smlnum, shift_normals, gen = self.ulp, self.smlnum, self.shift_normals, self.gen
        cores, gather, cs, counts = self.cores, self.gather, self.cs, self.counts
        alpha, beta, scal = self.alpha, self.beta, self.scal
        Sarr = np.asarray(S)
        lv = np.arange(p)

        ilast, iiter, jiter, ziter = self.ilast, self.iiter, self.jiter, self.ziter
        while ilast >= 0 and jiter < it_cap:
            dl, sup, sub = gather(H, ilast)           # (p, ilast+1) x 2, (ilast+1,)
            iv = np.arange(ilast + 1)

            # Test 1: negligible Hessenberg subdiagonal (bottom-most)
            d0 = dl[0]
            tol1 = np.abs(np.concatenate([[0], d0[:-1]])) + np.abs(d0)
            tol1 = np.maximum(ulp * tol1, smlnum)
            neg1 = (np.abs(sub) <= tol1) & (iv >= 1)
            any1 = bool(neg1.any())
            jstar = int(iv[neg1].max()) if any1 else -1
            jlo = jstar if any1 else 0
            split1 = ilast == 0 or (any1 and jstar == ilast)
            if any1:
                H[0, jstar, jstar - 1] = 0.0

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
                alpha[ilast], beta[ilast], scal[ilast] = a, b, s
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
                _, _, zflag = cores.czshift_core(H, Zs, jlo, ilast)
                ziter = 1 if zflag else 0
                counts["czshift"] += 1
            else:
                iiter += 1
                ziter += 1
                k = counts["sweeps"]
                counts["sweeps"] += 1
                if iiter % 10 == 0:
                    fg = (shift_normals[k] if shift_normals is not None
                          else torch.randn(4, generator=gen, dtype=torch.float64).tolist())
                    cs.copy_(_exceptional_cs(fg))
                    counts["exceptional"] += 1
                else:
                    sweep_cx.qz_shift(H, jlo, ilast, S, out=cs)
                sweep_cx.qz_sweep(H, Zs, jlo, ilast, cs, S, want_z=want_z,
                                  rhi=None if want_t else ilast + 1,
                                  clo=None if want_t else jlo)
            jiter += 1
        self.ilast, self.iiter, self.jiter, self.ziter = ilast, iiter, jiter, ziter

    def finish(self, with_info: bool):
        """Post-process and package (T, Z, alpha, beta, scale, ok[, info])."""
        ok = self.ilast < 0
        self.counts["niter"] = self.jiter
        _postprocess(self.H, self.Zs, self.S, self.safmin, self.want_z)
        return self.package(ok, with_info)


def _postprocess(H, Z, S, safmin, want_z):
    """Rescale the triangular diagonals to nonnegative reals, pushing the
    phases into Z and the neighbour factor (reference
    src/generalized.jl:860-908)."""
    p = H.shape[0]
    for l in range(p - 1, 0, -1):
        d = torch.diagonal(H[l])
        absd = d.abs()
        big = absd > safmin
        den = torch.where(absd == 0, torch.ones_like(absd), absd)
        # conj(d) / |d| on the parts (a complex-by-complex division would
        # round differently from the JAX package's)
        z = torch.where(big, torch.complex(d.real / den, -(d.imag / den)),
                        torch.ones_like(d))
        newdiag = torch.where(big, absd.to(d.dtype), d)
        if S[l]:
            H[l] = z[:, None] * H[l]
            sf = z
        else:
            H[l] = H[l] * z[None, :]
            sf = z.conj()
        torch.diagonal(H[l]).copy_(newdiag)
        if want_z:
            Z[l] = Z[l] * sf.conj()[None, :]
        if S[l - 1]:
            H[l - 1] = H[l - 1] * sf.conj()[None, :]
        else:
            H[l - 1] = sf[:, None] * H[l - 1]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pschur_complex_pipeline(A: torch.Tensor, S: Sequence[bool], orient: str,
                            want_t: bool = True, want_z: bool = True,
                            maxitfac: int = 30,
                            cfg: AlgoConfig = default_config) -> GeneralizedPeriodicSchur:
    """Complex generalized periodic Schur decomposition: reduction +
    iteration (``pqz_complex_core_aed``: AED and the host tail as ``cfg``
    sets them) + packaging, right orientation internally ('L' reverses the
    cycle and the result with ``rev_alias``).

    Records the reduction and iteration wall-clock, the counters and the
    AED tallies in ``last_info``.
    """
    from .hessenberg import phessenberg_core, phessenberg_signed_core
    S = tuple(bool(x) for x in S)
    p = A.shape[0]
    if orient == "L":
        A = torch.flip(A, (0,))
        S = tuple(reversed(S))
    if not S[0]:
        raise ValueError("the leftmost signature entry must be +1 (True); "
                         "rotate the cycle so a direct factor leads")
    dev = A.device
    A = A.to(torch.complex128)
    t0 = time.perf_counter()
    if all(S):
        H, Q = phessenberg_core(A, want_q=want_z)
    else:
        H, Q = phessenberg_signed_core(A, S, want_q=want_z)
    _sync(dev)
    t1 = time.perf_counter()
    T, Z, alpha, beta, scal, ok, info = pqz_complex_core_aed(
        H, S, Z=Q, want_z=want_z, want_t=want_t, maxitfac=maxitfac,
        with_info=True, cfg=cfg)
    _sync(dev)
    t2 = time.perf_counter()
    last_info.clear()
    last_info.update(reduce_s=t1 - t0, iterate_s=t2 - t1, converged=ok, **info)
    if verbosity("main") >= 1:
        print(f"[pschur complex] p={p} n={A.shape[-1]}: {info['niter']} "
              f"iterations (budget {info['maxit']}), converged={ok}")
    if not ok:
        raise ConvergenceFailure(-1)
    P = GeneralizedPeriodicSchur(S=S, schurindex=0, Ts=T, Zs=Z, alpha=alpha,
                                 beta=beta, alphascale=scal, orientation="R")
    if orient == "L":
        P = rev_alias(P)
    return P
