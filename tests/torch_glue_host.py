"""Host reference of kernel G for the port's tests (numpy, no JAX).

A numpy transcription of the per-iteration glue of the JAX package's
float64 real periodic QR core (``ops/pqr_real.py``): the band entries of
the cycle product, the deflation scan's bottom-most hit and the
double-shift first column at the window head.  ``host_glue`` returns it as
an ``ops.glue.Glue``, so it can stand in for ``glue_products_scan_shift``
in ``pqr_real_core``; kernel G and ``glue_plain`` are held to it bit for
bit.
"""
import dataclasses

import numpy as np

from periodicschurdecompositions_jl_torch.ops import glue, pqr_real


def band_products(D, U, V, S0):
    """Band entries of T = H[1] @ ... @ H[p-1] and the cycle product H[0] @ T.

    Args (host float64 arrays): D, U, V: (p, n) diagonals 0, +1, +2 of every
      factor (U[:, n-1] = V[:, n-2:] = 0); S0: (n,) with S0[r] = H[0][r, r-1]
      (S0[0] = 0).

    Returns (hdiag, hsub, hsup): entries [r, r], [r, r-1], [r, r+1] of the
    product for every r (0 outside the band).
    """
    p, n = D.shape
    z1 = np.zeros(1)
    z2 = np.zeros(2)
    P1 = np.ones(n)
    P2 = np.zeros(n)
    P3 = np.zeros(n)
    for l in range(1, p):
        Dl, Ul, Vl = D[l], U[l], V[l]
        D1 = np.concatenate([Dl[1:], z1])
        U1 = np.concatenate([Ul[1:], z1])
        D2 = np.concatenate([Dl[2:], z2])
        P3 = P1 * Vl + P2 * U1 + P3 * D2
        P2 = P1 * Ul + P2 * D1
        P1 = P1 * Dl
    d0, u0, s0 = D[0], U[0], S0
    P1m = np.concatenate([np.ones(1), P1[:-1]])
    P2m = np.concatenate([z1, P2[:-1]])
    P3m = np.concatenate([z1, P3[:-1]])
    hsub = s0 * P1m
    hdiag = s0 * P2m + d0 * P1
    P11 = np.concatenate([P1[1:], z1])
    hsup = s0 * P3m + d0 * P2 + u0 * P11
    return hdiag, hsub, hsup


def deflation_scan(hdiag, hsub, hsup, l, i, its, cfg, ulp, ulpx, smlnum):
    """Bottom-most negligible product subdiagonal in rows [l+1, i] (the
    tightened Ahues-Tisseur test with the stagnation relaxation after 16
    fruitless iterations, or SLICOT's test); ``l`` when there is none, ``i``
    when the window is one row."""
    hh11 = np.concatenate([np.zeros(1), hdiag[:-1]])
    hh12 = np.concatenate([np.zeros(1), hsup[:-1]])
    hh21 = hsub
    hh22 = hdiag
    tst1 = np.abs(hh11) + np.abs(hh22)
    ab = np.maximum(np.abs(hh21), np.abs(hh12))
    ba = np.minimum(np.abs(hh21), np.abs(hh12))
    aa = np.maximum(np.abs(hh22), np.abs(hh11 - hh22))
    bb = np.minimum(np.abs(hh22), np.abs(hh11 - hh22))
    stmp = aa + ab
    stmps = np.where(stmp == 0, 1.0, stmp)
    if cfg.slicot_convg:
        found = np.abs(hh21) <= np.maximum(ulp * tst1, smlnum)
    else:
        at_ok = ba * (ab / stmps) <= np.maximum(smlnum, ulpx * (bb * (aa / stmps)))
        found = (np.abs(hh21) <= smlnum) | ((np.abs(hh21) <= ulp * tst1) & at_ok)
        if its >= 16:
            found |= np.abs(hh21) <= np.maximum(ulp * tst1, smlnum)
    iv = np.arange(hdiag.shape[0])
    found &= (iv >= l + 1) & (iv <= i)
    if i > l:
        return int(iv[found].max()) if found.any() else l
    return i


def host_glue(Hp, n, l, i, its, cfg):
    """The glue of one iteration on the host: one gather of the factor
    diagonals of the padded stack Hp (any device), then numpy."""
    p = Hp.shape[0]
    ulp, ulpx, smlnum = glue.scan_constants(n, cfg)
    D, U, V, S0 = pqr_real._BandGather(p, n, Hp.device)(Hp)
    hd, hs, hu = band_products(D, U, V, S0)
    lnew = deflation_scan(hd, hs, hu, l, i, its, cfg, ulp, ulpx, smlnum)
    # v0 at m = lnew (the early-QR start, if any, is the core's own step)
    _, v0, _ = pqr_real._shift_v0(hd, hs, hu, lnew, i, its, n,
                                  dataclasses.replace(cfg, allow_early_qr=False), ulp)
    return glue.Glue(lnew, v0, hd, hs, hu, D, U, S0)
