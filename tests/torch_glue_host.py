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
    z2 = np.zeros(min(n, 2))  # D[r+2] past the last row (one entry at n = 1)
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


def host_glue(Hp, n, l, i, its, cfg, bufs=None):
    """The glue of one iteration on the host: one gather of the factor
    diagonals of the padded stack Hp (any device), then numpy (``bufs``,
    the kernel's buffers, unused)."""
    return host_glue_of(pqr_real._BandGather(Hp.shape[0], n, Hp.device)(Hp), n, l, i, its,
                        cfg)


def host_glue_of(diagonals, n, l, i, its, cfg):
    """``host_glue`` from the gathered diagonals (D, U, V, S0)."""
    ulp, ulpx, smlnum = glue.scan_constants(n, cfg)
    D, U, V, S0 = diagonals
    hd, hs, hu = band_products(D, U, V, S0)
    lnew = deflation_scan(hd, hs, hu, l, i, its, cfg, ulp, ulpx, smlnum)
    # v0 at m = lnew (the early-QR start, if any, is the core's own step)
    _, v0, _ = pqr_real._shift_v0(hd, hs, hu, lnew, i, its, n,
                                  dataclasses.replace(cfg, allow_early_qr=False), ulp)
    return glue.Glue(lnew, v0, hd, hs, hu, D, U, S0)


# ---- numpy model of csrc/glue.cu's staged schedule ---------------------------

GLUE_THREADS = 64  # the kernel's kGlueThreads
GLUE_ROWS = 32     # its kGlueRows: the rows a block's chunk scans
GLUE_AHEAD = 3     # its kAhead: factor groups in flight
H100_OPTIN = 232448


def _glue_doubles(p, K, rows, threads, ahead):
    W = rows + 5
    return (ahead + 1) * K * 3 * W + 3 * p + 3 * (rows + 3) + 6 * (rows + 1) + threads // 32 + 1


def glue_plan(p, optin=H100_OPTIN, rows=GLUE_ROWS, threads=GLUE_THREADS, ahead=GLUE_AHEAD):
    """The factor group K as ``csrc/glue.cu::glue_plan`` picks it: the
    largest up to the one that puts all p-1 factors in ``ahead`` groups
    whose block's shared memory fits ``optin`` bytes."""
    for K in range(-(-(p - 1) // ahead) if p > 1 else 1, 0, -1):
        if 8 * _glue_doubles(p, K, rows, threads, ahead) <= optin:
            return K
    raise ValueError("glue: 3p factor entries beyond the shared memory")


def glue_tight_optin(p, rows=GLUE_ROWS, threads=GLUE_THREADS, ahead=GLUE_AHEAD):
    """The least shared memory kernel G runs in: one factor a group."""
    return 8 * _glue_doubles(p, 1, rows, threads, ahead)


def glue_model(H, n, l, i, its, cfg, rows=GLUE_ROWS, threads=GLUE_THREADS,
               ahead=GLUE_AHEAD, optin=H100_OPTIN):
    """The packed buffer of kernel G (``ops.glue.out_len`` doubles) computed
    on the schedule of ``csrc/glue.cu``, from the padded stack H (numpy, p x
    N x N).  Row chunks of R = ``rows`` rows, one a block; a block stages
    the factors' D, U, V at rows
    r0-2 .. r0+R+2 in groups of K through a ring of ``ahead`` + 1 slots as
    psd::apply_ring issues them (groups 0..ahead-1 first, then group g +
    ahead just before group g is walked), a slot poisoned with NaN before it
    is refilled and unstaged rows left NaN, so that a read the copy did not
    serve shows; a thread a row computes the products at rows r0-2 .. r0+R,
    the band at rows r0-1 .. r0+R-1 (writing rows r0 ..), the scan of the
    chunk's rows, each warp's and then the block's bottom-most hit; the
    factor entries (block 0, a factor a thread) come with the first group;
    then the last block reduces the blocks' hits and its thread 0's shift
    reads the band as written, in the kernel's order, and the tail from
    H."""
    p = H.shape[0]
    N = n + 1
    flat = H.reshape(p, N * N)
    ghost = n * N + n
    nan = np.nan
    K = glue_plan(p, optin, rows, threads, ahead)
    R, W, T = rows, rows + 5, threads
    assert R + 3 <= T and T % 32 == 0

    def iD(r):
        return r * N + r

    def iU(r):
        return np.where(r < n - 1, r * N + r + 1, ghost)

    def iV(r):
        return np.where(r < n - 2, r * N + r + 2, ghost)

    def iS0(r):
        return np.where(r >= 1, r * N + r - 1, ghost)

    def gather(idx, rs, f=0):
        """Entries of factor f at rows rs (NaN where a row is off the matrix:
        never staged)."""
        ok = (rs >= 0) & (rs < n)
        return np.where(ok, flat[f][idx(np.clip(rs, 0, n - 1))], nan)

    nrc = -(-n // R)
    ng = -(-(p - 1) // K)
    out = np.full(4 + 3 * n + 3 * p + 4, nan)
    hdiag, hsub, hsup = (out[4 + k * n:4 + (k + 1) * n] for k in range(3))
    fac = out[4 + 3 * n:4 + 3 * n + 3 * p]
    sfac = np.full(3 * p, nan)  # block 0, with its first group
    if i >= 1:
        sfac[0::3] = flat[:, iD(i - 1)]
        sfac[2::3] = flat[:, iU(i - 1)]
    sfac[1::3] = flat[:, iD(i)]
    ulp, ulpx, smlnum = glue.scan_constants(n, cfg)
    # the blocks' chunks are independent: all of them at once, chunk c in
    # row c of each array
    r0 = (np.arange(nrc) * R)[:, None]
    hr = r0 - 1 + np.arange(R + 1)  # H[0] at rows r0-1 .. r0+R-1
    D0, U0, S0 = gather(iD, hr), gather(iU, hr), gather(iS0, hr)
    slots = np.full((ahead + 1, K, 3, nrc, W), nan)
    rs = r0 - 2 + np.arange(W)

    def copy(g):
        f0 = 1 + g * K
        s = slots[g % (ahead + 1)]
        s[:] = nan
        for fl in range(min(K, p - f0)):
            s[fl, 0] = gather(iD, rs, f0 + fl)
            s[fl, 1, :, :W - 1] = gather(iU, rs[:, :W - 1], f0 + fl)
            s[fl, 2, :, :W - 2] = gather(iV, rs[:, :W - 2], f0 + fl)

    t = np.arange(R + 3)
    rp = r0 - 2 + t  # the threads' rows of the products
    mine = (rp >= 0) & (rp < n)
    p1, p2, p3 = np.ones(rp.shape), np.zeros(rp.shape), np.zeros(rp.shape)
    for g in range(min(ahead, ng)):
        copy(g)
    for g in range(ng):
        if g + ahead < ng:
            copy(g + ahead)
        s = slots[g % (ahead + 1)]
        for fl in range(min(K, p - (1 + g * K))):
            Ds, Us, Vs = s[fl, 0], s[fl, 1], s[fl, 2]
            d1 = np.where(rp + 1 < n, Ds[:, t + 1], 0.0)
            u1 = np.where(rp + 1 < n, Us[:, t + 1], 0.0)
            d2 = np.where(rp + 2 < n, Ds[:, t + 2], 0.0)
            q3 = p1 * Vs[:, t] + p2 * u1 + p3 * d2
            q2 = p1 * Us[:, t] + p2 * d1
            p1 = np.where(mine, p1 * Ds[:, t], p1)
            p2 = np.where(mine, q2, p2)
            p3 = np.where(mine, q3, p3)
    P1, P2, P3 = (np.where(mine, x, nan) for x in (p1, p2, p3))
    # times H[0], rows r0-1 .. r0+R-1 (band index k: row r0-1+k)
    ok = (hr >= 0) & (hr < n)
    k = np.arange(R + 1)
    with np.errstate(invalid="ignore"):
        p1m = np.where(hr >= 1, P1[:, k], 1.0)
        p2m = np.where(hr >= 1, P2[:, k], 0.0)
        p3m = np.where(hr >= 1, P3[:, k], 0.0)
        p11 = np.where(hr + 1 < n, P1[:, k + 2], 0.0)
        hs = np.where(ok, S0 * p1m, nan)
        hd = np.where(ok, S0 * p2m + D0 * P1[:, k + 1], nan)
        hu = np.where(ok, S0 * p3m + D0 * P2[:, k + 1] + U0 * p11, nan)
    w = ok & (k >= 1)
    hsub[hr[w]], hdiag[hr[w]], hsup[hr[w]] = hs[w], hd[w], hu[w]
    # each chunk's scan, a thread a row
    rr = r0 + np.arange(R)
    live = (rr < n) & (rr >= l + 1) & (rr <= i)
    j = np.arange(R)
    hh11 = np.where(rr >= 1, hd[:, j], 0.0)
    hh12 = np.where(rr >= 1, hu[:, j], 0.0)
    hh22, a21 = hd[:, j + 1], np.abs(hs[:, j + 1])
    with np.errstate(invalid="ignore"):
        tst1 = np.abs(hh11) + np.abs(hh22)
        relax = np.maximum(ulp * tst1, smlnum)
        if cfg.slicot_convg:
            found = a21 <= relax
        else:
            a12 = np.abs(hh12)
            ab, ba = np.maximum(a21, a12), np.minimum(a21, a12)
            dd = np.abs(hh11 - hh22)
            aa, bb = np.maximum(np.abs(hh22), dd), np.minimum(np.abs(hh22), dd)
            stmp = aa + ab
            stmps = np.where(stmp == 0.0, 1.0, stmp)
            at_ok = ba * (ab / stmps) <= np.maximum(smlnum, ulpx * (bb * (aa / stmps)))
            found = (a21 <= smlnum) | ((a21 <= ulp * tst1) & at_ok)
            if its >= 16:
                found |= a21 <= relax
    best = np.full((nrc, T), -1)
    best[:, :R] = np.where(live & found, rr, -1)
    bests = best.reshape(nrc, -1, 32).max(axis=2).max(axis=1)  # warps, then the block
    fac[:] = np.where(np.arange(3 * p) % 3 == 1, sfac, sfac if i >= 1 else 0.0)
    top = int(bests.max())
    lnew = (top if top >= 0 else l) if i > l else i

    # thread 0: the shift at m = lnew, the kernel's operations in its order
    def cl(j):
        return min(max(j, 0), n - 1)
    exc1 = its == 10
    exc = exc1 or its % 10 == 0
    sE = (abs(hsub[cl(lnew + 1)]) + abs(hsub[cl(lnew + 2)]) if exc1
          else abs(hsub[i]) + abs(hsub[cl(i - 1)]))
    h44E = 0.75 * sE + (hdiag[lnew] if exc1 else hdiag[i])
    h33E = h44E
    h43h34E = -0.4375 * sE * sE
    h44, h33, h43, h34 = hdiag[i], hdiag[cl(i - 1)], hsub[i], hsup[cl(i - 1)]
    ssh = abs(h33) + abs(h34) + abs(h43) + abs(h44)
    sshs = 1.0 if ssh == 0.0 else ssh
    h33n, h44n, h34n, h43n = h33 / sshs, h44 / sshs, h34 / sshs, h43 / sshs
    trc = (h33n + h44n) * 0.5
    disc = (h33n - trc) * (h44n - trc) - h34n * h43n
    rtdisc = np.sqrt(abs(disc))
    if ssh == 0.0:
        rt1r = rt1i = 0.0
    elif disc >= 0.0:
        rt1r, rt1i = trc * ssh, rtdisc * ssh
    else:
        r1, r2 = trc + rtdisc, trc - rtdisc
        rt1r, rt1i = (r1 if abs(r1 - h44n) <= abs(r2 - h44n) else r2) * ssh, 0.0
    rt2r, rt2i = rt1r, -rt1i
    m = lnew
    h11, h12, h21, h22, h32 = hdiag[m], hsup[m], hsub[cl(m + 1)], hdiag[cl(m + 1)], \
        hsub[cl(m + 2)]
    if exc or cfg.slicot_shifts:
        h44s, h33s = h44E - h11, h33E - h11
        h21s_ = 1.0 if h21 == 0.0 else h21
        v = [(h33s * h44s - h43h34E) / h21s_ + h12, h22 - h11 - h33s - h44s, h32]
    else:
        sv = abs(h11 - rt2r) + abs(rt2i) + abs(h21)
        svs = 1.0 if sv == 0.0 else sv
        h21s = h21 / svs
        v = [h21s * h12 + (h11 - rt1r) * ((h11 - rt2r) / svs) - rt1i * (rt2i / svs),
             h21s * (h11 + h22 - rt1r - rt2r), h21s * h32]
    sn = abs(v[0]) + abs(v[1]) + abs(v[2])
    sns = 1.0 if sn == 0.0 else sn
    out[:4] = [float(lnew), v[0] / sns, v[1] / sns, v[2] / sns]
    out[4 + 3 * n + 3 * p:] = [flat[0, iS0(i)], flat[0, iD(lnew - 1)] if lnew >= 1 else 0.0,
                              flat[0, iD(lnew)], flat[0, iS0(np.int64(lnew))]]
    return out
