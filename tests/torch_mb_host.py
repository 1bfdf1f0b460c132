"""JAX-free numpy oracle of the multi-bulge double-shift sweep.

A copy of ``ref_sweep_np_mb`` and its helpers from tests/test_pallas_sweep.py
(which imports JAX): float64 numpy on full arrays, the reference's chase
step (src/PeriodicSchurDecompositions.jl:806-886) in tick order, bulge b
trailing bulge b-1 by ``gap`` columns, a trailing bulge's first column
re-derived at its introduction tick from the current leading 3x3 product.
"""
import numpy as np


def _refl(x):
    alpha, tail = x[0], x[1:]
    xnorm = np.linalg.norm(tail)
    if xnorm == 0:
        return np.concatenate([[1.0], 0 * tail]), 0.0, alpha
    h = np.hypot(alpha, xnorm)
    beta = -h if alpha >= 0 else h
    tau = (beta - alpha) / beta
    v = tail / (alpha - beta)
    return np.concatenate([[1.0], v]), tau, beta


def _mof(x):
    w, tau, beta = _refl(x)
    return np.eye(len(x)) - tau * np.outer(w, w), beta


def mk_problem(p, n, rng):
    """Ghost-padded (p, n+1, n+1) Hessenberg-triangular cycle, orthogonal Z
    and a unit-1-norm v0 (tests/test_pallas_sweep.py::_mk_problem)."""
    N = n + 1
    Hp = np.zeros((p, N, N))
    Hp[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        Hp[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
    Zp = np.zeros((p, N, N))
    for f in range(p):
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Zp[f, :n, :n] = q
    v0 = rng.standard_normal(3)
    v0 /= np.abs(v0).sum()
    return Hp, Zp, v0


def enforce(H):
    out = H.copy()
    out[0] = np.triu(out[0], -1)
    out[1:] = np.triu(out[1:])
    return out


def mb_sig(rng, nb):
    """nb shift triples (rt1r, rt1i, rt2r), as the JAX test draws them."""
    return [rng.standard_normal(3) * 0.5 for _ in range(nb)]


def lead_v0_np(H, m, sig3):
    """Shifted first column for a trailing bulge from the window's leading
    3x3 cycle product (the JAX test's _lead_v0_np with unit scales)."""
    p = H.shape[0]
    T = np.eye(3)
    for f in range(1, p):
        T = T @ H[f][m:m + 3, m:m + 3]
    P = H[0][m:m + 3, m:m + 3] @ T
    h11, h21, h12, h22, h32 = P[0, 0], P[1, 0], P[0, 1], P[1, 1], P[2, 1]
    rt1r, rt1i, rt2r = sig3
    sv = abs(h11 - rt2r) + abs(rt1i) + abs(h21)
    svs = 1.0 if sv == 0 else sv
    h21s = h21 / svs
    v1 = h21s * h12 + (h11 - rt1r) * ((h11 - rt2r) / svs) \
        + rt1i * (rt1i / svs)
    v2 = h21s * (h11 + h22 - rt1r - rt2r)
    v3 = h21s * h32
    sn = abs(v1) + abs(v2) + abs(v3)
    sns = 1.0 if sn == 0 else sn
    return np.array([v1, v2, v3]) / sns


def ref_sweep_np_mb(Hp, Zp, m, i, v0, sigs, nb, gap):
    """float64 multi-bulge reference (tests/test_pallas_sweep.py)."""
    p, N, _ = Hp.shape
    H = Hp.copy()
    Z = Zp.copy()
    for kk in range(m, i + (nb - 1) * gap):
        for b in range(nb):
            k = kk - b * gap
            if k < m or k > i - 1:
                continue
            first = (k == m)
            nr3 = (i - k + 1) >= 3
            col = H[0][k:k + 3, k - 1].copy()
            if first:
                vk = v0.copy() if b == 0 else lead_v0_np(H, m, sigs[b])
            else:
                vk = col.copy()
            if not nr3:
                vk = vk.copy()
                vk[2] = 0.0
            M3, beta = _mof(vk)
            if not first:
                H[0][k:k + 3, k - 1] = [beta, 0.0,
                                        0.0 if k < i - 1 else col[2]]
            H[0][k:k + 3, k:] = M3 @ H[0][k:k + 3, k:]
            tgt = p - 1 if p > 1 else 0
            hi_r = min(k + 3, i) + 1
            H[tgt][:hi_r, k:k + 3] = H[tgt][:hi_r, k:k + 3] @ M3
            Z[0][:, k:k + 3] = Z[0][:, k:k + 3] @ M3
            for f in range(p - 1, 0, -1):
                colv = H[f][k:k + 3, k].copy()
                if not nr3:
                    colv[2] = 0.0
                M3b, beta2 = _mof(colv)
                H[f][k:k + 3, k] = [beta2, 0.0, 0.0]
                H[f][k:k + 3, k + 1:] = M3b @ H[f][k:k + 3, k + 1:]
                H[f - 1][:hi_r, k:k + 3] = H[f - 1][:hi_r, k:k + 3] @ M3b
                Z[f][:, k:k + 3] = Z[f][:, k:k + 3] @ M3b
                if nr3:
                    xc = H[f][k + 1:k + 3, k + 1].copy()
                    M2, betab = _mof(xc)
                    H[f][k + 1:k + 3, k + 1] = [betab, 0.0]
                    H[f][k + 1:k + 3, k + 2:] = M2 @ H[f][k + 1:k + 3, k + 2:]
                    H[f - 1][:hi_r, k + 1:k + 3] = \
                        H[f - 1][:hi_r, k + 1:k + 3] @ M2
                    Z[f][:, k + 1:k + 3] = Z[f][:, k + 1:k + 3] @ M2
    return H, Z
