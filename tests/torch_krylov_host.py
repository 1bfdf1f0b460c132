"""Draws and the result contract of the Krylov tests, shared by the port's
CPU and card tests (copies of ``tests/test_krylov.py``'s ``mkmats`` and
``check_partial``, the latter for operators given as a function)."""
import numpy as np


def mkmats(rng, p, n, xpnd=1.25, cplx=False):
    """Cycle with known well-spread spectrum from triangular seeds
    (reference mkmats1, test/krylov.jl:35-56): A[l] = Q[(l+1)%p] T_l
    Q[l]^H, so the left-orientation product A[p-1]...A[0] has the planted
    spectrum."""
    lams = xpnd ** np.arange(n) * (1.0 + (0.3j if cplx else 0.0))
    dt = complex if cplx else float
    mu = np.abs(lams) ** (1.0 / p)

    def rand_q():
        g = rng.standard_normal((n, n))
        if cplx:
            g = g + 1j * rng.standard_normal((n, n))
        q, _ = np.linalg.qr(g)
        return q

    Qs = [rand_q() for _ in range(p)]
    A = []
    for l in range(p):
        T = np.triu(rng.standard_normal((n, n)) * 0.1, 1).astype(dt)
        d = mu.astype(dt)
        if l == 0 and cplx:
            d = d * (lams / np.abs(lams))  # phases into the first factor
        if l == 0 and not cplx:
            d = d * np.sign(lams.real)
        T += np.diag(d)
        A.append(Qs[(l + 1) % p] @ T @ Qs[l].conj().T)
    return np.stack(A).astype(dt)


def check_partial(apply, V, T, vals, otol=100):
    """Reference `check` (test/krylov.jl:6-26) on numpy arrays: per-column
    residuals of the Schur-factor relation below max(|lam_i|, ||T|| eps),
    the interior couplings below max(max|lam|, 1), orthonormal bases.
    ``apply(l, X)`` returns A[l] @ X."""
    p, _, k = V.shape
    assert k > 0
    eps = np.finfo(V.real.dtype).eps
    b = np.linalg.norm(T[p - 1])
    R = apply(p - 1, V[p - 1]) - V[0] @ T[p - 1]
    cnrms = np.linalg.norm(R, axis=0)
    thresh = np.maximum(np.abs(vals[:k]), b * eps)
    assert np.all(cnrms < thresh), (cnrms, thresh)
    for l in range(p - 1):
        R = apply(l, V[l]) - V[(l + 1) % p] @ T[l]
        assert np.linalg.norm(R, axis=0).max() < max(np.abs(vals).max(), 1.0), (
            l, np.abs(R).max())
    for l in range(p):
        G = V[l].conj().T @ V[l]
        assert np.abs(G - np.eye(k)).max() < otol * k * eps
