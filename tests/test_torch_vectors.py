"""The port's ``eigvecs`` (``models/vectors.py``) against the JAX package's.

The decompositions come from the port's ``pschur`` on the CPU (the cases
of ``tests/test_vectors.py``: graded cycles with a well-separated spectrum,
real and complex, left and right orientation, and a real cycle with a
conjugate pair); both packages get the same T, Z and values.  Inputs come
from ``numpy.random.default_rng(seed)``.

* the vectors agree within 1e-12 of their largest entry, shifted (one
  matrix per slot) and unshifted;
* residual: ``A[l] V[l] = mu V[l+1]`` with ``mu = lambda^(1/p)`` (left), and
  ``A[0] ... A[p-1] v = lambda v`` for V[0] (right), within 1e-7 relative
  as ``tests/test_vectors.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import periodicschurdecompositions_jl_tpu as psd
import periodicschurdecompositions_jl_torch as pt


def graded(seed, p, n, cplx):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, n, n)) * 0.05
    if cplx:
        A = A + 1j * rng.standard_normal((p, n, n)) * 0.05
    for l in range(p):
        A[l] += np.diag(2.0 ** np.arange(n))
    return A


def with_pair(seed):
    rng = np.random.default_rng(seed)
    th = 0.9
    D = np.diag([4.0, 2.0, 1.0, 0.5])
    D[1:3, 1:3] = 1.5 * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    q1, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    return np.stack([q1 @ D, q1.T])


def jax_twin(P):
    return psd.PeriodicSchur(Ts=jnp.asarray(P.Ts.numpy()), Zs=jnp.asarray(P.Zs.numpy()),
                             values=jnp.asarray(P.values.numpy()),
                             orientation=P.orientation, schurindex=P.schurindex)


def ev_residual(A, Vs, lams, left):
    """Largest relative residual of ``A[l] V[l] = mu V[l+1]`` (left) or
    ``A[l] V[l+1] = mu V[l]`` (right) over the vectors and slots."""
    p = len(A)
    worst = 0.0
    for k, lam in enumerate(lams):
        mu = complex(lam) ** (1.0 / p)
        for l in range(p):
            if left:
                lhs, rhs = A[l] @ Vs[l][:, k], mu * Vs[(l + 1) % p][:, k]
            else:
                lhs, rhs = A[l] @ Vs[(l + 1) % p][:, k], mu * Vs[l][:, k]
            worst = max(worst, np.linalg.norm(lhs - rhs)
                        / max(abs(mu) * np.linalg.norm(rhs), 1.0))
    return worst


CASES = [
    ("real-largest", lambda: graded(11, 3, 6, False), "L", "largest"),
    ("real-smallest", lambda: graded(12, 3, 6, False), "L", "smallest"),
    ("complex-largest", lambda: graded(13, 3, 6, True), "L", "largest"),
    ("complex-smallest", lambda: graded(14, 3, 6, True), "L", "smallest"),
    ("pair", lambda: with_pair(15), "L", "complex"),
    ("right", lambda: graded(16, 2, 5, False), "R", "largest"),
    ("right-pair", lambda: with_pair(17)[::-1].copy(), "R", "complex"),
]


@pytest.mark.parametrize("shifted", [True, False])
@pytest.mark.parametrize("name,make,lr,which", CASES, ids=[c[0] for c in CASES])
def test_eigvecs_matches_jax(name, make, lr, which, shifted):
    A = make()
    p, n = A.shape[0], A.shape[1]
    P = pt.pschur(torch.tensor(A), lr)
    vals = P.values.numpy()
    order = np.argsort(np.abs(vals))
    if which == "complex":
        select = [abs(v.imag) > 1e-8 for v in vals]
        assert sum(select) == 2
    else:
        pick = order[-2:] if which == "largest" else order[:2]
        select = [j in pick for j in range(n)]
    Vs = pt.eigvecs(P, select, shifted=shifted)
    Vj = psd.eigvecs(jax_twin(P), select, shifted=shifted)
    assert len(Vs) == len(Vj) == (p if shifted else 1)
    for V, W in zip(Vs, Vj):
        W = np.asarray(W)
        assert V.dtype == torch.complex128 and V.device.type == "cpu"
        assert V.shape == W.shape == (n, sum(select))
        assert np.abs(V.numpy() - W).max() <= 1e-12 * np.abs(W).max()
    V = [v.numpy() for v in Vs]
    lams = vals[np.asarray(select)]
    if shifted:
        assert ev_residual(A, V, lams, left=(lr == "L")) < 1e-7
    if lr == "R":
        # the product's own eigenvectors: A[0] ... A[p-1] v = lambda v
        M = np.linalg.multi_dot(list(A)) if p > 2 else A[0] @ A[1]
        for k, lam in enumerate(lams):
            v = V[0][:, k]
            assert np.linalg.norm(M @ v - lam * v) < 1e-7 * abs(lam) * np.linalg.norm(v)


def test_eigvecs_refuses_other_inputs():
    A = graded(18, 2, 4, False)
    P = pt.pschur(torch.tensor(A), "L")
    with pytest.raises(ValueError, match="Schur vectors"):
        pt.eigvecs(pt.PeriodicSchur(Ts=P.Ts, Zs=None, values=P.values, orientation="L",
                                    schurindex=P.schurindex), [True] * 4)
    with pytest.raises(ValueError, match="select length"):
        pt.eigvecs(P, [True] * 3)
    G = pt.pschur(torch.tensor(A), "R", S=(True, False))
    with pytest.raises(TypeError):
        pt.eigvecs(G, [True] * 4)
