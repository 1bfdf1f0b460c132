"""The port's ``pschur_mp`` (``ops/pqz_mp.py``, mpmath on the host)
against the JAX package's, at dps 25 and 40, on the small shapes of
tests/test_pqz_mp.py.

Both are host code over the same mpmath numbers: the port's T, Z and
eigenvalues (alpha, beta, scale) must equal the JAX package's exactly, and
its reconstruction residual must track the working precision (dps=25
below 1e-18, dps=40 below 1e-33, as tests/test_pqz_mp.py asks).  The port
also takes a torch tensor, and ``utils.interop.mp_from_jax`` carries the
JAX package's result over field for field.
"""
import numpy as np
import pytest
import torch

mpmath = pytest.importorskip("mpmath")

import periodicschurdecompositions_jl_torch as pt  # noqa: E402
from periodicschurdecompositions_jl_tpu.ops import pqz_mp as jmp  # noqa: E402
from periodicschurdecompositions_jl_torch.utils.interop import mp_from_jax  # noqa: E402

TOL = {25: mpmath.mpf("1e-18"), 40: mpmath.mpf("1e-33")}


def _cases():
    rng = np.random.default_rng(1234)

    def cx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    sing = cx(3, 4, 4)
    sing[1] = np.triu(cx(4, 4))
    sing[1][2, 2] = 0.0
    return {"complex p=2 n=4": (cx(2, 4, 4), None, "R", False),
            "real p=3 n=5": (rng.standard_normal((3, 5, 5)), None, "R", False),
            "real complexified p=2 n=4": (rng.standard_normal((2, 4, 4)), None, "R", True),
            "signed p=4 n=4": (cx(4, 4, 4), (True, False, True, False), "R", False),
            "singular inverted p=3 n=4": (sing, (True, False, True), "R", False),
            "left p=3 n=4": (cx(3, 4, 4), None, "L", False)}


CASES = _cases()


def _residual(P, A, dps):
    """max over factors and entries of |Zl T Zr^H - A[l]| in the result's
    orientation, at ``dps``."""
    A = np.asarray(A)
    p, n, _ = A.shape
    worst = mpmath.mpf(0)
    with mpmath.mp.workdps(dps):
        T, Z, S = P.Ts, P.Zs, P.S
        for l in range(p):
            ln = (l + 1) % p
            if P.orientation == "L":
                Zl, Zr = Z[ln], Z[l]
            else:
                Zl, Zr = (Z[l], Z[ln]) if S[l] else (Z[ln], Z[l])
            for i in range(n):
                for j in range(n):
                    acc = sum(Zl[i, k] * T[l][k, q] * mpmath.conj(Zr[j, q])
                              for k in range(n) for q in range(n))
                    worst = max(worst, abs(acc - A[l][i, j]))
    return worst


@pytest.mark.parametrize("dps", [25, 40])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pschur_mp_matches_jax(name, dps):
    A, S, lr, cplx = CASES[name]
    P = pt.pschur_mp(torch.tensor(A), S, lr=lr, dps=dps, complexify=cplx)
    Q = jmp.pschur_mp(A, S, lr=lr, dps=dps, complexify=cplx)
    assert isinstance(P, pt.MpGeneralizedPeriodicSchur)
    assert (P.S, P.orientation, P.schurindex, P.dps) == (Q.S, Q.orientation, Q.schurindex,
                                                         Q.dps)
    assert np.array_equal(P.Ts, Q.Ts) and np.array_equal(P.Zs, Q.Zs)
    assert (P.alpha, P.beta, P.alphascale) == (Q.alpha, Q.beta, Q.alphascale)
    assert [str(v) for v in P.values] == [str(v) for v in Q.values]
    R = mp_from_jax(Q)
    assert isinstance(R, pt.MpGeneralizedPeriodicSchur) and R.dps == P.dps
    assert np.array_equal(R.Ts, P.Ts) and np.array_equal(R.Zs, P.Zs) and R.alpha == P.alpha
    if S is None or lr == "R":
        assert _residual(P, A, dps) < TOL[dps] * max(1.0, np.abs(A).max())
