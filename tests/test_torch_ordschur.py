"""The port's ``ordschur`` (``models/ordschur.py``) against the JAX package's.

Both run host numpy on the same T and Z, so the tests hand them the same
decompositions: the planted fixtures of ``tests/test_ordschur.py`` (``mkrps``:
real, conjugate pairs planted in T; ``mkrgps``: real generalized with a
mixed signature), a complex triangular cycle with a well-separated
spectrum, the same in left orientation and relabeled to a nonzero
``schurindex``.  Inputs come from ``numpy.random.default_rng(seed)``.

* T, Z and the values (alpha, beta, alphascale of a generalized result)
  agree within 1e-12 relative (max|d| <= 1e-12 max|ref|; Z absolute);
* the orientation, ``schurindex`` and signature are the JAX result's;
* the port's ``check_psd`` holds on the result against the original cycle
  (multiplier 2000, as ``tests/test_ordschur.py``);
* an ill-conditioned swap (equal eigenvalues, O(1) coupling) raises
  ``IllConditionedException`` in both packages.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import periodicschurdecompositions_jl_tpu as psd
from periodicschurdecompositions_jl_tpu.config import AlgoConfig as JCfg
from periodicschurdecompositions_jl_tpu.models.ordschur import _update_values
from periodicschurdecompositions_jl_tpu.utils.circshift import circshift_psd as jshift
from periodicschurdecompositions_jl_tpu.utils.circshift import rev_alias as jrev
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.utils.circshift import circshift_psd, rev_alias

REL = 1e-12


def mkrps(rng, n, p, jcs, nnfac=1e-2):
    """T, Z and the eigenvalues of ``tests/test_ordschur.py::mkrps``: conjugate
    pairs planted at rows (j-1, j) for j in jcs, right orientation."""
    T = np.zeros((p, n, n))
    for l in range(p):
        T[l] = np.triu(nnfac * rng.random((n, n)))
    lam = np.zeros(n, complex)
    jj, mu = 0, 1.0
    for j in range(n):
        if j in jcs:
            T[0][j, j - 1] = mu
            T[0][j - 1, j] = -mu
            lam[j] = 2.0 ** (2 * jj) * (1 - 1j)
            lam[j - 1] = 2.0 ** (2 * jj) * (1 + 1j)
            for l in range(1, p):
                T[l][j - 1, j] = 0.0
        else:
            jj += 1
            mu = 2.0 ** (2 * jj / p)
            lam[j] = 2.0 ** (2 * jj)
        for l in range(p):
            T[l][j, j] = mu
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(p)])
    return T, Z, lam


def mkrgps(rng, n, p, jcs, S, nnfac=1e-2):
    """T and Z of ``tests/test_ordschur.py::mkrgps`` (signature S, inverted
    factors with diagonal 1/mu)."""
    T = np.zeros((p, n, n))
    for l in range(p):
        T[l] = np.triu(nnfac * rng.random((n, n)))
    jj, mu = 0, 1.0
    for j in range(n):
        if j in jcs:
            T[0][j, j - 1] = mu
            T[0][j - 1, j] = -mu
            for l in range(1, p):
                T[l][j - 1, j] = 0.0
        else:
            jj += 1
            mu = 2.0 ** (2 * jj / p)
        T[0][j, j] = mu
        for l in range(1, p):
            T[l][j, j] = mu if S[l] else 1.0 / mu
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(p)])
    return T, Z


def mkcps(rng, n, p):
    """A complex triangular cycle, diagonal 2^j (1 + 0.1i) per factor plus
    small coupling, with random unitary Z."""
    T = np.stack([np.triu(0.05 * (rng.standard_normal((n, n))
                                   + 1j * rng.standard_normal((n, n))), 1)
                  + np.diag(2.0 ** np.arange(n) * (1 + 0.1j)) for _ in range(p)])
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n))
                               + 1j * rng.standard_normal((n, n)))[0] for _ in range(p)])
    lam = np.prod(np.stack([np.diag(T[l]) for l in range(p)]), axis=0)
    return T, Z, lam


def cycle(T, Z, S=None):
    p = T.shape[0]
    S = (True,) * p if S is None else S
    return np.stack([Z[l] @ T[l] @ Z[(l + 1) % p].conj().T if S[l]
                     else Z[(l + 1) % p] @ T[l] @ Z[l].conj().T for l in range(p)])


def both(T, Z, lam=None, S=None):
    """The same decomposition in both packages (right orientation)."""
    if S is None:
        return (psd.PeriodicSchur(Ts=jnp.asarray(T), Zs=jnp.asarray(Z),
                                  values=jnp.asarray(lam), orientation="R",
                                  schurindex=0),
                pt.PeriodicSchur(Ts=torch.tensor(T), Zs=torch.tensor(Z),
                                 values=torch.tensor(lam), orientation="R",
                                 schurindex=0))
    alpha, beta, scale = _update_values([T[l] for l in range(len(S))], tuple(S))
    return (psd.GeneralizedPeriodicSchur(
                S=tuple(S), schurindex=0, Ts=jnp.asarray(T), Zs=jnp.asarray(Z),
                alpha=jnp.asarray(alpha), beta=jnp.asarray(beta),
                alphascale=jnp.asarray(scale, jnp.int32), orientation="R"),
            pt.GeneralizedPeriodicSchur(
                S=tuple(S), schurindex=0, Ts=torch.tensor(T), Zs=torch.tensor(Z),
                alpha=torch.tensor(alpha), beta=torch.tensor(beta),
                alphascale=torch.tensor(scale.astype(np.int32)), orientation="R"))


def close(x, ref, rel=True):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape
    scale = np.abs(ref).max() if rel else 1.0
    assert np.abs(x - ref).max() <= REL * max(scale, 1e-300), np.abs(x - ref).max()


def same_result(P, Pj):
    assert P.orientation == Pj.orientation and P.schurindex == Pj.schurindex
    close(P.Ts.numpy(), Pj.Ts)
    close(P.Zs.numpy(), Pj.Zs, rel=False)
    if isinstance(Pj, psd.GeneralizedPeriodicSchur):
        assert tuple(P.S) == tuple(Pj.S)
        close(P.alpha.numpy(), Pj.alpha)
        assert np.array_equal(P.beta.numpy(), np.asarray(Pj.beta))
        assert np.array_equal(P.alphascale.numpy(), np.asarray(Pj.alphascale))
    else:
        vj = np.asarray(Pj.values)
        assert np.array_equal(np.isnan(P.values.numpy()), np.isnan(vj))
        close(np.nan_to_num(P.values.numpy()), np.nan_to_num(vj))


CASES = {
    "real-pairs": dict(n=8, p=3, jcs=(3, 7), select=[0, 0, 1, 1, 0, 0, 0, 0]),
    "real-last-pair": dict(n=8, p=3, jcs=(3, 7), select=[0, 0, 0, 0, 0, 0, 1, 1]),
    "real-widen": dict(n=8, p=2, jcs=(3,), select=[0, 0, 0, 1, 0, 0, 0, 0]),
    "real-p1": dict(n=6, p=1, jcs=(3,), select=[0, 0, 1, 1, 0, 0]),
    "complex": dict(n=6, p=3, cplx=True, select=[0, 0, 1, 0, 1, 0]),
    "gen-TFT": dict(n=8, p=3, jcs=(3,), S=(True, False, True), select=[0, 0, 1, 1, 0, 0, 0, 0]),
    "gen-TTF": dict(n=8, p=3, jcs=(5,), S=(True, True, False),
                    select=[0, 0, 0, 0, 1, 0, 0, 1]),
    "gen-TF-singletons": dict(n=6, p=2, jcs=(), S=(True, False),
                              select=[0, 0, 1, 0, 1, 0]),
}


def make(case, seed):
    c = CASES[case]
    rng = np.random.default_rng(seed)
    S = c.get("S")
    if c.get("cplx"):
        T, Z, lam = mkcps(rng, c["n"], c["p"])
    elif S is None:
        T, Z, lam = mkrps(rng, c["n"], c["p"], c["jcs"])
    else:
        (T, Z), lam = mkrgps(rng, c["n"], c["p"], c["jcs"], S), None
    Pj, P = both(T, Z, lam, S)
    return Pj, P, cycle(T, Z, S), [bool(x) for x in c["select"]]


# views: as made (right orientation), as a left decomposition of the
# reversed cycle, relabeled to schurindex 1 (not for a cycle of one factor)
VIEWS = [(c, v) for c in sorted(CASES) for v in ("R", "L", "shift")
         if not (v == "shift" and CASES[c]["p"] == 1)]


@pytest.mark.parametrize("case,view", VIEWS)
def test_ordschur_matches_jax(case, view):
    Pj, P, A, select = make(case, 20 + sorted(CASES).index(case))
    if view == "L":
        # the same data as a left decomposition of the reversed cycle
        Pj, P, A = jrev(Pj), rev_alias(P), A[::-1]
    elif view == "shift":
        Pj, P, A = jshift(Pj, 1), circshift_psd(P, 1), np.roll(A, 1, axis=0)
        assert P.schurindex == 1
    Pj2 = psd.ordschur(Pj, select)
    P2 = pt.ordschur(P, select)
    same_result(P2, Pj2)
    ok, rep = pt.check_psd(P2, A, tol=2000.0)
    assert ok, rep


def test_iterative_2x2_matches_jax():
    Pj, P, A, select = make("gen-TFT", 7)
    Pj2 = psd.ordschur(Pj, select, cfg=JCfg(iterative_2x2=True))
    P2 = pt.ordschur(P, select, cfg=pt.AlgoConfig(iterative_2x2=True))
    same_result(P2, Pj2)


def test_ill_conditioned_swap_raises_in_both():
    # identical adjacent eigenvalues with O(1) coupling: the periodic
    # Sylvester system is singular, the stability tests reject the swap
    n, p = 4, 2
    T = np.stack([np.eye(n) for _ in range(p)])
    T[0][1, 2] = 1.0
    Z = np.stack([np.eye(n) for _ in range(p)])
    Pj, P = both(T, Z, np.ones(n, complex))
    select = [False, False, True, False]
    with pytest.raises(psd.IllConditionedException):
        psd.ordschur(Pj, select)
    with pytest.raises(pt.IllConditionedException):
        pt.ordschur(P, select)
    assert torch.equal(P.Ts, torch.tensor(T))  # the input is untouched


def test_inverted_schur_factor_and_bad_select_raise():
    Pj, P, _, select = make("gen-TFT", 3)
    with pytest.raises(ValueError, match="select length"):
        pt.ordschur(P, select[:-1])
    Pbad = pt.GeneralizedPeriodicSchur(S=(False, True, True), schurindex=0, Ts=P.Ts,
                                       Zs=P.Zs, alpha=P.alpha, beta=P.beta,
                                       alphascale=P.alphascale, orientation="R")
    with pytest.raises(ValueError, match="direct"):
        pt.ordschur(Pbad, select)
