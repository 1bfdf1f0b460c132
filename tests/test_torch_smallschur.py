"""The port's small-window shift engine against the JAX package's.

``ops/smallschur.py::hess_eigs_small`` (numpy, host) against the JAX
function (jit) on the cases of tests/test_smallschur.py: random Hessenberg
matrices of order 2..8 (pre-split, scaled by 1e3), conjugate order, order 1
and triangular input.  Both run the same masked fixed-budget Francis
iteration and read the eigenvalues off positionally, so they agree entry by
entry within 1e-12 relative to the largest eigenvalue: the random cases at
the multi-bulge driver's budget of 5 M iterations, the others at the
default budget of 15 M.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from periodicschurdecompositions_jl_tpu.ops.smallschur import hess_eigs_small as jeigs
from periodicschurdecompositions_jl_torch.ops.smallschur import hess_eigs_small

_jit_eigs = jax.jit(jeigs, static_argnames="niter")


def _jax(W, niter=None):
    wr, wi = _jit_eigs(jnp.asarray(W), niter=niter)
    return np.asarray(wr), np.asarray(wi)


def _close(got, ref, scale):
    return np.max(np.abs(got - ref)) <= 1e-12 * max(scale, 1e-300)


@pytest.mark.parametrize("M", [2, 4, 6, 8])
def test_hess_eigs_small_matches_jax(M):
    rng = np.random.default_rng(7)
    for trial in range(24):
        W = np.triu(rng.standard_normal((M, M)), -1)
        if trial % 4 == 1 and M > 2:
            W[M - 1, M - 2] = 0.0      # pre-split bottom
        if trial % 4 == 2:
            W *= 1e3                    # scale invariance
        wr, wi = hess_eigs_small(W, niter=5 * M)
        jwr, jwi = _jax(W, 5 * M)
        got, ref = wr + 1j * wi, jwr + 1j * jwi
        assert _close(got, ref, np.abs(ref).max()), (M, trial, got, ref)
        ev = np.sort_complex(np.linalg.eigvals(W))
        assert np.abs(np.sort_complex(got) - ev).max() <= 1e-6 * np.abs(ev).max()


def test_hess_eigs_small_conjugate_order():
    rng = np.random.default_rng(11)
    for _ in range(10):
        W = np.triu(rng.standard_normal((6, 6)), -1)
        wr, wi = hess_eigs_small(W)
        jwr, jwi = _jax(W)
        assert _close(wr + 1j * wi, jwr + 1j * jwi, np.abs(jwr + 1j * jwi).max())
        j = 0
        while j < 6:
            if wi[j] != 0:
                assert wi[j + 1] == -wi[j] and wr[j + 1] == wr[j]
                j += 2
            else:
                j += 1


def test_hess_eigs_small_m1_and_triangular():
    wr, wi = hess_eigs_small(np.array([[3.25]]))
    assert wr.tolist() == [3.25] and wi.tolist() == [0.0]
    W = np.triu(np.random.default_rng(0).standard_normal((5, 5)))
    wr, wi = hess_eigs_small(W)
    jwr, jwi = _jax(W)
    assert _close(wr, jwr, np.abs(jwr).max()) and np.all(wi == 0) and np.all(jwi == 0)
    assert np.allclose(np.sort(wr), np.sort(np.diag(W)), atol=1e-10)
