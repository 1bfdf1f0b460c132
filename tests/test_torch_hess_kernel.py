"""The port's periodic Hessenberg reduction against the JAX package's kernel.

``phessenberg_core_plain`` (the CPU route, and the version the CUDA kernel
of ``csrc/hess.cu`` is checked against on the card) against the JAX
package's fused Pallas reduction kernel (``ops/pallas_hess.py``, run through
the Pallas interpreter as the JAX package's own tests run it).  The JAX
kernel computes in float-float (about 2^-48 per operation), so H and Q agree
within 1e-12 max|A|; the structural zeros are exact in both.

The edges (p = 1, n <= 2, want_q=False) are held against the JAX float64
reduction within 1e-13 max|A| (the same Householder sequence in float64,
summed in other orders), and so is the complex128 plain reduction (the CPU
route, and the reference of the kernel's complex128 instance) against the
JAX complex reduction, which the JAX package computes in jnp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from periodicschurdecompositions_jl_tpu.ops import ff
from periodicschurdecompositions_jl_tpu.ops.hessenberg import phessenberg_core as jcore
from periodicschurdecompositions_jl_tpu.ops.hessenberg_ff import phessenberg_core_ff
from periodicschurdecompositions_jl_torch.ops import hessenberg as th
from periodicschurdecompositions_jl_torch.ops.householder import reflector_masked


def _structure_exact(H):
    assert np.all(np.tril(H[0], -2) == 0)
    for f in range(1, H.shape[0]):
        assert np.all(np.tril(H[f], -1) == 0)


def test_plain_matches_the_jax_reduction_kernel():
    p, n = 3, 12
    A = np.random.default_rng(p * 100 + n).standard_normal((p, n, n))
    Aff = ff.from_f64(jnp.asarray(A))
    Hhi, Hlo, QThi, QTlo = phessenberg_core_ff(Aff.hi, Aff.lo, want_q=True,
                                               use_kernel="interpret")
    Hj = np.asarray(Hhi, np.float64) + np.asarray(Hlo, np.float64)
    Qj = np.swapaxes(np.asarray(QThi, np.float64) + np.asarray(QTlo, np.float64), 1, 2)
    H, Q = th.phessenberg_core_plain(torch.tensor(A))
    H, Q = H.numpy(), Q.numpy()
    scale = np.abs(A).max()
    assert np.abs(H - Hj).max() <= 1e-12 * scale
    assert np.abs(Q - Qj).max() <= 1e-12
    _structure_exact(H)
    _structure_exact(Hj)
    for l in range(p):
        R = Q[l].T @ A[l] @ Q[(l + 1) % p] - H[l]
        assert np.abs(R).max() <= 1e-13 * scale


@pytest.mark.parametrize("p,n,want_q", [(2, 9, True), (3, 10, False), (1, 7, True)])
def test_cpu_route_is_the_plain_version(p, n, want_q):
    A = torch.tensor(np.random.default_rng(p + n).standard_normal((p, n, n)))
    before = th.launches["hess_reduce"]
    H, Q = th.phessenberg_core(A, want_q=want_q)
    Hp, Qp = th.phessenberg_core_plain(A, want_q=want_q)
    assert th.launches["hess_reduce"] == before
    assert torch.equal(H, Hp)
    assert (Q is None and Qp is None) if not want_q else torch.equal(Q, Qp)


@pytest.mark.parametrize("p,n,want_q", [(1, 8, True), (3, 1, True), (1, 2, True),
                                        (4, 2, True), (4, 7, False), (1, 5, False)])
def test_plain_edges_match_jax(p, n, want_q):
    A = np.random.default_rng(10 * p + n).standard_normal((p, n, n))
    Hj, Qj = jcore(jnp.asarray(A), want_q=want_q)
    H, Q = th.phessenberg_core_plain(torch.tensor(A), want_q=want_q)
    scale = np.abs(A).max()
    assert np.abs(H.numpy() - np.asarray(Hj)).max() <= 1e-13 * scale
    _structure_exact(H.numpy())
    if want_q:
        assert np.abs(Q.numpy() - np.asarray(Qj)).max() <= 1e-13
    else:
        assert Q is None and Qj is None


def _complex_cycle(p, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))


@pytest.fixture(scope="module")
def jax_complex():
    """The JAX complex reduction at (p=3, n=10) and (p=1, n=7), computed once
    for the tests that read it."""
    out = {}
    for (p, n) in ((3, 10), (1, 7)):
        A = _complex_cycle(p, n, 500 + 10 * p + n)
        Hj, Qj = jcore(jnp.asarray(A))
        out[(p, n)] = (A, np.asarray(Hj), np.asarray(Qj))
    return out


@pytest.mark.parametrize("p,n", [(3, 10), (1, 7)])
def test_plain_complex_matches_jax(jax_complex, p, n):
    A, Hj, Qj = jax_complex[(p, n)]
    H, Q = th.phessenberg_core_plain(torch.tensor(A))
    H, Q = H.numpy(), Q.numpy()
    scale = np.abs(A).max()
    assert np.abs(H - Hj).max() <= 1e-13 * scale
    assert np.abs(Q - Qj).max() <= 1e-13
    _structure_exact(H)
    for l in range(p):
        R = Q[l].conj().T @ A[l] @ Q[(l + 1) % p] - H[l]
        assert np.abs(R).max() <= 1e-13 * scale


@pytest.mark.parametrize("p,n,want_q", [(3, 10, True), (1, 7, False)])
def test_cpu_route_is_the_plain_version_complex(jax_complex, p, n, want_q):
    A = torch.tensor(jax_complex[(p, n)][0])
    before = th.launches["hess_reduce"]
    H, Q = th.phessenberg_core(A, want_q=want_q)
    Hp, Qp = th.phessenberg_core_plain(A, want_q=want_q)
    assert th.launches["hess_reduce"] == before
    assert torch.equal(H, Hp)
    assert (Q is None and Qp is None) if not want_q else torch.equal(Q, Qp)


def test_zero_tail_with_a_complex_alpha_is_carried_out():
    """zlarfg: a zero tail leaves tau = 0 only for a real alpha; a complex
    alpha still gets a reflector, which makes it real, and the reduction
    applies it (the kernel's complex128 instance must not skip it)."""
    x = torch.tensor([0.3, -1.5 + 2.0j, 0.0, 0.0], dtype=torch.complex128)
    w, tau, beta = reflector_masked(x, 1)
    assert complex(tau) != 0 and float(beta) == 2.5
    y = x - tau.conj() * w * (w.conj() @ x)
    assert torch.allclose(y, torch.tensor([0.3, 2.5, 0, 0], dtype=torch.complex128),
                          rtol=0, atol=1e-15)
    _, tau_r, beta_r = reflector_masked(x.real.to(torch.complex128), 1)
    assert complex(tau_r) == 0 and float(beta_r) == -1.5
    p, n = 3, 6
    A = np.triu(_complex_cycle(p, n, 7))
    A[0] += np.diag(_complex_cycle(1, n - 1, 8)[0, 0], -1)
    H, Q = th.phessenberg_core(torch.tensor(A))
    H, Q = H.numpy(), Q.numpy()
    _structure_exact(H)
    assert np.all(np.diagonal(H[0], -1).imag == 0)
    for f in range(1, p):
        assert np.all(np.diagonal(H[f])[:-1].imag == 0)
    assert np.abs(Q - np.eye(n)).max() > 0.1
    for l in range(p):
        R = Q[l].conj().T @ A[l] @ Q[(l + 1) % p] - H[l]
        assert np.abs(R).max() <= 1e-13 * np.abs(A).max()
