"""The port's batches and ensemble (``parallel/mesh.py``) against the JAX
package's ``batched_pschur_real`` / ``batched_pschur_complex`` (no mesh),
on CPU tensors.

One JAX compile each for the real and the complex batch (module fixtures);
the port runs the same numpy draws with two worker threads, and over a
mesh of two CPU entries.  The JAX ``ensemble_pschur_real_pipelined`` runs
the float-float chunked driver on Pallas kernels, which the CPU can only
interpret at far beyond this file's budget: the port's ensemble is held
against the JAX batch's lanes instead (the same float64 semantics), and
against its own sequential loop bit for bit.

Gates: every lane converged; lane residual max_l max|Z T Z' - A| / max|A|
< 1e-10 (real) and its signed form (complex); eigenvalues within 1e-12
relative to the largest of the JAX lane's.
"""
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_tpu.parallel import mesh as jmesh

CPU = torch.device("cpu")
B, P, N = 2, 2, 10
PC, NC = 2, 6
SC = (True, False)


@pytest.fixture(scope="module")
def real_batch():
    A = np.random.default_rng(2401).standard_normal((B, P, N, N))
    import jax.numpy as jnp
    out = jmesh.batched_pschur_real(jnp.asarray(A))
    return A, [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def port_real(real_batch):
    """The port's batch with no mesh on one worker (the plain loop) and
    over a two-entry CPU mesh with two workers."""
    A = torch.tensor(real_batch[0])
    return {None: pt.batched_pschur_real(A, workers=1),
            "mesh": pt.batched_pschur_real(A, mesh=[CPU, CPU], workers=2)}


@pytest.fixture(scope="module")
def cx_batch():
    rng = np.random.default_rng(2402)
    A = rng.standard_normal((B, PC, NC, NC)) + 1j * rng.standard_normal((B, PC, NC, NC))
    import jax.numpy as jnp
    out = jmesh.batched_pschur_complex(jnp.asarray(A), SC)
    return A, [np.asarray(o) for o in out]


def _real_residual(A, T, Z):
    p = A.shape[0]
    return max(np.abs(Z[l] @ T[l] @ Z[(l + 1) % p].T - A[l]).max()
               for l in range(p)) / np.abs(A).max()


def _cx_residual(A, T, Z, S):
    p = A.shape[0]
    worst = 0.0
    for l in range(p):
        ln = (l + 1) % p
        R = Z[l] @ T[l] @ Z[ln].conj().T if S[l] else Z[ln] @ T[l] @ Z[l].conj().T
        worst = max(worst, np.abs(R - A[l]).max())
    return worst / np.abs(A).max()


def _eig_close(w, ref):
    a, b = np.sort_complex(np.asarray(w)), np.sort_complex(np.asarray(ref))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cx_values(alpha, beta, scale):
    return alpha / beta * 2.0 ** scale


@pytest.mark.parametrize("mesh", [None, "mesh"])
def test_batched_real_matches_jax(real_batch, port_real, mesh):
    A, (Tj, Zj, wrj, wij, okj) = real_batch
    T, Z, wr, wi, ok = port_real[mesh]
    assert T.shape == (B, P, N, N) and Z.shape == (B, P, N, N) and wr.shape == (B, N)
    assert bool(ok.all()) and bool(np.all(okj))
    for b in range(B):
        assert _real_residual(A[b], T[b].numpy(), Z[b].numpy()) < 1e-10
        assert _eig_close(wr[b].numpy() + 1j * wi[b].numpy(), wrj[b] + 1j * wij[b]) <= 1e-12


def test_batched_real_mesh_is_the_lone_run(port_real):
    # the lanes of a two-entry mesh are the runs of one device, bit for bit
    assert all(torch.equal(x, y) for x, y in zip(port_real[None], port_real["mesh"]))


def test_batched_complex_matches_jax(cx_batch):
    A, (Tj, Zj, aj, bj, sj, okj) = cx_batch
    T, Z, alpha, beta, scale, ok = pt.batched_pschur_complex(torch.tensor(A), SC,
                                                            mesh=[CPU, CPU])
    assert T.shape == (B, PC, NC, NC) and alpha.shape == (B, NC)
    assert bool(ok.all()) and bool(np.all(okj))
    for b in range(B):
        assert _cx_residual(A[b], T[b].numpy(), Z[b].numpy(), SC) < 1e-10
        w = _cx_values(alpha[b].numpy(), beta[b].numpy(), scale[b].numpy())
        assert _eig_close(w, _cx_values(aj[b], bj[b], sj[b])) <= 1e-12


def test_ensemble_matches_the_jax_lanes_and_its_sequential_loop(real_batch):
    A, (Tj, Zj, wrj, wij, okj) = real_batch
    piped = pt.ensemble_pschur_real_pipelined(list(A), device="cpu", workers=2)
    seq = pt.ensemble_pschur_real_pipelined(list(A), device="cpu", workers=1)
    assert len(piped) == B
    for b, ((T, Z, wr, wi, ok), s) in enumerate(zip(piped, seq)):
        assert ok and isinstance(T, np.ndarray) and T.shape == (P, N, N)
        assert all(np.array_equal(x, y) for x, y in zip((T, Z, wr, wi), s[:4]))
        assert _real_residual(A[b], T, Z) < 1e-10
        assert _eig_close(wr + 1j * wi, wrj[b] + 1j * wij[b]) <= 1e-12


def test_a_thread_error_reaches_the_caller():
    bad = [np.zeros((2, 4, 5))]  # not square: the reduction raises in its thread
    with pytest.raises(ValueError, match="square"):
        pt.ensemble_pschur_real_pipelined(bad * 3, device="cpu", workers=2)


def test_make_mesh():
    assert pt.make_mesh(3, devices=["cpu"] * 4) == (CPU,) * 3
    with pytest.raises(ValueError, match="requested 5 devices, have 4"):
        pt.make_mesh(5, devices=["cpu"] * 4)
