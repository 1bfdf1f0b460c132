"""The PyTorch port's ``pschur`` (real, no signature) against the JAX package.

Inputs are seeded numpy cycles fed to both.  The JAX side is the exact-f64
CPU route of ``psd.pschur`` (``phessenberg_core`` + ``pqr_real_core``), run
with ``with_info`` to read its iteration count.

* eigenvalues: sorted, within 1e-10 max|lambda| (the product's eigenvalues
  are well separated at these sizes);
* the port's ``check_psd``: per-factor residual < 32 eps ||A||_1 and
  ||Z Z' - I||_1 < 10 eps n;
* the iteration count equals the JAX core's;
* T and Z from the iteration, both started from the JAX reduction: within
  1e-10 at (1, 8, 'R').  Elsewhere a rounding tie can flip a 2x2 block's
  standardization: at (4, 12, 'R') and (3, 10, 'L') a 1e-16 relative
  perturbation of the JAX core's own input changes T by O(1) (a complex
  pair's block comes out in another, equally standard, orientation), and
  at (3, 10, 'R') the outcome follows XLA:CPU's fusion flags.  Those cases
  compare the eigenvalues, the iteration count and the contract.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import periodicschurdecompositions_jl_tpu as psd
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_tpu.ops.pqr_real import pqr_real_core as jcore
from periodicschurdecompositions_jl_torch.ops import pqr_real as tpq
from periodicschurdecompositions_jl_torch.utils.interop import (schur_from_jax,
                                                              schur_to_numpy)

EPS = np.finfo(np.float64).eps


def _jax_reference(A, lr):
    Ar = A if lr == "R" else A[::-1]
    Hj, Qj = psd.phessenberg(jnp.asarray(np.ascontiguousarray(Ar)))
    T, Z, wr, wi, ok, info = jcore(Hj, Z=Qj, with_info=True)
    assert bool(ok)
    return (np.asarray(Hj), np.asarray(Qj), np.asarray(T), np.asarray(Z),
            np.asarray(wr) + 1j * np.asarray(wi), int(info["niter"]))


@pytest.mark.parametrize("p,n,lr,same_blocks", [
    (1, 8, "R", True),
    (3, 10, "R", False),
    (4, 12, "R", False),
    (3, 10, "L", False),
])
def test_pschur_matches_jax(p, n, lr, same_blocks):
    A = np.random.default_rng(p * 10 + n).standard_normal((p, n, n))
    Hj, Qj, Tj, Zj, wj, niter_j = _jax_reference(A, lr)

    P = pt.pschur(torch.tensor(A), lr)
    assert P.orientation == lr
    w = np.sort_complex(P.values.numpy())
    wref = np.sort_complex(wj)
    assert np.abs(w - wref).max() <= 1e-10 * np.abs(wref).max()
    ok, rep = pt.check_psd(P, A, qtol=10.0, tol=32.0)
    assert ok, rep
    assert tpq.last_info["niter"] == niter_j

    T, Z, wr, wi, ok2, info = tpq.pqr_real_core(torch.tensor(Hj), torch.tensor(Qj),
                                               with_info=True)
    assert ok2 and info["niter"] == niter_j
    assert np.abs((wr + 1j * wi) - wj).max() <= 1e-10 * np.abs(wj).max()
    if same_blocks:
        assert np.abs(T.numpy() - Tj).max() <= 1e-10 * np.abs(Tj).max()
        assert np.abs(Z.numpy() - Zj).max() <= 1e-10


def test_repair_chain_matches_jax(monkeypatch):
    # negligible triangular diagonals make product subdiagonals negligible
    # while H[0]'s are not: the RQ repair chain runs.  MB03WD's repair
    # forces the leftover entry to zero "even when wrong" (extra_rq off),
    # so both packages reconstruct the cycle only up to that same entry:
    # the residuals must agree, not vanish.
    p, n = 3, 10
    rng = np.random.default_rng(2)
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f] = np.triu(rng.standard_normal((n, n)))
    H[1][5, 5] = 1e-30
    H[2][7, 7] = 0.0
    Z = np.broadcast_to(np.eye(n), (p, n, n)).copy()
    T, Zj, wr, wi, ok, info = jcore(jnp.asarray(H), Z=jnp.asarray(Z), with_info=True)
    assert bool(ok)
    ran = []
    repair = tpq._repair
    monkeypatch.setattr(tpq, "_repair", lambda *a: ran.append(1) or repair(*a))
    Tt, Zt, wrt, wit, okt, infot = tpq.pqr_real_core(torch.tensor(H), torch.tensor(Z),
                                                     with_info=True)
    assert okt and ran
    assert infot["niter"] == int(info["niter"])
    wj = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
    w = np.sort_complex(wrt + 1j * wit)
    assert np.abs(w - wj).max() <= 1e-10 * np.abs(wj).max()

    def residual(T, Z):
        return max(np.abs(Z[l] @ T[l] @ Z[(l + 1) % p].T - H[l]).max()
                   for l in range(p))
    assert abs(residual(Tt.numpy(), Zt.numpy()) -
               residual(np.asarray(T), np.asarray(Zj))) <= 1e-12


def test_schur_interop_roundtrip():
    p, n = 3, 10
    A = np.random.default_rng(p * 10 + n).standard_normal((p, n, n))
    _, _, Tj, Zj, wj, _ = _jax_reference(A, "R")
    Pj = psd.PeriodicSchur(Ts=jnp.asarray(Tj), Zs=jnp.asarray(Zj),
                           values=jnp.asarray(wj), orientation="R", schurindex=0)
    P = schur_from_jax(Pj)
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep
    back = schur_to_numpy(P)
    assert np.array_equal(back["Ts"], Tj) and np.array_equal(back["Zs"], Zj)
    okj, _ = psd.check_psd(psd.PeriodicSchur(
        Ts=jnp.asarray(back["Ts"]), Zs=jnp.asarray(back["Zs"]),
        values=jnp.asarray(back["values"]), orientation=back["orientation"],
        schurindex=back["schurindex"]), A)
    assert okj


def test_convergence_failure_at_zero_budget():
    A = torch.tensor(np.random.default_rng(1).standard_normal((3, 10, 10)))
    with pytest.raises(pt.ConvergenceFailure):
        pt.pschur(A, maxitfac=0)


def test_no_z_keeps_eigenvalues():
    A = np.random.default_rng(31).standard_normal((3, 10, 10))
    P1 = pt.pschur(torch.tensor(A))
    P2 = pt.pschur(torch.tensor(A), want_z=False)
    assert P2.Zs is None
    assert torch.equal(P1.Ts, P2.Ts)


@pytest.mark.parametrize("route", ["complex", "signature", "want_t", "gpschur"])
def test_want_t_false_keeps_the_eigenvalues(route):
    # want_t=False (the eigenvalues-only mode) on every route: real and
    # complex input, with and without a signature (real S= through pschur
    # and gpschur): the iteration count and the eigenvalues of want_t=True
    from periodicschurdecompositions_jl_torch.ops import pqz_complex, pqz_real
    rng = np.random.default_rng(2)
    A = rng.standard_normal((2, 12, 12))
    C = A + 1j * rng.standard_normal(A.shape)
    info = {"complex": pqz_complex, "signature": pqz_real, "want_t": tpq,
            "gpschur": pqz_real}[route].last_info
    runs = []
    for want_t in (True, False):
        if route == "complex":
            P = pt.pschur(C, want_t=want_t, device="cpu")
        elif route == "signature":
            P = pt.pschur(A, S=[True, False], want_t=want_t, device="cpu")
        elif route == "want_t":
            P = pt.pschur(A, want_t=want_t, device="cpu")
        else:
            P = pt.gpschur([A[0]], [A[1]], want_t=want_t, device="cpu")
        runs.append((info["niter"], P.values.numpy()))
    (n1, w1), (n2, w2) = runs
    assert n1 == n2
    assert np.abs(w2 - w1).max() <= 1e-12 * np.abs(w1).max()


@pytest.mark.parametrize("backend", ["auto", "f64", "complex"])
def test_backend_keyword_takes_the_one_route(backend):
    # the JAX package's routing keyword: every f64 / c128 name is the port's route
    A = np.random.default_rng(41).standard_normal((3, 8, 8))
    P0 = pt.pschur(torch.tensor(A))
    P = pt.pschur(torch.tensor(A), backend=backend)
    assert torch.equal(P.Ts, P0.Ts) and torch.equal(P.Zs, P0.Zs)
    G = pt.gpschur([A[0]], [A[1]], backend=backend, device="cpu")
    assert G.Ts.shape == (2, 8, 8)


@pytest.mark.parametrize("backend", ["ff", "split"])
def test_tpu_only_backends_raise(backend):
    A = np.random.default_rng(42).standard_normal((2, 4, 4))
    with pytest.raises(ValueError, match="JAX package"):
        pt.pschur(A, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="JAX package"):
        pt.gpschur([A[0]], [A[1]], backend=backend, device="cpu")
