"""The PyTorch port's complex periodic QZ route against the JAX package.

Seeded numpy cycles go through both packages on the CPU (JAX's exact-c128
route: ``phessenberg_core``/``phessenberg_signed_core`` + ``pqz_complex_core``).
Three JAX shapes are compiled, once each: (p, n, S) = (3, 8, mixed),
(4, 8, all direct), (4, 8, alternating).  Every JAX call here has the
static arguments of the JAX driver's verbose route, so the module-scoped
fixtures and the end-to-end calls share the compiled programs.

* the reductions: H and Q within 1e-12 (relative to max|A|), exact
  structure, and the similarity contract;
* the iteration core, started from the JAX reduction and fed the JAX
  core's exceptional-shift normals: niter equal, eigenvalues within
  1e-12 max|lambda|, T and Z within 1e-10, the port's ``check_psd`` at its
  default bound (100 eps, the reference's).  The near-cyclic-shift draws
  take exceptional shifts and controlled zero shifts;
* planted zero diagonals in a direct factor (DEFLATE_POS) and in an
  inverted factor, near the bottom and the top (DEFLATE_NEG chasing down
  and up): as the core, plus the infinite eigenvalue;
* ``pschur`` and ``gpschur`` end to end: eigenvalues within 1e-12
  max|lambda| of the JAX package's and 1e-10 of numpy's eigenvalues of the
  signed product, and ``check_psd`` (residual < 32 eps, ||ZZ'-I|| < 10 eps n).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import periodicschurdecompositions_jl_tpu as psd
from periodicschurdecompositions_jl_tpu.ops.hessenberg import (
    phessenberg_core as jhess, phessenberg_signed_core as jhess_signed)
from periodicschurdecompositions_jl_tpu.ops.pqz_complex import pqz_complex_core as jcore
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.ops import pqz_complex as tpq
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_signed_core
from periodicschurdecompositions_jl_torch.utils.interop import (gps_from_jax,
                                                              gps_to_numpy,
                                                              state_from_jax_cx)

EPS = np.finfo(np.float64).eps
SA = (True, True, False)             # p=3, n=8, mixed
SB = (True, True, True, True)        # p=4, n=8, all direct
SC = (True, False, True, False)      # p=4, n=8, alternating (gpschur pairs)
N = 8


def _cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _near_shift_cycle(p, n, seed):
    """A perturbed cyclic shift times near-identities: eigenvalues of nearly
    equal modulus, so the iteration takes exceptional and zero shifts."""
    rng = np.random.default_rng(seed)
    P = np.roll(np.eye(n), 1, axis=0)
    A = [P * (1 + 0.01 * rng.standard_normal((n, n)))]
    A += [np.eye(n) + 1e-3 * rng.standard_normal((n, n)) for _ in range(p - 1)]
    return np.stack(A).astype(complex)


def _normals(seed, k):
    """The JAX core's exceptional-shift normals: it splits its key on every
    sweep and draws normal(sub, (4,))."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (4,), jnp.float64)))
    return np.array(out)


@pytest.fixture(scope="module")
def normals():
    return _normals(1234, 120)


@pytest.fixture(scope="module", autouse=True)
def _jax_verbose():
    """The JAX driver's verbose route calls the core with with_info=True,
    as the fixtures do: one compiled program per shape."""
    psd.setverbosity(1)
    yield
    psd.setverbosity(0)


def _jax_core(H, S, Q):
    T, Z, al, be, sc, ok, info = jcore(jnp.asarray(H), S, Z=jnp.asarray(Q),
                                       want_z=True, want_t=True, maxitfac=30,
                                       with_info=True)
    assert bool(ok)
    return {"T": np.asarray(T), "Z": np.asarray(Z), "alpha": np.asarray(al),
            "beta": np.asarray(be), "scale": np.asarray(sc),
            "niter": int(info["niter"])}


def _values(al, be, sc):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(al) / np.asarray(be) * np.exp2(np.asarray(sc).astype(float))


@pytest.fixture(scope="module")
def mixed():
    A = _near_shift_cycle(3, N, 0)
    H, Q = jhess_signed(jnp.asarray(A), SA, want_q=True)
    H, Q = np.asarray(H), np.asarray(Q)
    return A, H, Q, _jax_core(H, SA, Q)


@pytest.fixture(scope="module")
def direct():
    A = _near_shift_cycle(4, N, 0)
    H, Q = jhess(jnp.asarray(A), want_q=True)
    H, Q = np.asarray(H), np.asarray(Q)
    return A, H, Q, _jax_core(H, SB, Q)


def _check_core(A, H, Q, ref, S, normals):
    Ht, Qt = state_from_jax_cx(H, Q)
    T, Z, al, be, sc, ok, info = tpq.pqz_complex_core(Ht, S, Z=Qt, with_info=True,
                                                      shift_normals=normals)
    assert ok and info["niter"] == ref["niter"]
    w = _values(al.numpy(), be.numpy(), sc.numpy())
    wj = _values(ref["alpha"], ref["beta"], ref["scale"])
    fin = np.isfinite(wj)
    assert np.array_equal(fin, np.isfinite(w))
    assert np.abs(w[fin] - wj[fin]).max() <= 1e-12 * np.abs(wj[fin]).max()
    assert np.abs(T.numpy() - ref["T"]).max() <= 1e-10
    assert np.abs(Z.numpy() - ref["Z"]).max() <= 1e-10
    P = pt.GeneralizedPeriodicSchur(S=S, schurindex=0, Ts=T, Zs=Z, alpha=al, beta=be,
                                    alphascale=sc, orientation="R")
    ok, rep = pt.check_psd(P, A)
    assert ok, rep
    return info


@pytest.mark.parametrize("case", ["mixed", "direct"])
def test_core_matches_jax(case, mixed, direct, normals):
    A, H, Q, ref = mixed if case == "mixed" else direct
    info = _check_core(A, H, Q, ref, SA if case == "mixed" else SB, normals)
    assert info["exceptional"] >= 1 and info["czshift"] >= 1


@pytest.mark.parametrize("factor,hole", [(1, 3), (2, 2), (2, 6)])
def test_planted_zero_diagonal_matches_jax(factor, hole, mixed, normals):
    # factor 1 is direct (DEFLATE_POS); factor 2 is inverted (DEFLATE_NEG,
    # chasing up from row 2 and down from row 6)
    rng = np.random.default_rng(17)
    H = np.zeros((3, N, N), complex)
    H[0] = np.triu(_cplx(rng, N, N), -1)
    H[1:] = np.triu(_cplx(rng, 2, N, N))
    H[factor][hole, hole] = 0.0
    eye = np.broadcast_to(np.eye(N), (3, N, N)).astype(complex)
    ref = _jax_core(H, SA, eye)
    Ht, _ = state_from_jax_cx(H)
    T, Z, al, be, sc, ok, info = tpq.pqz_complex_core(Ht, SA, with_info=True,
                                                      shift_normals=normals)
    assert ok and info["niter"] == ref["niter"]
    assert info["deflate_pos" if factor == 1 else "deflate_neg"] >= 1
    assert np.array_equal(be.numpy(), ref["beta"])
    assert (be.numpy() == 0).sum() == (0 if factor == 1 else 1)
    w = _values(al.numpy(), be.numpy(), sc.numpy())
    wj = _values(ref["alpha"], ref["beta"], ref["scale"])
    fin = np.isfinite(wj)
    assert np.abs(w[fin] - wj[fin]).max() <= 1e-12 * np.abs(wj[fin]).max()
    assert np.abs(T.numpy() - ref["T"]).max() <= 1e-10
    assert np.abs(Z.numpy() - ref["Z"]).max() <= 1e-10
    P = pt.GeneralizedPeriodicSchur(S=SA, schurindex=0, Ts=T, Zs=Z, alpha=al,
                                    beta=be, alphascale=sc, orientation="R")
    ok, rep = pt.check_psd(P, H, tol=32.0)
    assert ok, rep


def test_phessenberg_matches_jax(direct):
    A = direct[0]
    H, Q = pt.phessenberg(A, device="cpu")
    Hj, Qj = direct[1], direct[2]
    scale = np.abs(A).max()
    assert np.abs(H.numpy() - Hj).max() <= 1e-12 * scale
    assert np.abs(Q.numpy() - Qj).max() <= 1e-12
    _contract(A, H.numpy(), Q.numpy(), SB)


def _contract(A, H, Q, S):
    p = len(S)
    assert np.all(np.tril(H[0], -2) == 0)
    for l in range(1, p):
        assert np.all(np.tril(H[l], -1) == 0)
    for l in range(p):
        a, b = (l, (l + 1) % p) if S[l] else ((l + 1) % p, l)
        R = Q[a].conj().T @ A[l] @ Q[b]
        assert np.abs(R - H[l]).max() <= 1e-12 * np.abs(A).max()


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_phessenberg_signed_matches_jax(kind):
    rng = np.random.default_rng(23)
    A = rng.standard_normal((4, N, N))
    if kind == "complex":
        A = A + 1j * rng.standard_normal((4, N, N))
    Hj, Qj = jhess_signed(jnp.asarray(A), SC, want_q=True)
    H, Q = phessenberg_signed_core(torch.tensor(A), SC)
    scale = np.abs(A).max()
    assert np.abs(H.numpy() - np.asarray(Hj)).max() <= 1e-12 * scale
    assert np.abs(Q.numpy() - np.asarray(Qj)).max() <= 1e-12
    _contract(A, H.numpy(), Q.numpy(), SC)


def _signed_product(A, S):
    M = np.eye(A.shape[1], dtype=complex)
    for a, s in zip(A, S):
        M = M @ (a if s else np.linalg.inv(a))
    return M


def _check_values(w, wj, A, S, lr):
    w, wj = np.sort_complex(w), np.sort_complex(wj)
    assert np.abs(w - wj).max() <= 1e-12 * np.abs(wj).max()
    Ar = A if lr == "R" else A[::-1]
    Sr = S if lr == "R" else S[::-1]
    wn = np.sort_complex(np.linalg.eigvals(_signed_product(Ar, Sr)))
    assert np.abs(w - wn).max() <= 1e-10 * np.abs(wn).max()


@pytest.mark.parametrize("lr", ["R", "L"])
def test_pschur_complex_matches_jax(lr):
    A = _cplx(np.random.default_rng(40), 4, N, N)
    P = pt.pschur(torch.tensor(A), lr)
    Pj = psd.pschur(jnp.asarray(A), lr)
    assert isinstance(P, pt.PeriodicSchur) and P.orientation == lr
    _check_values(P.values.numpy(), np.asarray(Pj.values), A, SB, lr)
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep


@pytest.mark.parametrize("lr", ["R", "L"])
def test_pschur_signed_matches_jax(lr):
    A = _cplx(np.random.default_rng(41), 3, N, N)
    S = SA if lr == "R" else SA[::-1]     # the leading factor of the product is direct
    P = pt.pschur(A, lr, S=S, device="cpu")
    Pj = psd.pschur(jnp.asarray(A), lr, S=S)
    assert isinstance(P, pt.GeneralizedPeriodicSchur)
    assert P.orientation == lr and P.S == S
    _check_values(P.values.numpy(), np.asarray(Pj.values), A, S, lr)
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep


def test_gpschur_complex_matches_jax():
    rng = np.random.default_rng(42)
    As, Bs = list(_cplx(rng, 2, N, N)), list(_cplx(rng, 2, N, N))
    P = pt.gpschur(As, Bs, device="cpu")
    Pj = psd.gpschur([jnp.asarray(a) for a in As], [jnp.asarray(b) for b in Bs])
    assert P.S == SC
    w = np.sort_complex(P.values.numpy())
    wj = np.sort_complex(np.asarray(Pj.values))
    assert np.abs(w - wj).max() <= 1e-12 * np.abs(wj).max()
    # B1^-1 A1 B0^-1 A0 has the eigenvalues of the interleaved cycle
    M = np.linalg.inv(Bs[1]) @ As[1] @ np.linalg.inv(Bs[0]) @ As[0]
    wn = np.sort_complex(np.linalg.eigvals(M))
    assert np.abs(w - wn).max() <= 1e-10 * np.abs(wn).max()
    C = np.stack([As[1], Bs[0], As[0], Bs[1]])
    ok, rep = pt.check_psd(P, C, tol=32.0)
    assert ok, rep
    # a leading inverted factor is refused by both packages
    with pytest.raises(ValueError):
        pt.gpschur(As, Bs, lr="L", device="cpu")
    with pytest.raises(ValueError):
        psd.gpschur([jnp.asarray(a) for a in As], [jnp.asarray(b) for b in Bs], lr="L")


def test_generalized_interop_roundtrip(mixed):
    A, H, Q, ref = mixed
    Pj = psd.GeneralizedPeriodicSchur(
        S=SA, schurindex=0, Ts=jnp.asarray(ref["T"]), Zs=jnp.asarray(ref["Z"]),
        alpha=jnp.asarray(ref["alpha"]), beta=jnp.asarray(ref["beta"]),
        alphascale=jnp.asarray(ref["scale"]), orientation="R")
    P = gps_from_jax(Pj)
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep
    back = gps_to_numpy(P)
    assert np.array_equal(back["Ts"], ref["T"]) and np.array_equal(back["alpha"],
                                                                    ref["alpha"])
    okj, _ = psd.check_psd(psd.GeneralizedPeriodicSchur(
        S=back["S"], schurindex=back["schurindex"], Ts=jnp.asarray(back["Ts"]),
        Zs=jnp.asarray(back["Zs"]), alpha=jnp.asarray(back["alpha"]),
        beta=jnp.asarray(back["beta"]), alphascale=jnp.asarray(back["alphascale"]),
        orientation=back["orientation"]), A)
    assert okj


def test_complex_no_z_keeps_t():
    A = torch.tensor(_cplx(np.random.default_rng(43), 3, N, N))
    P1 = pt.pschur(A, S=SA)
    P2 = pt.pschur(A, S=SA, want_z=False)
    assert P2.Zs is None and torch.equal(P1.Ts, P2.Ts)


def test_array_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _cplx(np.random.default_rng(44), 2, 4, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.pschur(A)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.phessenberg(list(A.real))
    P = pt.pschur(torch.tensor(A))                 # a CPU tensor stays on the CPU
    assert P.Ts.device.type == "cpu"
    assert pt.pschur(A, device="cpu").Ts.device.type == "cpu"
