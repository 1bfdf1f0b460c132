"""The PyTorch port's real generalized periodic QZ against the JAX package.

Seeded numpy cycles go through both packages on the CPU (JAX's exact-f64
route: ``phessenberg_signed_core`` + ``pqz_real_gen_core``).  Two JAX core
shapes are compiled, once each: (p, n, S) = (3, 8, (T, T, F)) and
(4, 8, alternating).  Every JAX core call here has the static arguments of
the JAX driver's verbose route (``with_info=True``, ``maxitfac=120``), so
the module-scoped fixtures and the end-to-end calls share the compiled
programs.

* the iteration core, started from the JAX reduction and fed the JAX
  core's exceptional-shift normals: niter equal, eigenvalues within
  1e-12 max|lambda|, the same beta, the port's ``check_psd`` at its
  default bound (100 eps), and T and Z within 1e-10 on the draws whose
  eigenvalues are all real.  A complex pair's 2x2 block (in T[0] and the
  matching triangular blocks) is not standardized by either core: it is
  fixed only up to a rotation of its invariant subspace, and a 1e-16
  relative perturbation of the core's input moves it by O(1) (it moves
  the all-real T by ~1e-14), so draws with complex pairs compare the rest.
  The near-cyclic-shift draw takes exceptional and controlled zero shifts;
* planted zero diagonals in a direct factor (DEFLATE_POS) and in an
  inverted factor (DEFLATE_NEG, an infinite eigenvalue: beta = 0), on
  all-real cycles;
* ``pschur(A, 'R'|'L', S=...)`` and ``gpschur`` end to end: eigenvalues
  within 1e-12 max|lambda| of the JAX package's and 1e-10 of numpy's
  eigenvalues of the signed product, ``check_psd`` (residual < 32 eps);
  an all-direct signature with p > 1 and p == 1 against numpy only (other
  JAX programs).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import periodicschurdecompositions_jl_tpu as psd
from periodicschurdecompositions_jl_tpu.ops.hessenberg import \
    phessenberg_signed_core as jhess_signed
from periodicschurdecompositions_jl_tpu.ops.pqz_real import pqz_real_gen_core as jcore
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.ops import pqz_real as tpr
from periodicschurdecompositions_jl_torch.utils.interop import (gps_from_jax,
                                                              gps_to_numpy,
                                                              state_from_jax_rg)

SA = (True, True, False)             # p=3, n=8
SB = (True, False, True, False)      # p=4, n=8 (gpschur pairs)
N = 8


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
    return _normals(1234, 200)


@pytest.fixture(scope="module", autouse=True)
def _jax_verbose():
    """The JAX driver's verbose route calls the core with with_info=True,
    as the fixtures do: one compiled program per shape."""
    psd.setverbosity(1)
    yield
    psd.setverbosity(0)


def _jax_core(H, S, Q):
    T, Z, alr, ali, be, sc, ok, info = jcore(
        jnp.asarray(H), S, Z=jnp.asarray(Q), want_z=True, want_t=True, maxitfac=120,
        with_info=True, aggressive=False)
    assert bool(ok)
    return {"T": np.asarray(T), "Z": np.asarray(Z),
            "alpha": np.asarray(alr) + 1j * np.asarray(ali), "beta": np.asarray(be),
            "scale": np.asarray(sc), "niter": int(info["niter"])}


def _values(al, be, sc):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(al) / np.asarray(be) * np.exp2(np.asarray(sc).astype(float))


def _well(p, n, seed):
    """A cycle whose factors are shifted towards +-3 I (well conditioned)."""
    A = np.random.default_rng(seed).standard_normal((p, n, n))
    for l in range(p):
        A[l] += np.sign(np.linalg.det(A[l])) * 3 * np.eye(n)
    return A


def _real_cycle(p, n, seed):
    """A near-diagonal cycle: well separated real eigenvalues."""
    rng = np.random.default_rng(seed)
    A = [np.diag(1.0 + np.arange(n)) + 0.1 * rng.standard_normal((n, n))]
    A += [np.diag(1.0 + 0.5 * rng.random(n)) + 0.1 * rng.standard_normal((n, n))
          for _ in range(p - 1)]
    return np.stack(A)


def _near_shift_cycle(p, n, seed):
    """A perturbed cyclic shift times near-identities: eigenvalues of nearly
    equal modulus, so the iteration takes exceptional and zero shifts."""
    rng = np.random.default_rng(seed)
    P = np.roll(np.eye(n), 1, axis=0)
    A = [P * (1 + 0.01 * rng.standard_normal((n, n)))]
    A += [np.eye(n) + 1e-3 * rng.standard_normal((n, n)) for _ in range(p - 1)]
    return np.stack(A)


def _reduced(A, S):
    H, Q = jhess_signed(jnp.asarray(A), S, want_q=True)
    return np.asarray(H), np.asarray(Q)


def _case(A, S):
    H, Q = _reduced(A, S)
    return A, H, Q, _jax_core(H, S, Q)


@pytest.fixture(scope="module")
def cases():
    """The core cases (lazily, so that each JAX shape compiles once)."""
    made = {}
    draws = {"real_a": (lambda: _real_cycle(3, N, 1), SA),
             "real_b": (lambda: _real_cycle(4, N, 1), SB),
             "well_a": (lambda: _well(3, N, 0), SA),
             "shift_b": (lambda: _near_shift_cycle(4, N, 0), SB)}

    def get(name):
        if name not in made:
            mk, S = draws[name]
            made[name] = _case(mk(), S) + (S,)
        return made[name]
    return get


def _check_core(A, H, Q, ref, S, normals, tol=100.0, same_t=True):
    Ht, Qt = state_from_jax_rg(H, Q)
    T, Z, alr, ali, be, sc, ok, info = tpr.pqz_real_gen_core(
        Ht, S, Z=Qt, with_info=True, shift_normals=normals)
    assert ok and info["niter"] == ref["niter"]
    w = _values(alr + 1j * ali, be, sc)
    wj = _values(ref["alpha"], ref["beta"], ref["scale"])
    fin = np.isfinite(wj)
    assert np.array_equal(fin, np.isfinite(w))
    assert np.abs(w[fin] - wj[fin]).max() <= 1e-12 * np.abs(wj[fin]).max()
    assert np.array_equal(be, ref["beta"])
    if same_t:
        assert info["pairs"] == 0
        assert np.abs(T.numpy() - ref["T"]).max() <= 1e-10
        assert np.abs(Z.numpy() - ref["Z"]).max() <= 1e-10
    P = pt.GeneralizedPeriodicSchur(
        S=S, schurindex=0, Ts=T, Zs=Z, alpha=torch.tensor(alr + 1j * ali),
        beta=torch.tensor(be), alphascale=torch.tensor(sc), orientation="R")
    ok, rep = pt.check_psd(P, A, tol=tol)
    assert ok, rep
    return info


@pytest.mark.parametrize("case", ["real_a", "real_b", "well_a", "shift_b"])
def test_core_matches_jax(case, cases, normals):
    A, H, Q, ref, S = cases(case)
    info = _check_core(A, H, Q, ref, S, normals, same_t=case.startswith("real"))
    assert info["launches"] == {k: 0 for k in info["launches"]}   # CPU: no kernel
    assert info["attacks"] >= 1 and info["sweeps"] >= 1
    if case == "shift_b":
        assert info["exceptional"] >= 1 and info["czshift"] >= 1
    if case == "well_a":
        assert info["pairs"] >= 1


@pytest.mark.parametrize("factor,hole", [(1, 3), (2, 2), (2, 6)])
def test_planted_zero_diagonal_matches_jax(factor, hole, normals):
    # factor 1 is direct (DEFLATE_POS); factor 2 is inverted (DEFLATE_NEG,
    # chasing up from row 2 and down from row 6; an infinite eigenvalue)
    rng = np.random.default_rng(19)
    H = np.zeros((3, N, N))
    H[0] = np.diag(1.0 + np.arange(N)) + 0.1 * np.triu(rng.standard_normal((N, N)), -1)
    for l in (1, 2):
        H[l] = np.diag(1.0 + 0.5 * rng.random(N)) + 0.1 * np.triu(rng.standard_normal((N, N)))
    H[factor][hole, hole] = 0.0
    eye = np.broadcast_to(np.eye(N), (3, N, N)).copy()
    ref = _jax_core(H, SA, eye)
    info = _check_core(H, H, eye, ref, SA, normals, tol=32.0)
    assert info["deflate_pos" if factor == 1 else "deflate_neg"] >= 1
    assert (ref["beta"] == 0).sum() == (0 if factor == 1 else 1)


def _signed_product(A, S):
    M = np.eye(A.shape[1])
    for a, s in zip(A, S):
        M = M @ (a if s else np.linalg.inv(a))
    return M


def _check_values(w, A, S, lr, wj=None):
    w = np.sort_complex(w)
    if wj is not None:
        wj = np.sort_complex(wj)
        assert np.abs(w - wj).max() <= 1e-12 * np.abs(wj).max()
    Ar = A if lr == "R" else A[::-1]
    Sr = S if lr == "R" else S[::-1]
    wn = np.sort_complex(np.linalg.eigvals(_signed_product(Ar, Sr)))
    assert np.abs(w - wn).max() <= 1e-10 * np.abs(wn).max()


@pytest.mark.parametrize("lr", ["R", "L"])
def test_pschur_real_signed_matches_jax(lr):
    A = _well(3, N, 41)
    S = SA if lr == "R" else SA[::-1]     # the leading factor of the product is direct
    P = pt.pschur(A, lr, S=S, device="cpu")
    Pj = psd.pschur(jnp.asarray(A), lr, S=S)
    assert isinstance(P, pt.GeneralizedPeriodicSchur)
    assert P.orientation == lr and P.S == S
    assert P.alpha.dtype == torch.complex128 and P.beta.dtype == torch.float64
    assert P.alphascale.dtype == torch.int32
    assert tpr.last_info["niter"] <= 120 * N and tpr.last_info["converged"]
    _check_values(P.values.numpy(), A, S, lr, np.asarray(Pj.values))
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep


def test_gpschur_real_matches_jax():
    rng = np.random.default_rng(42)
    As = [a + 3 * np.eye(N) for a in rng.standard_normal((2, N, N))]
    Bs = [b + 3 * np.eye(N) for b in rng.standard_normal((2, N, N))]
    P = pt.gpschur(As, Bs, device="cpu")
    Pj = psd.gpschur([jnp.asarray(a) for a in As], [jnp.asarray(b) for b in Bs])
    assert P.S == SB and not P.Ts.is_complex()
    w = np.sort_complex(P.values.numpy())
    wj = np.sort_complex(np.asarray(Pj.values))
    assert np.abs(w - wj).max() <= 1e-12 * np.abs(wj).max()
    M = np.linalg.inv(Bs[1]) @ As[1] @ np.linalg.inv(Bs[0]) @ As[0]
    wn = np.sort_complex(np.linalg.eigvals(M))
    assert np.abs(w - wn).max() <= 1e-10 * np.abs(wn).max()
    C = np.stack([As[1], Bs[0], As[0], Bs[1]])
    ok, rep = pt.check_psd(P, C, tol=32.0)
    assert ok, rep


@pytest.mark.parametrize("p,S", [(3, (True, True, True)), (1, (True,))])
def test_all_direct_signature(p, S):
    # all(S) with p > 1: the plain reduction, then the rg core; p == 1: the
    # real QR core, with the eigenvalues in (alpha, scale) form
    A = np.random.default_rng(43 + p).standard_normal((p, N, N))
    P = pt.pschur(A, "R", S=S, device="cpu")
    assert isinstance(P, pt.GeneralizedPeriodicSchur) and P.S == S
    a = np.abs(P.alpha.numpy())
    assert np.all((a == 0) | ((a >= 1) & (a < 2)))
    _check_values(P.values.numpy(), A, S, "R")
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep


def test_real_generalized_interop_roundtrip(cases):
    A, H, Q, ref, _ = cases("well_a")
    Pj = psd.GeneralizedPeriodicSchur(
        S=SA, schurindex=0, Ts=jnp.asarray(ref["T"]), Zs=jnp.asarray(ref["Z"]),
        alpha=jnp.asarray(ref["alpha"]), beta=jnp.asarray(ref["beta"]),
        alphascale=jnp.asarray(ref["scale"]), orientation="R")
    P = gps_from_jax(Pj)
    assert P.Ts.dtype == torch.float64 and P.alpha.dtype == torch.complex128
    ok, rep = pt.check_psd(P, A)
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


def test_no_z_keeps_t_and_the_budget_default():
    A = torch.tensor(_well(3, N, 44))
    P1 = pt.pschur(A, S=SA)
    assert tpr.last_info["maxit"] == 120 * N          # the real S route's default
    P2 = pt.pschur(A, S=SA, want_z=False)
    assert P2.Zs is None and torch.equal(P1.Ts, P2.Ts)


def test_aggressive_option():
    A = _near_shift_cycle(4, N, 0)
    with pytest.raises(ValueError):
        pt.pschur(A, S=None, aggressive=True, device="cpu")
    with pytest.raises(ValueError):
        pt.pschur(A + 0j, S=SB, aggressive=True, device="cpu")
    # the controlled zero shift this draw takes is refused with aggressive
    # thresholds, as in the JAX package (reference src/rgeneralized.jl:245-247)
    with pytest.raises(pt.PSDNotImplemented):
        pt.pschur(A, S=SB, aggressive=True, device="cpu")
    P = pt.pschur(_well(3, N, 45), S=SA, aggressive=True, device="cpu")
    ok, rep = pt.check_psd(P, _well(3, N, 45), tol=32.0)
    assert ok, rep
