"""``want_t=False`` of the port's complex and real generalized iterations
against the JAX package.

The reference's eigenvalues-only mode keeps the sweeps' (and the rg 2x2
attacks') row updates to the columns up to the window's bottom ilast and
their column updates of H to the rows from its top jlo (JAX
``ops/pqz_complex.py:178-182``, ``ops/pqz_real.py:364-387,453-454,484-487``);
Z, the deflation actions and the final rescaling or scrub act in full.  On
the CPU:

* ``pqz_complex_core`` (p=3 n=8, S mixed, a near-cyclic-shift draw that
  takes exceptional and controlled zero shifts, fed the JAX core's
  exceptional-shift normals) and ``pqz_real_gen_core`` (p=3 n=8, S mixed,
  a draw with real eigenvalues, whose T is unique) against the JAX f64
  cores with ``want_t=False`` on the port's signed reduction: niter equal,
  eigenvalues within 1e-12 max|lambda|, the whole T stack and Z within
  1e-10.  One JAX compile each;
* the AED drivers (``pqz_real_gen_core_aed``, ``pqz_complex_core_aed``)
  called directly at p=3 n=28 with a small window, and with the host tail:
  without T the same niter, tallies, eigenvalues and Z as with T, bit for
  bit, and eigenvalues within 1000 eps max|lambda| of the signed product's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from periodicschurdecompositions_jl_tpu.ops.pqz_complex import pqz_complex_core as jcx
from periodicschurdecompositions_jl_tpu.ops.pqz_real import pqz_real_gen_core as jrg
from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.ops import pqz_complex, pqz_real
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_signed_core

S3 = (True, True, False)
EPS = np.finfo(np.float64).eps


def _normals(seed, k):
    """The JAX cores' exceptional-shift normals: they split their key on
    every sweep and draw normal(sub, (4,))."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (4,), jnp.float64)))
    return np.array(out)


def _values(al, be, sc):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(al) / np.asarray(be) * np.exp2(np.asarray(sc).astype(float))


def _near_shift_cycle(p, n, seed):
    rng = np.random.default_rng(seed)
    P = np.roll(np.eye(n), 1, axis=0)
    A = [P * (1 + 0.01 * rng.standard_normal((n, n)))]
    A += [np.eye(n) + 1e-3 * rng.standard_normal((n, n)) for _ in range(p - 1)]
    return np.stack(A).astype(complex)


def _real_cycle(p, n, seed):
    rng = np.random.default_rng(seed)
    A = [np.diag(1.0 + np.arange(n)) + 0.1 * rng.standard_normal((n, n))]
    A += [np.diag(1.0 + 0.5 * rng.random(n)) + 0.1 * rng.standard_normal((n, n))
          for _ in range(p - 1)]
    return np.stack(A)


def _compare(T, Z, w, niter, Tj, Zj, wj, niter_j):
    assert niter == niter_j
    fin = np.isfinite(wj)
    assert np.array_equal(fin, np.isfinite(w))
    assert np.abs(w[fin] - wj[fin]).max() <= 1e-12 * np.abs(wj[fin]).max()
    assert np.abs(T.numpy() - np.asarray(Tj)).max() <= 1e-10
    assert np.abs(Z.numpy() - np.asarray(Zj)).max() <= 1e-10


def test_complex_core_without_t_matches_jax():
    A = torch.tensor(_near_shift_cycle(3, 8, 0))
    H, Q = phessenberg_signed_core(A, S3)
    T, Z, al, be, sc, ok, info = pqz_complex.pqz_complex_core(
        H, S3, Z=Q, want_t=False, with_info=True, shift_normals=_normals(1234, 120))
    Tj, Zj, alj, bej, scj, okj, infoj = jcx(jnp.asarray(H.numpy()), S3,
                                            Z=jnp.asarray(Q.numpy()), want_z=True,
                                            want_t=False, maxitfac=30, with_info=True)
    assert ok and bool(okj)
    assert info["exceptional"] >= 1 and info["czshift"] >= 1
    _compare(T, Z, _values(al.numpy(), be.numpy(), sc.numpy()), info["niter"], Tj, Zj,
             _values(alj, bej, scj), int(infoj["niter"]))


def test_real_generalized_core_without_t_matches_jax():
    A = torch.tensor(_real_cycle(3, 8, 1))
    H, Q = phessenberg_signed_core(A, S3)
    T, Z, alr, ali, be, sc, ok, info = pqz_real.pqz_real_gen_core(
        H, S3, Z=Q, want_t=False, with_info=True, shift_normals=_normals(1234, 200))
    Tj, Zj, alrj, alij, bej, scj, okj, infoj = jrg(
        jnp.asarray(H.numpy()), S3, Z=jnp.asarray(Q.numpy()), want_z=True, want_t=False,
        maxitfac=120, with_info=True, aggressive=False)
    assert ok and bool(okj) and info["pairs"] == 0
    assert info["attacks"] >= 1 and info["sweeps"] >= 1
    _compare(T, Z, _values(alr + 1j * ali, be, sc), info["niter"], Tj, Zj,
             _values(np.asarray(alrj) + 1j * np.asarray(alij), bej, scj),
             int(infoj["niter"]))


def _signed_product(A, S):
    M = np.eye(A.shape[1], dtype=A.dtype)
    for a, s in zip(A, S):
        M = M @ (a if s else np.linalg.inv(a))
    return M


@pytest.mark.parametrize("cplx", [False, True], ids=["rg", "cx"])
@pytest.mark.parametrize("tail", [False, True], ids=["aed", "tail"])
def test_aed_driver_without_t_is_the_driver_with_t(cplx, tail):
    S = (True, False, True)
    rng = np.random.default_rng(56)
    A = rng.standard_normal((3, 28, 28))
    if cplx:
        A = A + 1j * rng.standard_normal(A.shape)
    H, Q = phessenberg_signed_core(torch.tensor(A), S)
    fn = pqz_complex.pqz_complex_core_aed if cplx else pqz_real.pqz_real_gen_core_aed
    kw = ({"cfg": AlgoConfig(aed=False, host_tail=10), "chunk_iters": 8} if tail
          else {"cfg": AlgoConfig(aed_window=8, aed_interval=6)})
    runs = [fn(H, S, Z=Q, want_t=wt, with_info=True, **kw) for wt in (True, False)]
    (o1, o2) = runs
    i1, i2 = ({k: v for k, v in o[-1].items() if k != "aed_s"} for o in runs)
    assert o1[-2] and o2[-2] and i1 == i2
    assert i1["host_tail_finished" if tail else "aed_hits"] >= 1
    for a, b in zip(o1[2:-2], o2[2:-2]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert torch.equal(o1[1], o2[1])
    f = [np.asarray(x) for x in o2[2:-2]]
    w = (f[0] / f[1] * np.exp2(f[2].astype(float)) if cplx
         else (f[0] + 1j * f[1]) / f[2] * np.exp2(f[3].astype(float)))
    wn = np.linalg.eigvals(_signed_product(A, S))
    d = np.abs(w[:, None] - wn[None, :])
    assert max(d.min(axis=1).max(), d.min(axis=0).max()) <= 1000 * EPS * np.abs(wn).max()
