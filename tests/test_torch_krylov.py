"""The port's ``partial_pschur`` (``models/krylov.py``) against the JAX
package's, on CPU tensors.

The cases of ``tests/test_krylov.py``: the same draws (numpy, fixed seeds)
and the same ``seed``, so both packages start from the same vector.  The
JAX ``partial_pschur`` on a numpy stack is numpy and the native C++ window
Schur: no JAX core is compiled here.

Gates:
* sorted Ritz values within 1e-8 relative to the largest, and
  ``nconverged`` equal (both packages' ``nprods`` in the message);
* the reference's ``check`` contract on the port's output (per-column
  residuals, interior couplings, orthonormality at 100 k eps);
* the device step ``CycleOps.apply_orth`` against the host ``_orth_step``
  (1e-13), and the projected solve's fallback (the port's cores on a CPU
  tensor) against the native window Schur's values (1e-10).
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_tpu.models import krylov as jk
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch import native
from periodicschurdecompositions_jl_torch.models import krylov as tk
from periodicschurdecompositions_jl_torch.parallel.krylov_ops import CycleOps
from periodicschurdecompositions_jl_torch.types import ConvergenceFailure

from torch_krylov_host import check_partial, mkmats


def _check(A, ps):
    check_partial(lambda l, X: A[l] @ X, ps.Vs.numpy(), ps.Ts.numpy(), ps.values.numpy())


def _compare(ps, h, pj, hj):
    msg = f"nprods port {h.nprods} / JAX {hj.nprods}; nconverged {h.nconverged} / {hj.nconverged}"
    assert h.nconverged == hj.nconverged, msg
    assert h.converged == hj.converged, msg
    a = np.sort_complex(ps.values.numpy())
    b = np.sort_complex(np.asarray(pj.values))
    assert a.shape == b.shape, msg
    if b.size:
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), (msg, a, b)
    return msg


def _both(A, *args, **kw):
    ps, h = pt.partial_pschur(torch.tensor(A), *args, **kw)
    pj, hj = jk.partial_pschur(A, *args, **kw)
    return ps, h, pj, hj


@pytest.mark.parametrize("which,cplx", [("LM", False), ("LR", False), ("SR", False),
                                        ("LM", True)])
def test_partial_pschur_matches_jax(which, cplx):
    p, n, nev, seed = (2, 24, 3, 3) if cplx else (3, 30, 4, 7)
    A = mkmats(np.random.default_rng(1234), p, n, cplx=cplx)
    ps, h, pj, hj = _both(A, nev, which, seed=seed)
    msg = _compare(ps, h, pj, hj)
    assert h.nconverged >= (1 if cplx else nev // 2), msg
    _check(A, ps)
    assert all(t.device.type == "cpu" for t in (ps.Ts, ps.Vs, ps.values, ps.residuals))
    assert ps.orientation == "L" and ps.schurindex == p - 1
    assert set(h.timings) == set(hj.timings)
    # two host reads per operator application: the coefficients, the column
    assert h.host_reads >= h.nprods


@pytest.mark.parametrize("which", ["LI", "SI"])
def test_real_li_si_matches_jax(which):
    A = np.random.default_rng(77).standard_normal((2, 24, 24))
    ps, h, pj, hj = _both(A, 3, which, seed=3)
    _compare(ps, h, pj, hj)
    assert h.nconverged >= 2
    _check(A, ps)


def test_matrix_free_matches_jax():
    p, n, nev = 2, 40, 3
    A = mkmats(np.random.default_rng(1234), p, n)
    At = torch.tensor(A)
    ops = [lambda x, a=At[l]: a @ x for l in range(p)]
    ps, h = pt.partial_pschur(ops, nev, "LM", n=n, dtype=torch.float64, device="cpu",
                              seed=5)
    pj, hj = jk.partial_pschur([lambda x, a=A[l]: a @ x for l in range(p)], nev, "LM",
                               n=n, dtype=np.float64, seed=5)
    _compare(ps, h, pj, hj)
    assert h.nconverged >= 1
    _check(A, ps)
    # a CycleOps passed in is used as it is: the dense run, bit for bit
    pd, hd = pt.partial_pschur(CycleOps(At), nev, "LM", seed=5)
    pe, he = pt.partial_pschur(At, nev, "LM", seed=5)
    assert hd.nprods == he.nprods and torch.equal(pd.values, pe.values)
    with pytest.raises(ValueError, match="n= and dtype="):
        pt.partial_pschur(ops, nev, "LM", device="cpu")


def test_custom_vrand_matches_jax():
    A = mkmats(np.random.default_rng(1234), 2, 30)

    def filler(calls):
        def f(shape):
            calls.append(shape)
            return np.random.default_rng(99 + len(calls)).standard_normal(shape)
        return f

    calls_t, calls_j = [], []
    ps, h = pt.partial_pschur(torch.tensor(A), 3, "LM", vrand=filler(calls_t))
    pj, hj = jk.partial_pschur(A, 3, "LM", vrand=filler(calls_j))
    assert calls_t and calls_t == calls_j
    _compare(ps, h, pj, hj)
    _check(A, ps)


def test_zero_factor_terminates_as_jax():
    n = 8
    A = np.stack([np.zeros((n, n)), np.eye(n)])
    ps, h, pj, hj = _both(A, 2, "LM", restarts=3)
    _compare(ps, h, pj, hj)
    assert h.nconverged == 0 and not h.converged
    assert ps.Vs.shape == (2, n, 0)


def test_rank_deficient_in_cycle_deflation_matches_jax():
    rng = np.random.default_rng(11)
    n, r = 30, 8
    A = np.stack([rng.standard_normal((n, r)) @ rng.standard_normal((r, n)),
                  rng.standard_normal((n, n))])
    ps, h, pj, hj = _both(A, 4, "LM", seed=2)
    _compare(ps, h, pj, hj)
    assert h.nconverged >= 1
    _check(A, ps)


@pytest.mark.parametrize("p,n,cplx", [(4, 12, False), (3, 8, True)])
def test_full_space_maxdim_matches_jax(p, n, cplx):
    rng = np.random.default_rng(5)
    A = rng.standard_normal((p, n, n))
    if cplx:
        A = A + 1j * rng.standard_normal((p, n, n))
    ps, h, pj, hj = _both(A, 3, "LM", mindim=min(10, n), maxdim=n)
    _compare(ps, h, pj, hj)
    assert h.nconverged >= 3
    _check(A, ps)


@pytest.mark.parametrize("trial", range(8))
def test_restarts_with_locking_matches_jax(trial):
    """Generic real cycles that take several restarts and locks (JAX
    ``test_restarts_with_locking_random_sweep``)."""
    A = np.random.default_rng(5000 + trial).standard_normal((3, 26, 26))
    ps, h, pj, hj = _both(A, nev=4, which="LM", mindim=6, maxdim=12, seed=trial)
    _compare(ps, h, pj, hj)
    w = np.linalg.eigvals(A[2] @ A[1] @ A[0])
    for g in ps.values.numpy():
        assert min(abs(g - w)) <= 1e-5 * max(1.0, abs(g)), g


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_direct_residuals_match_trial_probe(dtype):
    """The cyclic-Sylvester residuals against the trial-reorder probe:
    equal for 1x1 candidates, within sqrt(2) for pairs (JAX
    ``test_direct_residuals_match_trial_probe``)."""
    rng = np.random.default_rng(1234)
    p, kk = 3, 9
    cplx = np.issubdtype(dtype, np.complexfloating)
    B = [np.triu(rng.standard_normal((kk + 1, kk + 1))).astype(dtype) for _ in range(p - 1)]
    Bp = np.triu(rng.standard_normal((kk + 1, kk + 1)), -1).astype(dtype)
    if cplx:
        B = [b + 1j * np.triu(rng.standard_normal(b.shape)) for b in B]
        Bp = Bp + 1j * np.triu(rng.standard_normal(Bp.shape), -1)
    PS = tk._small_pschur(B + [Bp], 0, kk, np.dtype(dtype))
    foot = rng.standard_normal(kk).astype(dtype)
    lams = PS.values.numpy()
    rs = tk._residuals(PS, foot, list(range(kk)), lams, not cplx)
    j = 0
    while j < kk:
        pair = not cplx and lams[j].imag != 0
        jc = (j + 1 if j + 1 < kk and abs(np.conj(lams[j + 1]) - lams[j]) <= 1e-8 * abs(lams[j])
              else j - 1) if pair else None
        rt = tk._residual_trial(PS, foot, j, jc, kk)
        if pair:
            assert rt / np.sqrt(2) - 1e-10 <= rs[j] <= rt * np.sqrt(2) + 1e-10, (j, rs[j], rt)
        else:
            assert abs(rs[j] - rt) <= 1e-8 * max(1.0, rt), (j, rs[j], rt)
        j += 2 if pair else 1


def test_maxdim_validation():
    A = np.random.default_rng(0).standard_normal((3, 8, 8))
    with pytest.raises(ValueError):
        pt.partial_pschur(torch.tensor(A), 2, "LM", mindim=10, maxdim=16)
    with pytest.raises(ValueError):
        pt.partial_pschur(torch.tensor(A), 0, "LM")


@pytest.mark.parametrize("cplx", [False, True])
def test_device_step_matches_host_step(cplx):
    rng = np.random.default_rng(21)
    n, w = 40, 9

    def draw(*shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if cplx else x

    A = draw(2, n, n)
    V = [np.linalg.qr(draw(n, w + 1))[0], np.linalg.qr(draw(n, w))[0]]
    # column 4 of slot 0 maps to within 1e-3 of span(V[1]): the re-pass
    x = np.linalg.solve(A[0], V[1] @ draw(w) + 1e-3 * draw(n))
    V[0][:, 4] = x / np.linalg.norm(x)
    ops = CycleOps(torch.tensor(A))
    ops.load_basis(V)
    for l, j, lnext, ncols in ((0, 3, 1, 6), (0, 4, 1, w), (1, 2, 0, w + 1)):
        v = A[l] @ V[l][:, j]
        U = V[lnext][:, :ncols]
        repass = np.linalg.norm(v - U @ (U.conj().T @ v)) < tk.ETA_ORTH * np.linalg.norm(v)
        assert repass == (j == 4)
        h, w_, inspan = ops.apply_orth(l, lnext, j, ncols, tk.ETA_ORTH)
        hh, vv, ww, ii = tk._orth_step(U, v)
        assert inspan == bool(ii) is False
        assert abs(w_ - ww) <= 1e-13 * max(ww, 1.0)
        assert np.abs(h - hh).max() <= 1e-13 * np.abs(hh).max()
        col = ops.accept(lnext, j, w_)
        assert np.abs(col - vv / ww).max() <= 1e-10
        assert np.array_equal(col, ops.get_col(lnext, j))
        V[lnext][:, j] = col  # the host basis follows the mirror, as partial_pschur keeps it
    ops.set_col(1, 0, V[0][:, 0])
    assert np.array_equal(ops.get_col(1, 0), V[0][:, 0])


@pytest.mark.parametrize("cplx", [False, True])
def test_small_pschur_fallback_matches_native(cplx, monkeypatch):
    rng = np.random.default_rng(8)
    p, k = 3, 10
    dt = np.complex128 if cplx else np.float64
    B = [np.triu(rng.standard_normal((k, k))).astype(dt) for _ in range(p - 1)]
    B.append(np.triu(rng.standard_normal((k + 1, k)), -1).astype(dt))
    if cplx:
        B = [b + 1j * np.triu(rng.standard_normal(b.shape), -1 if i == p - 1 else 0)
             for i, b in enumerate(B)]
    ref = np.sort_complex(tk._small_pschur(B, 0, k, np.dtype(dt)).values.numpy())

    def declines(*a, **kw):
        if cplx:
            return None
        raise ConvergenceFailure(0)

    monkeypatch.setattr(native, "pqz_complex_cpu" if cplx else "pschur_real_cpu", declines)
    PS = tk._small_pschur(B, 0, k, np.dtype(dt))
    got = np.sort_complex(PS.values.numpy())
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    assert PS.Ts.device.type == "cpu" and PS.orientation == "R"
