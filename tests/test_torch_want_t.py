"""``want_t=False`` of the port's real iteration against the JAX package.

The reference's eigenvalues-only mode keeps every row update to the
columns up to the active window's bottom i and every column update of H to
the rows from its top lnew (JAX ``ops/pqr_real.py:198-202``, ``tlo`` and
``thi``); Z takes every transform.  On the CPU:

* ``pqr_real_core(want_t=False)`` against the JAX f64 core with
  ``want_t=False``, both started from the port's reduction of a p=3 n=12
  draw, with and without Z: niter equal, eigenvalues within 1e-12
  max|lambda|, and the whole T stack (its entries outside the windows,
  which neither package updates, included) and Z within 1e-10, as in the
  want_t=True comparisons; so the port skips the updates the reference
  skips.  One JAX compile (want_z=True, a module fixture): the
  reference's T, eigenvalues and niter do not depend on want_z (its Z
  updates never reach H), so its want_z=False run is not compiled again;
* the repair chain without T, on the first of those JAX programs;
* the plain versions of the bounded kernels (B0 + B real, complex and rg,
  and D) against the model of the bound (``chip_smoke.bounded_ok``):
  inside the window the values of the unbounded run, outside it the input,
  bit for bit; Z as unbounded;
* the bound is exact: the real core, its multi-bulge sweep and its AED
  driver (AED and the host tail at small windows) give the same niter,
  eigenvalues and Z with T and without it, bit for bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from periodicschurdecompositions_jl_tpu.ops.pqr_real import pqr_real_core as jcore
from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.ops import deflate, sweep, sweep_cx, sweep_rg
from periodicschurdecompositions_jl_torch.ops import pqr_real as tpq
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_core

P, N = 3, 12


def _jax(H, Q):
    T, Z, wr, wi, ok, info = jcore(jnp.asarray(H), Z=jnp.asarray(Q), want_z=True,
                                   want_t=False, with_info=True)
    assert bool(ok)
    return {"T": np.asarray(T), "Z": np.asarray(Z),
            "w": np.asarray(wr) + 1j * np.asarray(wi), "niter": int(info["niter"])}


@pytest.fixture(scope="module")
def draw():
    A = torch.tensor(np.random.default_rng(P * 10 + N).standard_normal((P, N, N)))
    H, Q = phessenberg_core(A)
    return H, Q


def _check(H, Q, want_z, ref):
    T, Z, wr, wi, ok, info = tpq.pqr_real_core(H, Q if want_z else None, want_z=want_z,
                                               want_t=False, with_info=True)
    assert ok and info["niter"] == ref["niter"]
    w = wr + 1j * wi
    assert np.abs(w - ref["w"]).max() <= 1e-12 * np.abs(ref["w"]).max()
    assert np.abs(T.numpy() - ref["T"]).max() <= 1e-10
    if want_z:
        assert np.abs(Z.numpy() - ref["Z"]).max() <= 1e-10
    else:
        assert Z is None
    return T, info


@pytest.fixture(scope="module")
def jax_ref(draw):
    H, Q = draw
    return _jax(H.numpy(), Q.numpy())


@pytest.mark.parametrize("want_z", [True, False])
def test_core_without_t_matches_jax(draw, jax_ref, want_z):
    H, Q = draw
    T, _ = _check(H, Q, want_z, jax_ref)
    # no final scrub: the windows' updates leave fill below the diagonal of
    # the triangular factors that the run with T removes
    Tt = tpq.pqr_real_core(H, Q, want_z=want_z)[0]
    assert not torch.equal(T, Tt)


def test_repair_chain_without_t_matches_jax(monkeypatch):
    # negligible triangular diagonals: the RQ repair chain runs (as
    # tests/test_torch_pschur.py::test_repair_chain_matches_jax), bounded
    rng = np.random.default_rng(2)
    H = np.zeros((P, N, N))
    H[0] = np.triu(rng.standard_normal((N, N)), -1)
    for f in range(1, P):
        H[f] = np.triu(rng.standard_normal((N, N)))
    H[1][6, 6] = 1e-30
    H[2][8, 8] = 0.0
    Z = np.broadcast_to(np.eye(N), (P, N, N)).copy()
    ref = _jax(H, Z)
    ran = []
    repair = tpq._repair
    monkeypatch.setattr(tpq, "_repair", lambda *a: ran.append(1) or repair(*a))
    _check(torch.tensor(H), torch.tensor(Z), True, ref)
    assert ran


def _problem(kind, p, n, seed):
    from chip_smoke import mk_cx_problem, mk_rg_problem, mk_sweep_problem
    rng = np.random.default_rng(seed)
    H, Z = {"real": mk_sweep_problem, "cx": mk_cx_problem, "rg": mk_rg_problem}[kind](
        p, n, rng)[:2]
    return torch.tensor(H), torch.tensor(Z)


@pytest.mark.parametrize("kind,p,n,m,i,rlo,extra", [
    ("real", 3, 20, 4, 17, 3, 0), ("real", 1, 15, 0, 14, 0, 0), ("real", 4, 19, 7, 9, 5, 4),
    ("cx", 3, 20, 4, 17, 3, 0), ("cx", 2, 15, 0, 14, 0, 2),
    ("rg", 3, 20, 5, 17, 4, 0), ("rg", 2, 15, 1, 14, 0, 1)])
def test_plain_apply_bounds(kind, p, n, m, i, rlo, extra):
    """B0 + B's plain versions with rhi = i + 1 (+ extra) and clo = rlo."""
    from chip_smoke import bounded_ok, random_logs
    H0, Z0 = _problem(kind, p, n, p + n + m)
    rng = np.random.default_rng(7)
    chi = i + 1 + extra
    if kind == "real":
        for nb in (1, 3):
            R = torch.tensor(random_logs("real", p, n, m, i, rng, nb))
            Hu, Zu, Hb, Zb = H0.clone(), Z0.clone(), H0.clone(), Z0.clone()
            sweep.apply_log_plain(Hu, Zu, R, m, i, want_z=True, nb=nb)
            sweep.apply_log_plain(Hb, Zb, R, m, i, want_z=True, nb=nb, rhi=chi, clo=rlo)
            assert bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb)
        return
    lg = torch.tensor(random_logs(kind, p, n, m, i, rng))
    plain = sweep_cx.qz_apply_log_plain if kind == "cx" else sweep_rg.rg_apply_log_plain
    Hu, Zu, Hb, Zb = H0.clone(), Z0.clone(), H0.clone(), Z0.clone()
    plain(Hu, Zu, lg, m, i, want_z=True)
    plain(Hb, Zb, lg, m, i, want_z=True, rhi=chi, clo=rlo)
    assert bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb)
    Hz = H0.clone()
    plain(Hz, None, lg, m, i, want_z=False, rhi=chi, clo=rlo)
    assert torch.equal(Hz, Hb)


@pytest.mark.parametrize("label", ["chainA", "chainB", "chainB-jmax"])
def test_plain_deflate_bounds(label):
    from chip_smoke import bounded_ok, deflate_cases, deflate_scalars
    (_, Hn, Zn, i), = [c for c in deflate_cases(4, 20) if c[0] == label]
    sc = deflate_scalars(Hn, i)
    args = (i, sc["jmin"], sc["jmax"], sc["cs0"], sc["sn0"], sc["replace0"], sc["finzero"],
            sc["thr"])
    H0, Z0 = torch.tensor(Hn), torch.tensor(Zn)
    for rlo, chi in ((i - 1, i + 1), (5, i + 2)):
        Hu, Zu, Hb, Zb = H0.clone(), Z0.clone(), H0.clone(), Z0.clone()
        deflate.deflate2x2(Hu, Zu, *args, want_z=True)
        deflate.deflate2x2(Hb, Zb, *args, want_z=True, rhi=chi, clo=rlo)
        assert bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb)


def test_bounds_are_checked():
    H0, Z0 = _problem("real", 2, 10, 0)
    with pytest.raises(ValueError):
        sweep.chase_sweep(H0, Z0, 3, 8, [1.0, 0.0, 0.0], want_z=True, rhi=8)
    with pytest.raises(ValueError):
        sweep.chase_sweep(H0, Z0, 3, 8, [1.0, 0.0, 0.0], want_z=True, clo=4)


def _same_runs(run):
    (T1, Z1, wr1, wi1, ok1, i1), (T2, Z2, wr2, wi2, ok2, i2) = run(True), run(False)
    assert ok1 and ok2
    assert {k: v for k, v in i1.items() if k != "aed_s"} == \
        {k: v for k, v in i2.items() if k != "aed_s"}
    assert np.array_equal(wr1, wr2) and np.array_equal(wi1, wi2)
    assert Z1 is None and Z2 is None or torch.equal(Z1, Z2)
    return i1, wr2 + 1j * wi2


@pytest.mark.parametrize("seed", [0, 1])
def test_core_without_t_is_the_core_with_t(seed):
    A = torch.tensor(np.random.default_rng(seed).standard_normal((3, 16, 16)))
    H, Q = phessenberg_core(A)
    _same_runs(lambda wt: tpq.pqr_real_core(H, Q, want_t=wt, with_info=True))
    cfg = AlgoConfig(nbulges=2)
    _same_runs(lambda wt: tpq.pqr_real_core(H, Q, want_t=wt, cfg=cfg, with_info=True))


@pytest.mark.parametrize("cfg", [AlgoConfig(aed_window=12, aed_interval=8),
                                 AlgoConfig(aed_window=12, aed_interval=8, host_tail=30)],
                         ids=["aed", "aed+tail"])
def test_aed_driver_without_t_is_the_driver_with_t(cfg):
    A = torch.tensor(np.random.default_rng(70).standard_normal((3, 40, 40)))
    H, Q = phessenberg_core(A)
    info, w_no_t = _same_runs(lambda wt: tpq.pqr_real_core_aed(H, Q, want_t=wt, cfg=cfg,
                                                               with_info=True))
    assert info["aed_hits"] >= 1
    if cfg.host_tail:
        assert info["host_tail_finished"] >= 2
    w = np.linalg.eigvals(np.linalg.multi_dot(list(A.numpy())))
    d = np.abs(np.sort_complex(w_no_t) - np.sort_complex(w)).max()
    assert d <= 1000 * np.finfo(float).eps * np.abs(w).max()
