"""The port's multi-bulge sweep and driver (``AlgoConfig.nbulges > 1``)
against the JAX package.

Sweep (``ops/sweep.py``):
* ``chase_sweep_mb_plain`` against the float64 numpy oracle
  ``ref_sweep_np_mb`` (a JAX-free copy in tests/torch_mb_host.py) on the
  cases of tests/test_pallas_sweep.py (p=1, where the bulge's band update
  lands on factor 0 itself; an interior window; nbact < NB): the same
  arithmetic up to summation order over a short chain, 1e-13 max|H| and
  1e-13 for Z, exact structural zeros;
* ``apply_log_plain`` (the plain twin of the apply kernels B0/B) replaying
  the plain sweep's log bulge-major: exact in exact arithmetic, 1e-13;
* one case against the JAX Pallas kernels (``chase_sweep_ff_mb``, interpret
  mode, float-float): 1e-11 max|H|, the bound of the JAX test;
* with one bulge, ``chase_sweep_mb_plain`` is ``chase_sweep_plain`` bit for
  bit.

Driver (``ops/pqr_real.py``):
* ``pqr_real_core`` with nbulges=2 against the JAX ds core
  ``pqr_real_core_ff`` (interpret mode) at p=1 n=12: both converge and
  their eigenvalues agree within 1e-10 max|lambda|;
* the port alone at three shapes of tests/test_pqr_ff.py against numpy's
  eigenvalues of the explicit product (1e-10 max|lambda|) and
  ``check_psd``;
* at p=2 n=32 (the JAX config's own case) four bulges take fewer iterations
  than one;
* nbulges=1 is today's path: ``pschur_real_pipeline`` gives the same T, Z
  and niter bit for bit;
* configurations the kernels do not take raise ValueError.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_tpu.config import AlgoConfig as JAlgoConfig
from periodicschurdecompositions_jl_tpu.ops import ff
from periodicschurdecompositions_jl_tpu.ops.hessenberg import phessenberg_core as jhess
from periodicschurdecompositions_jl_tpu.ops.pallas_sweep import chase_sweep_ff_mb
from periodicschurdecompositions_jl_tpu.ops.pqr_ff import pqr_real_core_ff
from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.ops import pqr_real, sweep
from periodicschurdecompositions_jl_torch.utils.interop import state_from_jax_ff
from torch_mb_host import enforce, mb_sig, mk_problem, ref_sweep_np_mb

GAP = 3
# (p, n, m, i, nb, nbact): tests/test_pallas_sweep.py's five cases and its
# partial-activity case
CASES = [(1, 12, 0, 11, 2, 2), (2, 12, 0, 11, 2, 2), (4, 12, 0, 11, 2, 2),
         (2, 16, 0, 15, 3, 3), (3, 12, 2, 8, 2, 2), (2, 12, 0, 11, 3, 2)]


def _structure_exact(H):
    assert np.all(np.tril(H[0], -2) == 0)
    for f in range(1, H.shape[0]):
        assert np.all(np.tril(H[f], -1) == 0)


def _case(p, n, nb, seed):
    rng = np.random.default_rng(seed)
    Hp, Zp, v0 = mk_problem(p, n, rng)
    return Hp, Zp, v0, mb_sig(rng, nb)


@pytest.mark.parametrize("p,n,m,i,nb,nbact", CASES)
def test_plain_mb_sweep_matches_oracle(p, n, m, i, nb, nbact):
    Hp, Zp, v0, sig = _case(p, n, nb, p * 100 + n + nb)
    Href, Zref = ref_sweep_np_mb(Hp, Zp, m, i, v0, sig[:nbact], nbact, GAP)
    H, Z = torch.tensor(Hp), torch.tensor(Zp)
    sweep.chase_sweep_mb(H, Z, m, i, v0, sig, nbact, nb=nb, gap=GAP, want_z=True)
    H, Z = H.numpy(), Z.numpy()
    assert np.abs(H - enforce(Href)).max() <= 1e-13 * np.abs(Hp).max()
    assert np.abs(Z - Zref).max() <= 1e-13
    _structure_exact(H)


@pytest.mark.parametrize("p,n,m,i,nb,nbact", CASES)
def test_deferred_apply_replays_the_mb_sweep(p, n, m, i, nb, nbact):
    Hp, Zp, v0, sig = _case(p, n, nb, p * 100 + n + nb + 1)
    if m > 0:
        Hp[0, m, m - 1] = 0.3   # the window-boundary column must be kept
    H, Z = torch.tensor(Hp), torch.tensor(Zp)
    R = torch.zeros((nb, p, n + 1, 9), dtype=torch.float64)
    sweep.chase_sweep_mb_plain(H, Z, m, i, v0, sig, nbact, nb=nb, gap=GAP, want_z=True,
                               log=R)
    Ha, Za = torch.tensor(Hp), torch.tensor(Zp)
    sweep.apply_log_plain(Ha, Za, R, m, i, want_z=True, nb=nbact)
    assert float((Ha - H).abs().max()) <= 1e-13 * np.abs(Hp).max()
    assert float((Za - Z).abs().max()) <= 1e-13
    _structure_exact(Ha.numpy())


def test_plain_mb_sweep_matches_jax_pallas_kernels():
    p, n, m, i, nb = 1, 12, 0, 11, 2
    Hp, Zp, v0, sig = _case(p, n, nb, p * 100 + n + nb)
    # the ds kernel takes each shift as an f32 (hi, lo) pair: hand both
    # sides the same values
    flat = []
    for s3 in sig:
        for x in s3:
            hi = np.float32(x)
            flat += [hi, np.float32(np.float64(x) - np.float64(hi))]
    flat = np.array(flat, np.float32)
    sig_ds = [[float(flat[6 * b + 2 * q]) + float(flat[6 * b + 2 * q + 1]) for q in range(3)]
              for b in range(nb)]
    Hout, ZTout = chase_sweep_ff_mb(
        ff.from_f64(jnp.asarray(Hp)), ff.from_f64(jnp.asarray(np.swapaxes(Zp, 1, 2))),
        jnp.int32(m), jnp.int32(i), ff.from_f64(jnp.asarray(v0)), jnp.asarray(flat),
        jnp.ones(p, jnp.float32), jnp.int32(nb), NB=nb, GAP=GAP, want_z=True,
        interpret=True)
    Hj, Zj = state_from_jax_ff(Hout.hi, Hout.lo, ZTout.hi, ZTout.lo)
    H, Z = torch.tensor(Hp), torch.tensor(Zp)
    sweep.chase_sweep_mb(H, Z, m, i, v0, sig_ds, nb, nb=nb, gap=GAP, want_z=True)
    assert float((H - Hj).abs().max()) <= 1e-11 * np.abs(Hp).max()
    assert float((Z - Zj).abs().max()) <= 1e-11


@pytest.mark.parametrize("p,n,m,i", [(1, 8, 0, 7), (3, 12, 2, 8)])
def test_one_bulge_is_the_single_sweep(p, n, m, i):
    Hp, Zp, v0, _ = _case(p, n, 1, p * 100 + n)
    H1, Z1 = torch.tensor(Hp), torch.tensor(Zp)
    R1 = torch.zeros((p, n + 1, 9), dtype=torch.float64)
    sweep.chase_sweep_plain(H1, Z1, m, i, v0, want_z=True, log=R1)
    H2, Z2 = torch.tensor(Hp), torch.tensor(Zp)
    R2 = torch.zeros((1, p, n + 1, 9), dtype=torch.float64)
    sweep.chase_sweep_mb_plain(H2, Z2, m, i, v0, [(0.0, 0.0, 0.0)], 1, nb=1, gap=GAP,
                               want_z=True, log=R2)
    assert torch.equal(H1, H2) and torch.equal(Z1, Z2) and torch.equal(R1, R2[0])


def test_core_matches_jax_ds_core():
    p, n, nb = 1, 12, 2
    A = np.random.default_rng(17 * p + n + nb).standard_normal((p, n, n))
    Hj, Qj = jhess(jnp.asarray(A), want_q=True)
    Hff = ff.from_f64(jnp.asarray(np.asarray(Hj)))
    QTff = ff.from_f64(jnp.asarray(np.swapaxes(np.asarray(Qj), 1, 2)))
    out = pqr_real_core_ff(Hff.hi, Hff.lo, QTff.hi, QTff.lo, want_z=True,
                           interpret=True, cfg=JAlgoConfig(nbulges=nb))
    wj = (np.asarray(out[4], np.float64) + np.asarray(out[5], np.float64)
          + 1j * (np.asarray(out[6], np.float64) + np.asarray(out[7], np.float64)))
    T, Z, wr, wi, ok = pqr_real.pqr_real_core(torch.tensor(np.asarray(Hj)),
                                              torch.tensor(np.asarray(Qj)),
                                              cfg=AlgoConfig(nbulges=nb))
    assert bool(out[8]) and ok
    w, wj = np.sort_complex(wr + 1j * wi), np.sort_complex(wj)
    assert np.abs(w - wj).max() <= 1e-10 * np.abs(wj).max()


@pytest.mark.parametrize("p,n,nb", [(2, 12, 3), (4, 16, 2), (2, 6, 4)])
def test_mb_pipeline_matches_numpy(p, n, nb):
    A = np.random.default_rng(17 * p + n + nb).standard_normal((p, n, n))
    P = pqr_real.pschur_real_pipeline(torch.tensor(A), "R", cfg=AlgoConfig(nbulges=nb))
    info = pqr_real.last_info
    assert info["bulges"] > info["sweeps"] > 0
    M = np.eye(n)
    for a in A:
        M = M @ a
    ref = np.sort_complex(np.linalg.eigvals(M))
    w = np.sort_complex(P.values.numpy())
    assert np.abs(w - ref).max() <= 1e-10 * np.abs(ref).max()
    ok, rep = pt.check_psd(P, A)
    assert ok, rep


def test_four_bulges_take_fewer_iterations():
    A = torch.tensor(np.random.default_rng(70).standard_normal((2, 32, 32)))
    niter = {}
    for nb in (1, 4):
        pqr_real.pschur_real_pipeline(A, "R", cfg=AlgoConfig(nbulges=nb))
        niter[nb] = pqr_real.last_info["niter"]
    assert niter[4] < niter[1], niter


def test_one_bulge_config_is_the_default_path():
    A = torch.tensor(np.random.default_rng(5).standard_normal((3, 16, 16)))
    P0 = pqr_real.pschur_real_pipeline(A, "R")
    n0 = pqr_real.last_info["niter"]
    P1 = pqr_real.pschur_real_pipeline(A, "R", cfg=AlgoConfig(nbulges=1))
    assert pqr_real.last_info["niter"] == n0
    assert torch.equal(P0.Ts, P1.Ts) and torch.equal(P0.Zs, P1.Zs)


@pytest.mark.parametrize("nb,gap", [(5, 3), (2, 2)])
def test_unsupported_mb_configs_raise(nb, gap):
    A = torch.tensor(np.random.default_rng(1).standard_normal((2, 8, 8)))
    with pytest.raises(ValueError):
        pqr_real.pschur_real_pipeline(A, "R", cfg=AlgoConfig(nbulges=nb, bulge_gap=gap))
    H = torch.zeros((2, 9, 9), dtype=torch.float64)
    with pytest.raises(ValueError):
        sweep.chase_sweep_mb(H, None, 0, 7, [1.0, 0.0, 0.0], [(0.0, 0.0, 0.0)] * nb, 1,
                             nb=nb, gap=gap, want_z=False)
