"""The sharded sweep (``parallel/sweep_sharded.py``) on CPU shards.

* ``chase_sweep_sharded`` with D = 2, 4, 8 CPU shards against the port's
  unsharded ``chase_sweep`` on the same input: within 1e-12 (max|H|
  relative; Z absolute), exact structural zeros, Z untouched without
  ``want_z``; with the dlahqr early start and with the want_t=False
  bounds.  On the CPU the shards run ``apply_log_shard_plain``; it is
  held against ``apply_log_plain`` on whole stacks (1e-13).
* ``pschur_real_sharded`` on p=3, n=31 (N = 32 over 2 and 8 shards)
  against the JAX package's float64 ``pqr_real_core`` after its reduction
  (one JAX compile): reconstruction < 1e-12 max|A|, Z orthogonal to 1e-12
  (the thresholds of tests/test_parallel_sweep.py), eigenvalues within
  1e-12 relative.
"""
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.ops import sweep

CPU = torch.device("cpu")


def _problem(p, n, seed):
    rng = np.random.default_rng(seed)
    N = n + 1
    H = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
    Z = np.zeros((p, N, N))
    for f in range(p):
        Z[f, :n, :n] = np.linalg.qr(rng.standard_normal((n, n)))[0]
    v0 = rng.standard_normal(3)
    return H, Z, v0 / np.abs(v0).sum()


def _structure_exact(H, m, i):
    Hn = H.numpy()
    for r in range(m + 1, i + 1):
        assert np.all(Hn[0, r, max(m - 1, 0):r - 1] == 0)
        assert np.all(Hn[1:, r, m:r] == 0)


@pytest.mark.parametrize("m,i,early,bounds,want_z", [
    (0, 30, False, False, True), (3, 20, True, False, True), (5, 25, False, True, True),
    (1, 29, False, False, False)])
def test_sharded_sweep_matches_unsharded(m, i, early, bounds, want_z):
    p, n = 3, 31
    Hn, Zn, v0 = _problem(p, n, 100 + m)
    H0 = torch.tensor(Hn)
    H0[0, i + 1, i] = 0.0
    rhi, clo = (i + 1, m) if bounds else (None, None)
    Hu, Zu = H0.clone(), torch.tensor(Zn)
    sweep.chase_sweep(Hu, Zu, m, i, v0, want_z=want_z, early=early, rhi=rhi, clo=clo)
    scale = float(H0.abs().max())
    for D in (2, 4, 8):
        Hs, Zs = H0.clone(), torch.tensor(Zn)
        out = pt.chase_sweep_sharded(Hs, Zs, m, i, v0, devices=[CPU] * D, want_z=want_z,
                                     early=early, rhi=rhi, clo=clo)
        assert out[0] is Hs
        assert float((Hs - Hu).abs().max()) <= 1e-12 * scale, D
        if want_z:
            assert float((Zs - Zu).abs().max()) <= 1e-12, D
        else:
            assert torch.equal(Zs, torch.tensor(Zn))
        _structure_exact(Hs, m, i)
        if bounds:  # untouched above the window and right of it
            assert torch.equal(Hs[:, :m], H0[:, :m])
            assert torch.equal(Hs[:, :, i + 2:], H0[:, :, i + 2:])


@pytest.mark.parametrize("nb", [1, 3])
def test_shard_plain_matches_apply_log_plain(nb):
    p, n, m, i = 4, 23, 2, 21
    N = n + 1
    Hn, Zn, _ = _problem(p, n, 7)
    rng = np.random.default_rng(8)
    R = torch.tensor(np.linalg.qr(rng.standard_normal((nb, p, N, 3, 3)))[0].reshape(nb, p, N, 9))
    H0, Z0 = torch.tensor(Hn), torch.tensor(Zn)
    Ha, Za = H0.clone(), Z0.clone()
    sweep.apply_log_plain(Ha, Za, R, m, i, want_z=True, nb=nb)
    for D in (1, 3, 6):
        L = N // D
        Hs, Zs = H0.clone(), Z0.clone()
        for d in range(D):
            Hc = Hs[:, :, d * L:(d + 1) * L].contiguous()
            sweep.sweep_left_shard(Hc, R, m, i, d * L, nb=nb)
            Hs[:, :, d * L:(d + 1) * L] = Hc
        for d in range(D):
            Hr, Zr = Hs[:, d * L:(d + 1) * L].contiguous(), Zs[:, d * L:(d + 1) * L].contiguous()
            sweep.sweep_right_shard(Hr, Zr, R, m, i, d * L, want_z=True, nb=nb)
            Hs[:, d * L:(d + 1) * L], Zs[:, d * L:(d + 1) * L] = Hr, Zr
        assert float((Hs - Ha).abs().max()) <= 1e-13 * float(H0.abs().max())
        assert float((Zs - Za).abs().max()) <= 1e-13


def test_shard_count_must_divide_n_plus_one():
    H = torch.zeros((2, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="must divide the lane count"):
        pt.chase_sweep_sharded(H, None, 0, 5, [1.0, 0.0, 0.0], devices=[CPU] * 3,
                               want_z=False)
    with pytest.raises(ValueError, match="must divide the lane count"):
        pt.pschur_real_sharded(torch.zeros((2, 8, 8), dtype=torch.float64), [CPU] * 2)


@pytest.fixture(scope="module")
def jax_core():
    """The JAX package's float64 reduction and ``pqr_real_core`` on the
    p=3 n=31 draw."""
    import jax.numpy as jnp
    from periodicschurdecompositions_jl_tpu.ops.hessenberg import phessenberg_core
    from periodicschurdecompositions_jl_tpu.ops.pqr_real import pqr_real_core
    A = np.random.default_rng(1234).standard_normal((3, 31, 31))
    H, Q = phessenberg_core(jnp.asarray(A))
    T, Z, wr, wi, ok = pqr_real_core(H, Z=Q)
    assert bool(ok)
    return A, np.asarray(wr) + 1j * np.asarray(wi)


@pytest.mark.parametrize("D", [2, 8])
def test_pschur_real_sharded_matches_jax_core(jax_core, D):
    A, wj = jax_core
    p, n = A.shape[0], A.shape[1]
    T, Z, w, ok = pt.pschur_real_sharded(torch.tensor(A), [CPU] * D)
    assert ok and T.device == CPU and T.shape == (p, n, n)
    T, Z = T.numpy(), Z.numpy()
    recon = max(np.abs(Z[l] @ T[l] @ Z[(l + 1) % p].T - A[l]).max() for l in range(p))
    assert recon < 1e-12 * np.abs(A).max()
    assert max(np.abs(Z[l].T @ Z[l] - np.eye(n)).max() for l in range(p)) < 1e-12
    a, b = np.sort_complex(w), np.sort_complex(wj)
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
